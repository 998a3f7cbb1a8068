"""Requests a batch as a share of ``max_batch``, averaged over the batches
``BatchingServer.batches`` recorded in the measured window."""


def read(rec):
    b = rec.get("batches")
    return 100.0 * sum(x["n"] for x in b) / (len(b) * rec["max_batch"]) if b else None
