"""The dispatcher's host milliseconds a batch (stack, pad, copy in, replay,
enqueue: ``BatchingServer.batches``' ``dispatch_ms``), averaged over the
measured window."""


def read(rec):
    b = rec.get("batches")
    return sum(x["dispatch_ms"] for x in b) / len(b) if b else None
