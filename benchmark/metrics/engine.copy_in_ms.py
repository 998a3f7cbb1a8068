"""The engine's host time copying a served batch into its graph's static
inputs (on the card the batch's host-to-device copy; the ``copy_in`` span
of the engine's split in ``BatchingServer.batches``), averaged over the
measured window's batches. None where the records carry no such span."""


def read(rec):
    b = [x["copy_in"] for x in rec.get("batches") or () if "copy_in" in x]
    return sum(e - s for s, e in b) / len(b) / 1e6 if b else None
