"""The dispatcher's host time from a batch closed to the engine call: the
stack, the pad, the EXIF arrays and ``from_numpy`` (the ``stack`` span of
``BatchingServer.batches``), averaged over the measured window's batches.
None where the records carry no such span."""


def read(rec):
    b = [x["stack"] for x in rec.get("batches") or () if "stack" in x]
    return sum(e - s for s, e in b) / len(b) / 1e6 if b else None
