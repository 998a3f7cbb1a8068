"""The share of the measured window's batches that the dispatcher staged
in its kept host buffer (the ``staged`` count of ``BatchingServer.batches``),
in percent. None where no record carries the count."""


def read(rec):
    b = rec.get("batches") or ()
    if not any("staged" in x for x in b):
        return None
    return 100.0 * sum(x.get("staged") is True for x in b) / len(b)
