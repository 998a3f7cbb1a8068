"""A request's wait in the server's queue, from ``submit`` entered to the
dispatcher's take of it (``taken - submitted`` of each request entry of
``BatchingServer.batches``), averaged over the requests of the measured
window's batches. None where the records carry no request entries."""


def read(rec):
    reqs = [r for b in rec.get("batches") or () for r in b.get("requests", ())]
    return sum(r["taken"] - r["submitted"] for r in reqs) / len(reqs) / 1e6 if reqs else None
