"""A caller's wake: from its answer set (result and event, ``answered``)
to ``submit``'s return in its own thread (``returned``), averaged over the
answered requests of the measured window's batches in
``BatchingServer.batches``. None where the records carry no such times."""


def read(rec):
    reqs = [r for b in rec.get("batches") or () for r in b.get("requests", ())
            if r.get("answered") is not None and r.get("returned") is not None]
    return sum(r["returned"] - r["answered"] for r in reqs) / len(reqs) / 1e6 if reqs else None
