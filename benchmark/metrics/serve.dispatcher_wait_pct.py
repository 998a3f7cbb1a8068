"""The share of the dispatcher's time spent waiting for work: the sum of
each batch's ``wait`` (in ``queue.get`` with no request, from the previous
batch's last answer to its first take) over that sum plus each batch's
first take to its last answer set (``fill`` start to ``reply`` end), over
the measured window's batches in ``BatchingServer.batches``. Beside
``device_idle_pct.served``: the card's idle time less this share is idle
time under the dispatcher's host work, not under missing load. None where
the records carry no such spans."""


def read(rec):
    b = [x for x in rec.get("batches") or () if "wait" in x and "reply" in x]
    if not b:
        return None
    wait = sum(x["wait"][1] - x["wait"][0] for x in b)
    busy = sum(x["reply"][1] - x["fill"][0] for x in b)
    return 100.0 * wait / (wait + busy) if wait + busy > 0 else None
