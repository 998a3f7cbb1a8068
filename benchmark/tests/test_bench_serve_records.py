"""The readers of the server's records (``serve.queue_wait_ms``,
``serve.stack_ms``, ``engine.copy_in_ms``, ``serve.reply_ms``,
``serve.dispatcher_wait_pct``) on a hand-built ``batches`` list, and on
records without the spans (a program that keeps none), where each reads
nothing and raises nothing."""

import pytest

from benchmark import spec

MS = 1_000_000  # ns


def _batch(t, n, *, stack, copy_in, wait):
    """A record whose dispatcher waited ``wait`` ms from ``t`` (ms), then
    took ``n`` requests submitted 1, 2, ... ms before its first take, and
    answered each 0.5 ms before its caller returned."""
    first = t + wait
    fill = (first, first + 5)
    st = (fill[1], fill[1] + stack)
    eng = (st[1], st[1] + 40)
    split = {"lock_wait": (eng[0], eng[0]), "copy_in": (eng[0], eng[0] + copy_in),
             "launch": (eng[0] + copy_in, eng[0] + copy_in + 1),
             "copy_out": (eng[0] + copy_in + 1, eng[0] + copy_in + 2)}
    drain = (eng[1], eng[1] + 3)
    reply = (drain[1], drain[1] + 1)
    reqs = [{"id": i, "submitted": first - (i + 1), "taken": first + (i and 1),
             "answered": reply[0] + 0.5, "returned": reply[0] + 1.0} for i in range(n)]
    rec = {"n": n, "dispatch_ms": 40.0, "drain_ms": 3.0, "wait": (t, first), "fill": fill,
           "stack": st, "engine": eng, **split, "captured": False, "drain": drain,
           "reply": reply, "requests": reqs}
    # every time in ns, as the program records them
    for k, v in rec.items():
        if isinstance(v, tuple):
            rec[k] = (int(v[0] * MS), int(v[1] * MS))
    for r in reqs:
        for k in ("submitted", "taken", "answered", "returned"):
            r[k] = int(r[k] * MS)
    return rec, reply[1]


def _records():
    b1, end = _batch(0.0, 2, stack=8, copy_in=10, wait=20)
    b2, _ = _batch(end, 3, stack=12, copy_in=6, wait=10)
    return {"batches": [b1, b2], "max_batch": 16}


READERS = ["serve.queue_wait_ms", "serve.stack_ms", "engine.copy_in_ms", "serve.reply_ms",
           "serve.dispatcher_wait_pct"]


@pytest.mark.parametrize("name,want", [
    # requests 1, 2 ms before the take, the second taken 1 ms after the first
    ("serve.queue_wait_ms", (1 + 3 + 1 + 3 + 4) / 5),
    ("serve.stack_ms", (8 + 12) / 2),
    ("engine.copy_in_ms", (10 + 6) / 2),
    ("serve.reply_ms", 0.5),
    # waits 20 and 10; a batch's take to its last answer 5 + stack + 40 + 3 + 1
    ("serve.dispatcher_wait_pct", 100 * 30 / (30 + (49 + 8) + (49 + 12))),
])
def test_a_reader_of_the_records(name, want):
    assert spec.metric(spec.ROOT, name).read(_records()) == pytest.approx(want)


@pytest.mark.parametrize("name", READERS)
def test_records_without_the_spans_read_nothing(name):
    reader = spec.metric(spec.ROOT, name)
    old = [{"n": 4, "dispatch_ms": 11.0, "drain_ms": 2.0, "device_ms": 30.0}]
    assert reader.read({"batches": old, "max_batch": 16}) is None
    assert reader.read({"batches": [], "max_batch": 16}) is None
    assert reader.read({"max_batch": 16}) is None


@pytest.mark.parametrize("name", READERS)
def test_each_reader_is_declared_for_the_served_cell(name):
    (m,) = [m for m in spec.bench()["per_layer"] if m["name"] == name]
    assert m["workloads"] == ["vitl14_518_int8.served_b16"]
    assert m["moves"] == "latency_p95_ms" and m["source"] == "program_span"
