"""The reader of the server's ``staged`` count (``serve.staged_pct``) on
hand-built batch records, and on records without the count (a program that
keeps none), where it reads nothing and raises nothing."""

import pytest

from benchmark import spec


def _read(batches):
    return spec.metric(spec.ROOT, "serve.staged_pct").read({"batches": batches, "max_batch": 16})


@pytest.mark.parametrize("staged,want", [
    ([True, True, True], 100.0),
    ([True, False, True, True], 75.0),
    ([False], 0.0),
])
def test_the_share_of_staged_batches(staged, want):
    assert _read([{"n": 4, "staged": s} for s in staged]) == pytest.approx(want)


def test_records_without_the_count_read_nothing():
    assert _read([{"n": 4, "dispatch_ms": 11.0, "drain_ms": 2.0}]) is None
    assert _read([]) is None
    assert spec.metric(spec.ROOT, "serve.staged_pct").read({"max_batch": 16}) is None


def test_the_staged_share_is_declared_for_the_served_cell():
    (m,) = [m for m in spec.bench()["per_layer"] if m["name"] == "serve.staged_pct"]
    assert m["workloads"] == ["vitl14_518_int8.served_b16"] and m["unit"] == "%"
    assert m["moves"] == "latency_p95_ms" and m["source"] == "program_counter"
    assert m["layer"] == "serve.BatchingServer"
