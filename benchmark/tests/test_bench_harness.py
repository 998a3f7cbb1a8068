"""The harness at tiny widths on the CPU, through the program's plain paths
(``device="cpu"``): every cell's result line, the per-layer readers, the
import guard, a fault planted under the timed path, the control, a cell
added by data alone, and a run without a card."""

import ast
import hashlib
import io
import json
import os
import shutil
import subprocess
import sys
import types
from contextlib import redirect_stdout
from pathlib import Path

import pytest

from benchmark import compare, harness, spec, system
from conftest import ROOT, TINY

CELLS = [w["name"] for w in spec.bench()["workloads"]]
LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]
# Limits at the tiny widths, from their own readings on the CPU over six
# seeds (the int4 control on three): the program (bfloat16 plain paths) up
# to 2.2e-3 in depth, 9.8e-4 in curiosity and 6.0e-4 in confidence, the
# control from 3.8e-3, 3.3e-3 and 1.7e-3. The cells' own limits hold their
# full widths on the card; at 16 patches the focal attention of the two
# sides (and the filter's kept set) part further than there, and is not
# judged.
TINY_LIMITS = {"depth_rel": 3e-3, "curiosity_rel": 2.5e-3, "confidence_abs": 1e-3}


@pytest.fixture(autouse=True)
def tiny_limits(monkeypatch):
    real = spec.traffic

    def traffic(root, cell_name):
        t = real(root, cell_name)
        t["limits"] = {k: v for k, v in TINY_LIMITS.items() if k in t["limits"]}
        return t

    monkeypatch.setattr(spec, "traffic", traffic)


def _line(cell, seed=11, seconds=1.0, trace=False, root=spec.ROOT):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = harness.run(cell, seed, seconds, trace, root=root, device="cpu", tiny=TINY)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_prints_its_result_line(cell):
    line = _line(cell)
    # the result line's keys, then the numbers compared, last
    assert list(line) == LINE_KEYS + ["checks"]
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    b = spec.bench()
    want = {m["name"] for m in spec.end_to_end(b, cell)}
    assert set(line["metrics"]) == want and "setup_s" in want and len(want) >= 2
    for m in line["metrics"].values():
        assert m["value"] > 0
    assert line["device"]["count"] == 1
    for k, c in line["checks"].items():
        assert c["value"] <= c["limit"], k


@pytest.mark.parametrize("cell", ["vitb14_518_int8.offline_b16", "vitl14_518_int8.served_b16"])
def test_traced_run_reports_the_host_readers(cell):
    # on the CPU there is no device trace: its readers find nothing and are left out
    line = _line(cell, trace=True)
    b = spec.bench()
    host = {m["name"] for m in spec.per_layer(b, cell) if m["source"] != "device_trace"}
    assert set(line["metrics"]) == host and host
    assert "breakdown" not in line


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert system.forbidden_modules() == []
    import cognitive_aim_tpu_torch  # noqa: F401  the port passes the comparison

    assert system.forbidden_modules() == []
    for name in ("cognitive_aim_tpu", "jax.numpy", "jaxlib", "flax.linen"):
        with monkeypatch.context() as m:
            m.setitem(sys.modules, name, types.ModuleType(name))
            assert system.forbidden_modules() == [name]


def test_a_run_that_finds_jax_loaded_prints_no_result(monkeypatch, capsys):
    real = system.build

    def build(ctx, token_filter):  # the system loads JAX behind the harness's back
        sys.modules["jax"] = types.ModuleType("jax")
        return real(ctx, token_filter)

    monkeypatch.setattr(system, "build", build)
    try:
        rc = harness.run(CELLS[0], 5, 0.5, False, device="cpu", tiny=TINY)
    finally:
        sys.modules.pop("jax", None)
    assert rc == harness.EXIT_FORBIDDEN
    assert capsys.readouterr().out == ""


def _imports(path):
    tree = ast.parse(Path(path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((ROOT / "benchmark" / "reference").glob("*.py"))
    assert files
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("cognitive_aim_tpu_torch",) + system.FORBIDDEN, (f, mod)


def test_no_harness_file_imports_jax_or_the_jax_package():
    for f in (ROOT / "benchmark").rglob("*.py"):
        for mod in _imports(f):
            assert mod.split(".")[0] not in system.FORBIDDEN, (f, mod)


@pytest.mark.parametrize("cell", ["vitb14_518_int8.offline_b16", "vitl14_518_int8.served_b16"])
def test_an_answer_altered_where_it_is_produced_is_not_correct(cell, monkeypatch):
    from cognitive_aim_tpu_torch.api import CognitiveAimInference

    real = CognitiveAimInference._forward

    def altered(self, *a, **k):
        out = real(self, *a, **k)
        out.depth[0] *= 1.05  # one image of every batch
        return out

    monkeypatch.setattr(CognitiveAimInference, "_forward", altered)
    line = _line(cell)
    assert line["correct"] is False
    assert line["checks"]["depth_rel"]["value"] > line["checks"]["depth_rel"]["limit"]


def test_a_filter_that_keeps_the_wrong_tokens_is_not_correct(monkeypatch):
    # the kept set is judged through what it moves: the filter keeps the
    # lowest-priority tokens instead of the highest
    from cognitive_aim_tpu_torch.nn import dinov2

    real = dinov2._keep_indices

    def lowest(importance, keep_weights, k_keep, ctx_frac=0.0):
        flipped = None if keep_weights is None else 2.0 - keep_weights
        return real(-importance, flipped, k_keep, ctx_frac)

    monkeypatch.setattr(dinov2, "_keep_indices", lowest)
    line = _line("vitb14_518_int8.filter235_b16")
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", ["vitb14_518_int8.offline_b16", "vitb14_518_int8.filter235_b16",
                                  "vitl14_518_int8.served_b16"])
def test_the_control_is_not_correct(cell):
    # the reference at int4 in the program's place fails one of the numbers
    rc, line, res = harness.execute(cell, 23, 0.5, False, device="cpu", tiny=TINY)
    ctx = harness.context(cell, 23, 0.5, False, device="cpu", tiny=TINY)
    numbers = compare.against_reference(ctx, res.flat, res.cases, control_bits=4)
    assert not harness.verdict(numbers, ctx.traffic["limits"], 0), numbers


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_is_added_by_data_alone(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digest(tmp_path / "benchmark")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "benchmark/configs/vitb14_518_int8.json").read_text())
    cfg["name"] = "vitb14_518_int8_copy"
    (tmp_path / "benchmark/configs/vitb14_518_int8_copy.json").write_text(json.dumps(cfg))
    (tmp_path / "benchmark/configs/vitb14_518_int8_copy.reference.json").write_text(
        json.dumps({"reference": "benchmark/reference/dinov2_gelu.py"}))
    traffic = json.loads((ROOT / "benchmark/traffic/vitb14_518_int8.offline_b16.json").read_text())
    traffic["batch"] = 8
    (tmp_path / "benchmark/traffic/vitb14_518_int8_copy.offline_b8.json").write_text(
        json.dumps(traffic))
    (tmp_path / "benchmark/metrics/engine.host_max_ms.py").write_text(
        "def read(rec):\n    return max(rec['host_ms']) if rec.get('host_ms') else None\n")
    b["configs"].append({"name": "vitb14_518_int8_copy", "source": "https://example.org",
                         "file": "benchmark/configs/vitb14_518_int8_copy.json", "reduced": [],
                         "why": "a test's copy"})
    b["workloads"].append({"name": "vitb14_518_int8_copy.offline_b8",
                           "config": "vitb14_518_int8_copy", "traffic": "offline_b8",
                           "chips": 1, "why": "a test's cell"})
    b["end_to_end"][0]["workloads"].append("vitb14_518_int8_copy.offline_b8")
    b["per_layer"].append({"name": "engine.host_max_ms", "unit": "ms", "better": "lower",
                           "source": "host_clock", "layer": "api.CognitiveAimInference",
                           "moves": "images_per_s",
                           "workloads": ["vitb14_518_int8_copy.offline_b8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    listed = spec.cells(tmp_path)
    assert listed["vitb14_518_int8_copy.offline_b8"]["per_layer"] == ["engine.host_max_ms"]
    line = _line("vitb14_518_int8_copy.offline_b8", trace=True, root=tmp_path)
    assert set(line["metrics"]) == {"engine.host_max_ms"}
    line = _line("vitb14_518_int8_copy.offline_b8", root=tmp_path)
    assert set(line["metrics"]) == {"images_per_s", "setup_s"} and line["correct"]
    after = _digest(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before  # nothing edited


def test_without_a_card_the_command_prints_no_result(tmp_path):
    # from the checkout, and from a directory of BENCHMARK.json and paths alone
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    command = json.loads((ROOT / "BENCHMARK.json").read_text())["command"]
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTHON")}
    for root in (ROOT, tmp_path):
        p = subprocess.run(command + ["--workload", CELLS[0], "--seed", str(2 ** 31 + 5),
                                      "--seconds", "1", "--trace", "0"],
                           cwd=root, env=env, capture_output=True, text=True, timeout=300)
        if p.returncode == 0:
            pytest.skip("a card is present")
        assert p.stdout == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed",
                        "7", "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
