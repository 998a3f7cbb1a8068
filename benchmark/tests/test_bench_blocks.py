"""A configuration names its plain reference module, and one with another
block kind is added as new files and entries only: here a SwiGLU block
(``swiglu_reference.py``, keys ``w12`` / ``w3``, a width that is not
D x ratio) resolves, draws, is counted, is read by the roofline and mfu
readers and runs its reference, in a copy of the benchmark whose every
earlier file keeps its bytes."""

import hashlib
import json
import shutil
import types

import numpy as np
import pytest
import torch

from benchmark import harness, inputs, spec
from benchmark.roofline import peaks, work
from conftest import ROOT, TINY

HERE = ROOT / "benchmark" / "tests"
NAME, CELL = "swiglu_toy", "swiglu_toy.offline_b16"


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def _copy(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")


def _add_swiglu(tmp_path):
    """Adds the SwiGLU configuration and one offline cell to the copy, as
    new files and new entries of ``BENCHMARK.json``."""
    bench = tmp_path / "benchmark"
    shutil.copy(HERE / "swiglu_reference.py", bench / "reference" / "swiglu_toy.py")
    cfg = json.loads((ROOT / "benchmark/configs/vitb14_518_int8.json").read_text())
    cfg["name"] = NAME
    (bench / "configs" / f"{NAME}.json").write_text(json.dumps(cfg))
    (bench / "configs" / f"{NAME}.reference.json").write_text(
        json.dumps({"reference": "benchmark/reference/swiglu_toy.py"}))
    shutil.copy(bench / "traffic" / "vitb14_518_int8.offline_b16.json",
                bench / "traffic" / f"{CELL}.json")
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["configs"].append({"name": NAME, "source": "https://example.org", "reduced": [],
                         "file": f"benchmark/configs/{NAME}.json", "why": "a test's block kind"})
    b["workloads"].append({"name": CELL, "config": NAME, "traffic": "offline_b16", "chips": 1,
                           "why": "a test's cell"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "vitb14_518_int8.offline_b16" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))


def test_the_cells_name_their_configurations_reference():
    for cell in spec.cells().values():
        assert cell["reference"] == "dinov2_gelu.py"


def test_a_configuration_with_another_block_is_new_files_only(tmp_path):
    root = tmp_path
    _copy(root)
    before = _digest(root / "benchmark")
    _add_swiglu(root)
    listed = spec.cells(root)
    assert listed[CELL]["reference"] == "swiglu_toy.py"
    assert listed[CELL]["per_layer"] == listed["vitb14_518_int8.offline_b16"]["per_layer"]
    ctx = harness.context(CELL, 5, 1.0, False, root=root, device="cpu", tiny=TINY)
    ref, d = ctx.ref, ctx.dims
    D, Fw = TINY["hidden_size"], 176  # int(2/3 * 4 * 64) = 170, up to a multiple of 8
    assert (d.hidden, d.mlp) == (D, Fw) and d.mlp != d.hidden * 4

    # the weights follow the module's layout
    _, flat = inputs.weights(ref, d, 5, "cpu")
    assert {k: v.shape for k, v in flat.items()} == ref.param_shapes(d)
    L = d.layers
    assert flat["backbone/layers/w12/w"].shape == (L, D, 2 * Fw)
    assert flat["backbone/layers/w3/w"].shape == (L, Fw, D)
    assert not any("/fc1/" in k or "/fc2/" in k for k in flat if k.startswith("backbone/"))
    bound = 1 / np.sqrt(D)
    assert 0 < np.abs(flat["backbone/layers/w12/w"]).max() <= bound

    # the work: the gated feed-forward is 6 M D F a block
    B = 16
    ffn = [u for u in ref.units(d, B) if u.kernel == "K4s"]
    assert len(ffn) == L
    assert all(u.ops == 6 * B * (1 + d.patches) * D * Fw for u in ffn)
    ops = work.matmul_ops(ref, d, B)
    n = 1 + d.patches
    assert ops["int8"] == L * (6 * B * n * D * D + 2 * B * n * D * D + 6 * B * n * D * Fw) \
        + d.num_iterations * 2 * B * d.patches * D * 3 * D

    # the readers count the module's work with no edit: a traced stretch of 4 forwards
    stretch = types.SimpleNamespace(window_s=0.5, kernels=[
        ("caim::fc1_gelu_quant_kernel<256>", 0.2), ("caim::flash_wgmma_kernel", 0.1)])
    rec = {"ref": ref, "dims": d, "batch": B, "token_filter": None, "stretch": stretch,
           "forwards": 4}
    least = sum(u.least_s for u in ref.units(d, B) if u.family == "int8_block")
    got = spec.metric(root, "roofline_pct.int8_block").read(rec)
    assert got == pytest.approx(100 * least * 4 / 0.2)
    mfu = spec.metric(root, "mfu_pct.offline").read(rec)
    assert mfu == pytest.approx(100 * 4 / 0.5 * sum(
        v / peaks.OPS_PER_S[k] for k, v in ops.items()))

    # the reference runs at the tiny widths, guided and filtered
    p = inputs.on_device(flat, "cpu")
    images = inputs.images_u8(3, d.image, 5, "t", "cpu")
    exif = {k: torch.from_numpy(v) for k, v in inputs.exif(3, 5, "t", d.num_cameras).items()}
    gidx = torch.from_numpy(inputs.instructions(3, 5, "t").astype(np.int64))
    for guidance, tf in ((None, None), (gidx, (2, 0.35))):
        out = ref.forward(p, d, images, exif, guidance, token_filter=tf)
        for k in ("depth", "confidence", "curiosity"):
            assert out[k].shape == (3,) and torch.isfinite(out[k]).all(), k
        for k in ("attention", "focal_attention"):
            assert out[k].shape == (3, d.patches) and torch.isfinite(out[k]).all(), k

    after = _digest(root / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before  # nothing edited


@pytest.mark.parametrize("reference,raises", [
    (None, FileNotFoundError),  # no reference file beside the configuration
    ("benchmark/reference/absent.py", FileNotFoundError),
    ("benchmark/drivers/offline.py", ValueError),
    ("benchmark/reference/../drivers/offline.py", ValueError),
])
def test_a_configuration_without_its_reference_does_not_resolve(tmp_path, reference, raises):
    _copy(tmp_path)
    sidecar = tmp_path / "benchmark/configs/vitl14_518_int8.reference.json"
    if reference is None:
        sidecar.unlink()
    else:
        sidecar.write_text(json.dumps({"reference": reference}))
    with pytest.raises(raises):
        spec.cells(tmp_path)
