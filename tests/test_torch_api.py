"""The port's inference engine (``cognitive_aim_tpu_torch.api``) on the CPU.

``tests/test_api.py``'s eleven cases are restated against the port with the
same names and purposes, on an engine built as that file builds its own (a
``tmp_path`` YAML, a tiny backbone, ``device="cpu"``). Where the JAX test
counts a compile cache, the port's holds the semantics it stood for: every
forward of one call has one batch shape (``engine.batch_sizes``).

Then the engine against the JAX engine: both in strict float32 with
``noise_mode="zeros"``, loading the same seeded ``.npz`` (saved by one
package, loaded by the other) or the same seeded ``.pth`` state dict, agree
in depth, confidence and attention within the port's float32 tolerance
(atol 2e-6, rtol 1e-5: summation order only, ``tests/test_torch_model.py``),
in the loaded / skipped counts, and in the JSON ``save_results`` writes.

Last, the two reference faults the port decides differently (an unstamped
adapter checkpoint in a filtered engine; the filter stamp compared after
canonicalisation), the stamp refusal, the JSON config fallback and the
device rule.
"""

import json
import os
import re
import sys

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from cognitive_aim_tpu import api as JAPI
from cognitive_aim_tpu.nn import dinov2 as JD
from cognitive_aim_tpu_torch import api as TAPI
from cognitive_aim_tpu_torch.api import CheckpointRefused, CognitiveAimInference
from cognitive_aim_tpu_torch.convert import flat_params
from cognitive_aim_tpu_torch.models import guidance as G
from cognitive_aim_tpu_torch.nn.dinov2 import DinoV2Config

torch.backends.cuda.matmul.allow_tf32 = False

TINY = dict(hidden_size=64, num_layers=2, num_heads=4, patch_size=14,
            pretrain_image_size=56)
F32_TOL = dict(atol=2e-6, rtol=1e-5)
CFG = {
    "cognitive_modules": ["ambient_stream", "iterative_focal_stream",
                          "exif_prior_database"],
    "dataset": {"image_size": 56},
    "exif_config": {"num_cameras": 5},
    "focal_config": {"num_iterations": 2},
}


def _write_cfg(d, cfg=CFG, name="cfg.yaml"):
    path = str(d / name)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def engine(tmp_path_factory):
    d = tmp_path_factory.mktemp("api")
    return CognitiveAimInference(
        _write_cfg(d), None, "cpu", noise_mode="zeros",
        output_dir=str(d / "demo_results"), vit_cfg=DinoV2Config(**TINY),
    ), d


@pytest.fixture(scope="module")
def image(tmp_path_factory):
    from PIL import Image

    p = str(tmp_path_factory.mktemp("img") / "photo.jpg")
    rng = np.random.RandomState(0)
    Image.fromarray((rng.rand(100, 150, 3) * 255).astype(np.uint8)).save(p)
    return p


# ---------------------------------------------- tests/test_api.py, restated ----
def test_predict_guided(engine, image):
    eng, d = engine
    depth, conf, meta = eng.predict(image, "center")
    assert depth > 0 and 0 <= conf <= 1
    assert meta["instruction"] == "center"
    assert meta["exif_source"] == "default"
    assert os.path.exists(d / "demo_results" / "photo_center_prediction.png")


def test_predict_unguided_deterministic(engine, image):
    eng, _ = engine
    d1, c1, _ = eng.predict(image)
    d2, c2, _ = eng.predict(image)
    assert d1 == d2 and c1 == c2  # noise_mode=zeros -> reproducible


def test_all_instructions_batched_matches_single(engine, image):
    eng, _ = engine
    nine = eng.predict_all_instructions(image)
    assert set(nine) == set(G.INSTRUCTIONS)
    d_center, c_center, _ = eng.predict(image, "center")
    np.testing.assert_allclose(nine["center"][0], d_center, rtol=1e-5)
    np.testing.assert_allclose(nine["center"][1], c_center, rtol=1e-5)


def test_native_checkpoint_roundtrip(engine, image, tmp_path):
    eng, _ = engine
    d1, _, _ = eng.predict(image, "left")
    ck = str(tmp_path / "params.npz")
    eng.save_native_checkpoint(ck)
    old = eng.params
    fresh = eng._new_model().init(torch.Generator().manual_seed(123))
    eng.params = flat_params(fresh)  # rebuilds the model from the random weights
    d_random, _, _ = eng.predict(image, "left")
    assert d_random != d1
    eng.load_checkpoint(ck)
    d2, _, _ = eng.predict(image, "left")
    np.testing.assert_allclose(d2, d1, rtol=1e-6)
    eng.params = old


def test_predict_batch_error_entries(engine):
    eng, _ = engine
    results = eng.predict_batch(["/nonexistent.jpg"])
    assert results[0][0] is None and "error" in results[0][2]


def test_save_results_json(engine, image, tmp_path):
    eng, _ = engine
    results = eng.predict_batch([image], ["top-left"])
    out = str(tmp_path / "res.json")
    eng.save_results(results, out)
    data = json.load(open(out))
    assert data[0]["depth_value"] > 0
    assert data[0]["metadata"]["instruction"] == "top-left"


def test_predict_paths_batched(engine, image):
    eng, _ = engine
    res = eng.predict_paths_batched([image, image, "/nope.jpg"], "center", batch_size=2)
    assert len(res) == 3
    assert res[0] == res[1] and res[0][0] > 0
    assert np.isnan(res[2][0])
    assert eng.last_decoder == "native"


def test_predict_paths_batched_tail_pad_one_graph(engine, image):
    """An odd-sized tail chunk is padded to batch_size (repeat-last), so the
    whole run has ONE forward shape: the JAX test counts one compiled graph,
    the port counts the batch sizes of the forwards it ran."""
    eng, _ = engine
    eng.batch_sizes.clear()
    res = eng.predict_paths_batched([image] * 5, "center", batch_size=2)
    assert len(res) == 5 and all(d > 0 for d, _ in res)
    assert dict(eng.batch_sizes) == {2: 3}, "tail chunk ran another shape"
    assert res[4] == res[0]  # padding is inert
    mixed = eng.predict_paths_batched([image] * 3, batch_size=2,
                                      instructions=["center"] * 3)
    assert mixed[2] == mixed[0]
    eng.predict_paths_batched([image] * 3, batch_size=2)
    assert set(eng.batch_sizes) == {2}


def test_predict_paths_batched_mixed_instructions(engine, image):
    """Per-path instructions batch into one guided dispatch and match the
    same instruction passed as a scalar."""
    eng, _ = engine
    mixed = eng.predict_paths_batched([image, image], batch_size=2,
                                      instructions=["center", "top-left"])
    want_c = eng.predict_paths_batched([image], "center")[0]
    want_tl = eng.predict_paths_batched([image], "top-left")[0]
    np.testing.assert_allclose(mixed[0], want_c, rtol=1e-5)
    np.testing.assert_allclose(mixed[1], want_tl, rtol=1e-5)
    with pytest.raises(ValueError):
        eng.predict_paths_batched([image], "center", instructions=["left"])
    with pytest.raises(ValueError):
        eng.predict_paths_batched([image, image], instructions=["left"])
    with pytest.raises(NotImplementedError):
        eng.predict_paths_batched([image], "center", mesh=object())


def test_all_instructions_batch_multi_image(engine, image):
    """9xM single-dispatch path agrees with the per-image nine-way call."""
    eng, _ = engine
    both = eng.predict_all_instructions_batch([image, image])
    single = eng.predict_all_instructions(image)
    assert len(both) == 2
    for name in G.INSTRUCTIONS:
        np.testing.assert_allclose(both[0][name], single[name], rtol=1e-5)
        np.testing.assert_allclose(both[1][name], both[0][name], rtol=1e-5)


def test_nine_grid_layout(engine, image, tmp_path):
    from cognitive_aim_tpu_torch.utils.visualize import create_nine_grid_layout

    eng, d = engine
    eng.predict_all_instructions(image)
    out = create_nine_grid_layout(str(d / "demo_results"), str(tmp_path / "grid.png"), "photo")
    assert out is not None and os.path.getsize(out) > 10000
    assert create_nine_grid_layout(str(d / "demo_results"),
                                   str(tmp_path / "g2.png"), "nope") is None


# ------------------------------------------------ against the JAX engine ----
def _loaded_counts(text):
    m = re.search(r"Loaded checkpoint .*: (\d+) tensors, (\d+) skipped", text)
    assert m, text
    return int(m.group(1)), int(m.group(2))


@pytest.fixture(scope="module")
def pair(tmp_path_factory, image):
    """A JAX engine and a port engine, strict float32, noise zeros, the port
    loading the JAX engine's seeded npz; the loaded / skipped counts of
    each package loading that file."""
    import contextlib
    import io

    d = tmp_path_factory.mktemp("pair")
    cfg = _write_cfg(d, {**CFG, "exif_config": {"num_cameras": 71}})
    jeng = JAPI.CognitiveAimInference(
        cfg, None, policy="f32", noise_mode="zeros", save_images=False, seed=4,
        vit_cfg=JD.DinoV2Config(**TINY))
    npz = str(d / "jax.npz")
    jeng.save_native_checkpoint(npz)
    counts = {}
    for name, make in (
            ("jax", lambda: JAPI.CognitiveAimInference(
                cfg, npz, policy="f32", noise_mode="zeros", save_images=False, seed=9,
                vit_cfg=JD.DinoV2Config(**TINY))),
            ("port", lambda: CognitiveAimInference(
                cfg, npz, "cpu", policy="f32", noise_mode="zeros", save_images=False,
                seed=9, vit_cfg=DinoV2Config(**TINY)))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            eng = make()
        counts[name] = _loaded_counts(buf.getvalue())
        if name == "port":
            teng = eng
    return jeng, teng, counts, d


def test_counts_match_jax_on_the_jax_npz(pair):
    _, teng, counts, _ = pair
    assert counts["port"] == counts["jax"] == (len(teng.params), 0)


def test_predict_matches_jax_unguided_and_all_instructions(pair, image):
    jeng, teng, _, _ = pair
    for instr in (None,) + G.INSTRUCTIONS:
        jd, jc, jm = jeng.predict(image, instr)
        td, tc, tm = teng.predict(image, instr)
        np.testing.assert_allclose(td, jd, **F32_TOL)
        np.testing.assert_allclose(tc, jc, **F32_TOL)
        assert tm == jm


def test_nine_way_attention_matches_jax(pair, image):
    """Depth, confidence and attention of the 9-instruction batch."""
    from cognitive_aim_tpu.io import exif as JEX

    jeng, teng, _, _ = pair
    images, _ = teng._prep_image(image)
    exif = JEX.exif_arrays_for_model(None)
    td, tc, ta = teng._nine_way(images, [exif])
    out = jeng._guided(jeng.params, jnp.asarray(np.repeat(images, 9, 0)),
                       {k: jnp.asarray(np.repeat(v, 9, 0)) for k, v in exif.items()},
                       jnp.arange(9, dtype=jnp.int32), jeng._next_key())
    np.testing.assert_allclose(td, np.asarray(out.depth)[:, 0], **F32_TOL)
    np.testing.assert_allclose(tc, np.asarray(out.confidence)[:, 0], **F32_TOL)
    np.testing.assert_allclose(ta, np.asarray(out.attention), **F32_TOL)


def test_all_instructions_and_batch_match_jax(pair, image):
    jeng, teng, _, _ = pair
    for t, j in ((teng.predict_all_instructions(image), jeng.predict_all_instructions(image)),
                 *zip(teng.predict_all_instructions_batch([image, image]),
                      jeng.predict_all_instructions_batch([image, image]))):
        assert set(t) == set(j) == set(G.INSTRUCTIONS)
        for name in G.INSTRUCTIONS:
            np.testing.assert_allclose(t[name], j[name], **F32_TOL)


def test_predict_paths_batched_matches_jax(pair, image, tmp_path):
    """Both packages' native loaders, EXIF from the loaders' APP1 payloads,
    a padded tail and a failed decode."""
    from test_torch_io import _exif_jpeg

    jeng, teng, _, _ = pair
    paths = [image, _exif_jpeg(tmp_path), "/nope.jpg", image, image]
    for kw in (dict(instruction="left"), dict(instructions=list(G.INSTRUCTIONS[:5])), {}):
        t = teng.predict_paths_batched(paths, batch_size=2, **kw)
        j = jeng.predict_paths_batched(paths, batch_size=2, **kw)
        assert np.isnan(t[2][0]) and np.isnan(j[2][0])
        np.testing.assert_allclose(np.asarray(t), np.asarray(j), **F32_TOL)


def test_jax_loads_the_port_npz(pair, image, tmp_path):
    """The other way round: the port's npz in a fresh JAX engine."""
    jeng, teng, _, d = pair
    npz = str(tmp_path / "port.npz")
    teng.save_native_checkpoint(npz)
    with np.load(npz) as z:
        assert set(z.files) == set(JAPI.flatten_tree(jeng.params))
    cfg = str(d / "cfg.yaml")
    j2 = JAPI.CognitiveAimInference(cfg, npz, policy="f32", noise_mode="zeros",
                                    save_images=False, seed=11,
                                    vit_cfg=JD.DinoV2Config(**TINY))
    for instr in (None, "bottom-right"):
        np.testing.assert_allclose(teng.predict(image, instr)[:2],
                                   j2.predict(image, instr)[:2], **F32_TOL)


def test_pth_state_dict_matches_jax(pair, image, tmp_path, capsys):
    """A seeded reference .pth (one tensor of the wrong shape) through both
    packages' _convert_state_dict: the same counts, the same answers. Both
    engines start from the pair's npz, so what the .pth does not carry (the
    guided projection, the skipped tensor) holds the same values."""
    from test_torch_io import reference_state_dict

    _, teng, _, d = pair
    sd = reference_state_dict(teng.params, seed=2,
                              skip_shapes=("exif_prior/camera_embedding/table",))
    pth = str(tmp_path / "ref.pth")
    torch.save({"model_state_dict": sd, "epoch": 3}, pth)
    cfg, npz = str(d / "cfg.yaml"), str(d / "jax.npz")
    j = JAPI.CognitiveAimInference(cfg, npz, policy="f32", noise_mode="zeros",
                                   save_images=False, vit_cfg=JD.DinoV2Config(**TINY))
    t = CognitiveAimInference(cfg, npz, "cpu", policy="f32", noise_mode="zeros",
                              save_images=False, vit_cfg=DinoV2Config(**TINY))
    capsys.readouterr()
    j.load_checkpoint(pth)
    jc = _loaded_counts(capsys.readouterr().out)
    t.load_checkpoint(pth)
    tc = _loaded_counts(capsys.readouterr().out)
    assert tc == jc and tc[1] == 1
    for instr in (None, "top"):
        np.testing.assert_allclose(t.predict(image, instr)[:2], j.predict(image, instr)[:2],
                                   **F32_TOL)


def test_save_results_json_matches_jax(pair, image, tmp_path):
    from fractions import Fraction

    jeng, teng, _, _ = pair
    for eng, name in ((jeng, "j.json"), (teng, "t.json")):
        res = eng.predict_batch([image, "/nope.jpg"], ["top-left", None])
        res[0][2]["exif_data"] = {"FNumber": Fraction(28, 10), "Model": "X"}
        eng.save_results(res, str(tmp_path / name))
    t, j = (json.load(open(tmp_path / n)) for n in ("t.json", "j.json"))
    assert t[1] == j[1] and t[0]["metadata"] == j[0]["metadata"]
    np.testing.assert_allclose([t[0]["depth_value"], t[0]["confidence_score"]],
                               [j[0]["depth_value"], j[0]["confidence_score"]], **F32_TOL)


# --------------------------------------------- the faults decided, stamps ----
FILTER = "1:0.5"  # the tiny backbone has 2 blocks


def _adapter_npz(d, pair_engine, stamps):
    """The pair's weights plus rank-4 adapters on attn_out and fc1 with
    non-zero B, saved with the given ``__meta__`` stamps."""
    rng = np.random.RandomState(6)
    flat = dict(pair_engine.params)
    L, D = flat["backbone/layers/ls1"].shape
    F = flat["backbone/layers/fc1/w"].shape[-1]
    for a, b, din, dout in (("lora_A", "lora_B", D, D), ("lora_fc1_A", "lora_fc1_B", D, F)):
        flat[f"backbone/layers/{a}"] = (rng.randn(L, 4, din) * 0.1).astype(np.float32)
        flat[f"backbone/layers/{b}"] = (rng.randn(L, dout, 4) * 0.1).astype(np.float32)
    path = str(d / f"adapters_{len(stamps)}.npz")
    np.savez(path, **flat, **{f"__meta__/{k}": np.asarray(v) for k, v in stamps.items()})
    return path


def test_unstamped_adapters_in_a_filtered_engine_raise(pair, image, tmp_path):
    """Reference fault (a): the JAX filtered engine skips the fold of an
    unstamped adapter checkpoint and serves the base weights; the port
    refuses it, naming the stamp. An exact engine drops the adapters, as
    the JAX one does, and serves the base weights."""
    _, teng, _, d = pair
    npz = _adapter_npz(tmp_path, teng, {"train_filter": FILTER})
    cfg = str(d / "cfg.yaml")
    kw = dict(policy="f32", noise_mode="zeros", save_images=False,
              vit_cfg=DinoV2Config(**TINY))
    with pytest.raises(CheckpointRefused, match="adapter_rank"):
        CognitiveAimInference(cfg, npz, "cpu", token_filter=FILTER, **kw)
    exact = CognitiveAimInference(cfg, npz, "cpu", **kw)
    assert set(exact.params) == set(teng.params)
    np.testing.assert_array_equal(exact.predict(image, "left")[:2],
                                  teng.predict(image, "left")[:2])
    jexact = JAPI.CognitiveAimInference(cfg, npz, policy="f32", noise_mode="zeros",
                                        save_images=False, vit_cfg=JD.DinoV2Config(**TINY))
    np.testing.assert_allclose(exact.predict(image, "left")[:2],
                               jexact.predict(image, "left")[:2], **F32_TOL)


def test_stamped_adapters_fold_as_in_jax(pair, image, tmp_path):
    """A stamped adapter checkpoint in a filtered engine: folded through
    load_flat_params and merge_lora_params before prepare_params, equal to
    the JAX engine's fold; the folded interchange holds no adapters."""
    _, teng, _, d = pair
    stamps = {"train_filter": FILTER, "adapter_rank": "4", "adapter_alpha": "8",
              "adapter_targets": "attn_out,fc1"}
    npz = _adapter_npz(tmp_path, teng, stamps)
    cfg = str(d / "cfg.yaml")
    t = CognitiveAimInference(cfg, npz, "cpu", token_filter=FILTER, policy="f32",
                              noise_mode="zeros", save_images=False,
                              vit_cfg=DinoV2Config(**TINY))
    j = JAPI.CognitiveAimInference(cfg, npz, policy="f32", noise_mode="zeros",
                                   save_images=False, token_filter=FILTER,
                                   vit_cfg=JD.DinoV2Config(**TINY))
    assert not any(k.startswith("backbone/layers/lora") for k in t.params)
    assert not any(blk.has_adapters for blk in t.model.backbone.layers)
    jflat = JAPI.flatten_tree(j.params)
    assert set(t.params) == set(jflat)
    for k in jflat:
        np.testing.assert_allclose(t.params[k], jflat[k], atol=1e-6, rtol=1e-6)
    for instr in (None, "center", "bottom-left"):
        np.testing.assert_allclose(t.predict(image, instr)[:2], j.predict(image, instr)[:2],
                                   **F32_TOL)


def test_filter_stamp_compared_after_canonicalisation(pair, tmp_path, capsys, monkeypatch):
    """Reference fault (b): a raw CLI stamp ('1:0.50') matches the canonical
    spec ('1:0.5') in the port; the JAX engine warns on it. A stamp for
    another spec, or none, warns; under CAIM_REQUIRE_FILTER_STAMP=1 it
    raises out of the constructor."""
    _, teng, _, d = pair
    cfg = str(d / "cfg.yaml")
    kw = dict(policy="f32", noise_mode="zeros", save_images=False)

    def npz(stamp):
        path = str(tmp_path / f"s{len(stamp)}.npz")
        extra = {"__meta__/train_filter": np.asarray(stamp)} if stamp else {}
        np.savez(path, **teng.params, **extra)
        return path

    raw = npz("1:0.50")
    capsys.readouterr()
    CognitiveAimInference(cfg, raw, "cpu", token_filter=FILTER,
                          vit_cfg=DinoV2Config(**TINY), **kw)
    assert "WARNING" not in capsys.readouterr().out
    JAPI.CognitiveAimInference(cfg, raw, token_filter=FILTER,
                               vit_cfg=JD.DinoV2Config(**TINY), **kw)
    assert "stamped for '1:0.50'" in capsys.readouterr().out
    for bad in (npz(""), npz("1:0.6@p")):
        CognitiveAimInference(cfg, bad, "cpu", token_filter=FILTER,
                              vit_cfg=DinoV2Config(**TINY), **kw)
        assert "WARNING: token filter '1:0.5' is active" in capsys.readouterr().out
        monkeypatch.setenv("CAIM_REQUIRE_FILTER_STAMP", "1")
        with pytest.raises(CheckpointRefused, match="train-filter stamp|stamped for"):
            CognitiveAimInference(cfg, bad, "cpu", token_filter=FILTER,
                                  vit_cfg=DinoV2Config(**TINY), **kw)
        monkeypatch.delenv("CAIM_REQUIRE_FILTER_STAMP")
        CognitiveAimInference(cfg, raw, "cpu", vit_cfg=DinoV2Config(**TINY), **kw)


def test_unreadable_checkpoint_keeps_the_random_weights(engine, image, tmp_path, capsys):
    eng, d = engine
    bad = tmp_path / "broken.npz"
    bad.write_bytes(b"not a zip")
    before = eng.predict(image, "top")[:2]
    eng.load_checkpoint(str(bad))
    assert "Continuing with randomly initialized weights" in capsys.readouterr().out
    assert eng.predict(image, "top")[:2] == before


# ------------------------------------------------ config, device, noise ----
def test_config_reads_json_without_pyyaml(tmp_path, monkeypatch):
    js = tmp_path / "cfg.json"
    js.write_text(json.dumps(CFG))
    ym = _write_cfg(tmp_path)
    assert TAPI.load_config(str(js)) == TAPI.load_config(ym) == CFG
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml fails
    assert TAPI.load_config(str(js)) == CFG
    with pytest.raises(ValueError, match="PyYAML is not installed"):
        TAPI.load_config(ym)


def test_engine_builds_on_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CognitiveAimInference(_write_cfg(tmp_path), vit_cfg=DinoV2Config(**TINY))
    eng = CognitiveAimInference(_write_cfg(tmp_path), None, "cpu",
                                vit_cfg=DinoV2Config(**TINY), save_images=False)
    assert all(p.device.type == "cpu" for p in eng.model.parameters())


def test_sampled_noise_takes_a_fresh_generator_per_call(engine, image, tmp_path):
    """noise_mode='sample': each forward draws from a generator seeded by
    (seed, counter), so two calls differ and two engines of one seed agree."""
    kw = dict(noise_mode="sample", save_images=False, vit_cfg=DinoV2Config(**TINY))
    cfg = _write_cfg(tmp_path)
    a = CognitiveAimInference(cfg, None, "cpu", seed=3, **kw)
    b = CognitiveAimInference(cfg, None, "cpu", seed=3, **kw)
    x = torch.from_numpy(a._prep_image(image)[0])
    exif = a._to_device({"camera_idx": np.zeros(1, np.int32),
                         **{k: np.ones(1, np.float32) for k in ("focal_length", "aperture",
                                                                "iso")}})
    first, second = (a._forward(x, exif).curiosity for _ in range(2))
    assert torch.equal(b._forward(x, exif).curiosity, first)  # b's first draw
    assert not torch.equal(first, second)
    ga, gb, gb2 = a._next_key(), b._next_key(), b._next_key()  # draws 2, 1, 2
    ra = torch.randn(4, generator=ga)
    assert torch.equal(ra, torch.randn(4, generator=gb2))
    assert not torch.equal(ra, torch.randn(4, generator=gb))


def test_demo_cli_on_the_cpu(tmp_path, image, monkeypatch, capsys):
    """demo_torch.py's single-image and nine-way modes with --device cpu
    (ViT-B at 56x56), and the nine-grid CLI on the PNGs demo mode wrote."""
    import create_nine_grid_demo_torch
    import demo_torch

    cfg = _write_cfg(tmp_path)
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "res.json")
    monkeypatch.setattr(sys, "argv", [
        "demo_torch.py", "--config", cfg, "--image", image, "--device", "cpu",
        "--deterministic", "--save-json", "--output", out, "--instruction", "left",
        "--policy", "f32"])
    demo_torch.main()
    res = json.load(open(out))
    assert res[0]["metadata"]["instruction"] == "left" and res[0]["depth_value"] > 0
    assert (tmp_path / "demo_results" / "photo_left_prediction.png").exists()
    monkeypatch.setattr(sys, "argv", [
        "create_nine_grid_demo_torch.py", "--image", image, "--config", cfg,
        "--device", "cpu", "--output", str(tmp_path / "grid.png")])
    create_nine_grid_demo_torch.main()
    assert (tmp_path / "grid.png").exists()
    assert "Nine-grid figure saved" in capsys.readouterr().out
