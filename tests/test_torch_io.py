"""The port's host IO against the JAX package's: EXIF, preprocessing, the
native loader, guidance vectors, the attention heatmap, the torch
checkpoint converters, ``filter_and_merge`` and ``flat_params``.

The cases of ``tests/test_io.py`` and ``tests/test_native_loader.py`` are
restated against the port with the same names and purposes, less the four
``test_io.py`` cases of ``io/dataset.py`` (the dataset, its loader and the
prefetcher), which the port does not have yet. The copies of JAX modules
(``io/exif.py``, ``io/checkpoint_torch.py``, the preprocessing functions,
``guidance_vector``, ``visualize.attention_heatmap``) are held equal to
their originals on seeded inputs: bit for bit where both sides run the same
numpy or PIL code, and within float32 rounding (atol 1e-6) where one side
is torch and the other XLA.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from cognitive_aim_tpu.api import flatten_tree as j_flatten_tree
from cognitive_aim_tpu.io import checkpoint_torch as JCT
from cognitive_aim_tpu.io import exif as JEX
from cognitive_aim_tpu.io import native_loader as JNL
from cognitive_aim_tpu.io import preprocess as JPre
from cognitive_aim_tpu.models import guidance as JG
from cognitive_aim_tpu.models.cognitive_aim import CognitiveAimModel as JModel
from cognitive_aim_tpu.models.config import ModelArchConfig
from cognitive_aim_tpu.nn import dinov2 as JD
from cognitive_aim_tpu.nn.torch_interp import resize_weights
from cognitive_aim_tpu.utils import visualize as JVis
from cognitive_aim_tpu_torch.api import flatten_tree, unflatten_npz
from cognitive_aim_tpu_torch.convert import flat_params, load_flat_params
from cognitive_aim_tpu_torch.core.precision import INT8_BACKBONE
from cognitive_aim_tpu_torch.io import checkpoint_torch as TCT
from cognitive_aim_tpu_torch.io import exif as TEX
from cognitive_aim_tpu_torch.io import native_loader
from cognitive_aim_tpu_torch.io import preprocess as TPre
from cognitive_aim_tpu_torch.io.preprocess import IMAGENET_MEAN_NP, IMAGENET_STD_NP
from cognitive_aim_tpu_torch.models import config as TCfg
from cognitive_aim_tpu_torch.models import guidance as TG
from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel as TModel
from cognitive_aim_tpu_torch.nn import dinov2 as TD
from cognitive_aim_tpu_torch.utils import logging as TLog
from cognitive_aim_tpu_torch.utils import visualize as TVis

TINY = dict(hidden_size=64, num_layers=2, num_heads=4, patch_size=14,
            pretrain_image_size=56)


# ---------------------------------------------------------------- images ----
@pytest.fixture(autouse=True, scope="module")
def _no_grad():
    """The model's forward is differentiable since the port trains; these
    inference tests run under torch.no_grad(), as the engine serves."""
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """A JPEG and a PNG of seeded pixels, each with its decoded pixels."""
    from PIL import Image

    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(0)
    arrs = {}
    for name, fmt in (("a.jpg", "JPEG"), ("b.png", "PNG")):
        arr = (rng.rand(96, 128, 3) * 255).astype(np.uint8)
        path = str(d / name)
        Image.fromarray(arr).save(path, format=fmt, quality=98)
        # reread (jpeg is lossy) for the reference comparison
        arrs[path] = np.asarray(Image.open(path).convert("RGB"), np.uint8)
    return arrs


def _exif_jpeg(tmp_path, name="exif.jpg", tags=None, seed=3):
    """A JPEG with an EXIF block: IFD0 Make/Model, the Exif sub-IFD's
    FocalLength, FNumber, ISO and ExposureTime (``tags`` overrides)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    img = Image.fromarray((rng.rand(80, 60, 3) * 255).astype(np.uint8))
    ex = Image.Exif()
    ex[271], ex[272] = "TestMake", "TestModel"
    sub = ex.get_ifd(0x8769)
    t = {37386: 35.0, 33437: 4.0, 34855: 400, 33434: 0.01}
    t.update(tags or {})
    for k, v in t.items():
        sub[k] = v
    p = str(tmp_path / name)
    img.save(p, "JPEG", exif=ex)
    return p


# ------------------------------------------- tests/test_native_loader.py ----
def test_native_build():
    assert native_loader.available(), "native loader failed to build"
    assert native_loader.decoder() == "native"
    assert native_loader.build_error is None


def test_decode_matches_reference(images):
    paths = list(images)
    out, ok = native_loader.decode_resize_batch(paths, 48, 64, normalize=True)
    assert ok.all()
    for i, p in enumerate(paths):
        u8 = images[p].astype(np.float32) / 255.0
        Wh = resize_weights(96, 48, "bilinear")
        Ww = resize_weights(128, 64, "bilinear")
        ref = np.einsum("oh,hwc->owc", Wh, u8)
        ref = np.einsum("pw,owc->opc", Ww, ref)
        ref = (ref - IMAGENET_MEAN_NP) / IMAGENET_STD_NP
        np.testing.assert_allclose(out[i], ref, atol=2e-3)


def test_bad_path(images):
    paths = list(images)[:1] + ["/nonexistent/xx.jpg"]
    out, ok = native_loader.decode_resize_batch(paths, 32, 32)
    assert ok[0] and not ok[1]
    assert np.all(out[1] == 0.0)


def test_exif_single_pass(images, tmp_path):
    """The combined decode+EXIF call returns pixels AND the APP1 payload in
    one file pass; parsed tags match the PIL reopen path exactly."""
    p_exif = _exif_jpeg(tmp_path)
    paths = [p_exif] + list(images)  # EXIF jpeg + plain jpeg + png
    u8, ok, payloads = native_loader.decode_resize_batch_u8_exif(paths, 48, 64)
    assert ok.all()
    u8_ref, _ = native_loader.decode_resize_batch_u8(paths, 48, 64)
    np.testing.assert_array_equal(u8, u8_ref)
    assert payloads[0] is not None and payloads[0].startswith(b"Exif\x00\x00")
    assert payloads[1] is None and payloads[2] is None
    got = TEX.extract_exif_from_app1(payloads[0])
    want = TEX.extract_exif(p_exif)
    assert got == want
    assert got["FocalLength"] == 35.0 and got["FNumber"] == 4.0
    assert got["ISOSpeedRatings"] == 400 and got["Model"] == "TestModel"


def test_exif_app1_python_fallback(images, tmp_path):
    """read_exif_app1 (the no-native fallback) finds the same payload the
    C loader captures, without decoding pixels."""
    p_exif = _exif_jpeg(tmp_path, "exif2.jpg")
    raw = TEX.read_exif_app1(p_exif)
    _, _, payloads = native_loader.decode_resize_batch_u8_exif([p_exif], 32, 32)
    assert raw == payloads[0]
    assert TEX.read_exif_app1(list(images)[0]) is None


def test_decode_u8_matches_f32(images):
    paths = list(images)
    u8, ok = native_loader.decode_resize_batch_u8(paths, 48, 64)
    assert ok.all()
    f32, _ = native_loader.decode_resize_batch(paths, 48, 64, normalize=False)
    np.testing.assert_allclose(u8.astype(np.float32) / 255.0, f32, atol=2.0 / 255)

    normed = TPre.normalize_u8(torch.from_numpy(u8)).numpy()
    ref = (f32 - IMAGENET_MEAN_NP) / IMAGENET_STD_NP
    np.testing.assert_allclose(normed, ref, atol=0.03)


# ------------------------------------------------------ tests/test_io.py ----
def test_exif_normalization_matches_reference_formulas():
    n = TEX.normalize_exif_dataset(
        {"focal_length": 85.0, "aperture": 4.0, "iso": 800.0, "camera_model": "X"},
        {"X": 3, "unknown": 5},
    )
    assert abs(n["focal_length"] - 85.0 / 200.0) < 1e-9
    assert abs(n["aperture"] - 4.0 / 22.0) < 1e-9
    assert abs(n["iso"] - 800.0 / 6400.0) < 1e-9
    assert n["camera_idx"] == 3
    n = TEX.normalize_exif_dataset({"focal_length": 999.0, "aperture": 0.5,
                                    "iso": 10.0}, {"unknown": 0})
    assert n["focal_length"] == 1.0 and n["aperture"] == 1.0 / 22.0
    assert n["iso"] == 50.0 / 6400.0
    d = TEX.normalize_exif_dataset(None, {"unknown": 9})
    assert (d["focal_length"], d["aperture"], d["iso"]) == (0.25, 0.127, 0.016)
    assert d["camera_idx"] == 9


def test_exif_inference_defaults():
    a = TEX.exif_arrays_for_model(None)
    assert a["focal_length"][0] == 50.0 and a["aperture"][0] == 2.8
    assert a["iso"][0] == 100.0 and a["camera_idx"][0] == 0
    a = TEX.exif_arrays_for_model({"FocalLength": 35.0, "Model": "Y"},
                                  {"Y": 2, "unknown": 0})
    assert a["focal_length"][0] == 35.0 and a["camera_idx"][0] == 2


def test_npz_checkpoint_roundtrip(tmp_path):
    tree = {
        "a": {"w": np.ones((2, 3), np.float32)},
        "list": [{"x": np.zeros(4)}, {"x": np.ones(4)}],
    }
    flat = flatten_tree(tree)
    assert set(flat) == {"a/w", "list/0/x", "list/1/x"}
    np.savez(tmp_path / "rt.npz", **flat)
    back = unflatten_npz(np.load(tmp_path / "rt.npz"))
    merged, loaded, skipped = TCT.filter_and_merge(flat, back)
    assert loaded == 3 and skipped == 0
    np.testing.assert_array_equal(merged["list/1/x"], tree["list"][1]["x"])


# ------------------------------------------------ the copies against JAX ----
@pytest.mark.parametrize("tags", [
    {},
    {37386: 600.0, 33437: 0.5, 34855: 30, 33434: 100.0},  # all outside the ranges
    {37386: (50, 2), 33437: (28, 10)},  # TIFF rationals
    {34855: 25600, 33434: 0.0001},  # the ranges' edges
], ids=["plain", "implausible", "rationals", "edges"])
def test_exif_extraction_matches_jax(tmp_path, tags):
    p = _exif_jpeg(tmp_path, tags=tags)
    raw = TEX.read_exif_app1(p)
    assert raw == JEX.read_exif_app1(p)
    for t, j in ((TEX.extract_exif(p), JEX.extract_exif(p)),
                 (TEX.extract_exif_from_app1(raw), JEX.extract_exif_from_app1(raw))):
        assert t == j
    cams = {"TestModel": 4, "unknown": 0}
    ta = TEX.exif_arrays_for_model(TEX.extract_exif(p), cams)
    ja = JEX.exif_arrays_for_model(JEX.extract_exif(p), cams)
    for k in ja:
        assert ta[k].dtype == ja[k].dtype and ta[k].shape == (1,)
        np.testing.assert_array_equal(ta[k], ja[k])


def test_exif_filter_and_dataset_normalization_match_jax():
    rng = np.random.RandomState(5)
    for _ in range(20):
        raw = {37386: float(rng.uniform(1, 600)), 33437: (int(rng.randint(1, 400)), 10),
               34855: int(rng.randint(10, 30000)), 33434: str(rng.uniform(0, 40)),
               271: rng.choice(["  Make ", "", 3]), 272: "M"}
        assert TEX._filter_exif_tags(raw) == JEX._filter_exif_tags(raw)
        ds = {"focal_length": float(rng.uniform(0, 300)),
              "aperture": float(rng.uniform(0, 30)),
              "iso": float(rng.uniform(0, 9000)), "camera_model": rng.choice(["A", "B"])}
        cams = {"A": 1, "unknown": 7}
        assert TEX.normalize_exif_dataset(ds, cams) == JEX.normalize_exif_dataset(ds, cams)
    assert TEX._filter_exif_tags(None) is None and TEX.extract_exif("/nope.jpg") is None
    assert TEX.extract_exif_from_app1(None) is None


def test_host_preprocessing_matches_jax(images):
    paths = list(images)
    for p in paths:
        u8 = TPre.load_image_uint8(p)
        np.testing.assert_array_equal(u8, JPre.load_image_uint8(p))
        r = TPre.pil_resize_host(u8, 40, 52)
        np.testing.assert_array_equal(r, JPre.pil_resize_host(u8, 40, 52))
        np.testing.assert_array_equal(TPre.normalize_np(r), JPre.normalize_np(r))
    np.testing.assert_array_equal(TPre.preprocess_paths(paths, 42),
                                  JPre.preprocess_paths(paths, 42))
    np.testing.assert_allclose(TPre.preprocess_paths(paths, 42, exact_pil=False),
                               JPre.preprocess_paths(paths, 42, exact_pil=False),
                               atol=1e-5)


def test_normalize_u8_matches_jax():
    import jax.numpy as jnp

    u8 = np.random.RandomState(1).randint(0, 256, (2, 9, 7, 3)).astype(np.uint8)
    got = TPre.normalize_u8(torch.from_numpy(u8)).numpy()
    want = np.asarray(JNL.normalize_u8_on_device(jnp.asarray(u8)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_native_loader_matches_jax_loader(images, tmp_path):
    """The port's build of its copy of loader.cpp decodes bit for bit as the
    JAX package's build of the original."""
    paths = [_exif_jpeg(tmp_path)] + list(images) + ["/nonexistent.png"]
    for fn in ("decode_resize_batch_u8", "decode_resize_batch_u8_exif"):
        t = getattr(native_loader, fn)(paths, 37, 45)
        j = getattr(JNL, fn)(paths, 37, 45)
        for a, b in zip(t, j):
            if isinstance(a, list):
                assert a == b
            else:
                np.testing.assert_array_equal(a, b)
    for norm in (True, False):
        t = native_loader.decode_resize_batch(paths, 30, 31, normalize=norm)
        j = JNL.decode_resize_batch(paths, 30, 31, normalize=norm)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)


def test_pil_fallback_without_a_toolchain(images, tmp_path, monkeypatch):
    """Where the loader does not build, every function falls back to PIL,
    ``decoder()`` says so and the results are the JAX fallback's."""
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_build_failed", True)
    monkeypatch.setattr(JNL, "_lib", None)
    monkeypatch.setattr(JNL, "_build_failed", True)
    assert native_loader.decoder() == "pil" and not native_loader.available()
    paths = [_exif_jpeg(tmp_path)] + list(images) + ["/nonexistent.png"]
    t_u8, t_ok, t_pl = native_loader.decode_resize_batch_u8_exif(paths, 33, 35)
    j_u8, j_ok, j_pl = JNL.decode_resize_batch_u8_exif(paths, 33, 35)
    np.testing.assert_array_equal(t_u8, j_u8)
    np.testing.assert_array_equal(t_ok, j_ok)
    assert t_pl == j_pl and t_pl[0] is not None and not t_ok[-1]
    t, _ = native_loader.decode_resize_batch(paths, 33, 35)
    j, _ = JNL.decode_resize_batch(paths, 33, 35)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("n", [16, 25, 26, 1369])
def test_guidance_vector_matches_jax(n):
    for name in JG.INSTRUCTIONS + ("TopLeft",):
        got = TG.guidance_vector(name, n, "cpu")
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(JG.guidance_vector(name, n)))


@pytest.mark.parametrize("n", [16, 26, 1369])
def test_attention_heatmap_matches_jax(n):
    attn = np.random.RandomState(n).rand(n).astype(np.float32)
    np.testing.assert_array_equal(TVis.attention_heatmap(attn, 30, 41),
                                  JVis.attention_heatmap(attn, 30, 41))


def test_prediction_image_and_nine_grid(tmp_path):
    img = np.random.RandomState(2).randn(28, 28, 3).astype(np.float32)
    out = TVis.save_prediction_image(img, 1.5, 0.7, np.random.rand(4), "left",
                                     "x/photo.jpg", str(tmp_path))
    assert out.endswith("photo_left_prediction.png")
    assert TVis.save_prediction_image(img, 1.5, 0.7, None, None, "photo.jpg",
                                      str(tmp_path)).endswith("photo_prediction.png")
    grid = TVis.create_nine_grid_layout(str(tmp_path), str(tmp_path / "g.png"), "photo")
    assert grid is not None
    assert TVis.create_nine_grid_layout(str(tmp_path), str(tmp_path / "n.png"), "no") is None
    fig = TVis.visualize_depth_prediction(img, np.random.rand(5, 5), np.random.rand(5, 5),
                                          str(tmp_path / "d.png"))
    assert (tmp_path / "d.png").exists()
    import matplotlib.pyplot as plt

    plt.close(fig)


# ------------------------------------------------- checkpoint converters ----
def _torch_linear(sd, name, w_io, b):
    sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(w_io.T))
    sd[f"{name}.bias"] = torch.from_numpy(b)


def reference_state_dict(flat, seed=0, skip_shapes=()):
    """A state dict in the reference architecture's names for the model
    whose flat interchange is ``flat``, with seeded values of the same shapes
    (``skip_shapes``: keys given one extra row, which the filter skips)."""
    rng = np.random.RandomState(seed)

    def val(key):
        shape = flat[key].shape
        if key in skip_shapes:
            shape = (shape[0] + 1,) + shape[1:]
        return np.asarray(rng.randn(*shape) * 0.1, np.float32)

    seq = {  # flat module prefix -> (torch name, Sequential indices)
        "ambient_stream/mlp": ("ambient_stream.mlp", (0, 3, 5)),
        "exif_prior/exif_encoder": ("exif_prior.exif_encoder", (0, 2)),
        "exif_prior/fusion": ("exif_prior.fusion", (0, 3)),
        "focal_stream/fusion": ("focal_stream.fusion", (0, 2)),
        "focal_stream/curiosity_amplifier": ("focal_stream.curiosity_amplifier", (0, 2)),
        "fusion": ("fusion", (0,)),
        "decision_head": ("decision_head", (0,)),
        "confidence_head": ("confidence_head", (0, 2)),
    }
    for name, idx in (("encoder_mean", (0, 3)), ("encoder_logvar", (0, 3)),
                      ("decoder", (0, 3)), ("uncertainty_head", (0, 2)),
                      ("geometric_curiosity", (0, 2)), ("local_curiosity", (0, 2))):
        seq[f"curiosity_module/{name}"] = (f"curiosity_module.{name}", idx)
    n_streams = len({k.split("/")[2] for k in flat if k.startswith("focal_stream/streams/")})
    for i in range(n_streams):
        fs = f"focal_stream/streams/{i}"
        seq[f"{fs}/projection"] = (f"focal_stream.focal_streams.{i}.projection", (0, 3))
        seq[f"{fs}/curiosity_modulator"] = (
            f"focal_stream.focal_streams.{i}.curiosity_modulator", (0, 2))
    sd = {}
    for prefix, (tname, idx) in seq.items():
        for j, ix in enumerate(idx):
            key = f"{prefix}/fc{j}"
            if f"{key}/w" in flat:
                _torch_linear(sd, f"{tname}.{ix}", val(f"{key}/w"), val(f"{key}/b"))
    for i in range(n_streams):
        fs = f"focal_stream/streams/{i}"
        for proj in ("query_proj", "key_proj", "value_proj"):
            _torch_linear(sd, f"focal_stream.focal_streams.{i}.{proj}",
                          val(f"{fs}/{proj}/w"), val(f"{fs}/{proj}/b"))
        sd[f"focal_stream.focal_streams.{i}.adaptive_weight"] = torch.from_numpy(
            val(f"{fs}/adaptive_weight"))
    sd["focal_stream.initial_focus"] = torch.from_numpy(val("focal_stream/initial_focus"))
    if "curiosity_module/curiosity_weights" in flat:
        sd["curiosity_module.curiosity_weights"] = torch.from_numpy(
            val("curiosity_module/curiosity_weights"))
    sd["exif_prior.camera_embedding.weight"] = torch.from_numpy(
        val("exif_prior/camera_embedding/table"))
    # backbone, in Hugging Face Dinov2Model names
    b = "backbone."
    pw = val("backbone/patch_embed/w")  # [ph*pw*C, D]
    D, p = pw.shape[1], 14
    sd[f"{b}embeddings.patch_embeddings.projection.weight"] = torch.from_numpy(
        np.ascontiguousarray(pw.reshape(p, p, 3, D).transpose(3, 2, 0, 1)))
    sd[f"{b}embeddings.patch_embeddings.projection.bias"] = torch.from_numpy(
        val("backbone/patch_embed/b"))
    sd[f"{b}embeddings.cls_token"] = torch.from_numpy(val("backbone/cls_token"))
    sd[f"{b}embeddings.position_embeddings"] = torch.from_numpy(val("backbone/pos_embed"))
    sd[f"{b}embeddings.mask_token"] = torch.from_numpy(val("backbone/mask_token"))
    sd[f"{b}layernorm.weight"] = torch.from_numpy(val("backbone/final_norm/scale"))
    sd[f"{b}layernorm.bias"] = torch.from_numpy(val("backbone/final_norm/bias"))
    layers = {k[len("backbone/layers/"):]: val(k) for k in flat
              if k.startswith("backbone/layers/")}
    names = {"q": "attention.attention.query", "k": "attention.attention.key",
             "v": "attention.attention.value", "attn_out": "attention.output.dense",
             "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    for i in range(layers["ls1"].shape[0]):
        lp = f"{b}encoder.layer.{i}."
        for n, tn in names.items():
            _torch_linear(sd, lp + tn, layers[f"{n}/w"][i], layers[f"{n}/b"][i])
        for n in ("norm1", "norm2"):
            sd[f"{lp}{n}.weight"] = torch.from_numpy(layers[f"{n}/scale"][i])
            sd[f"{lp}{n}.bias"] = torch.from_numpy(layers[f"{n}/bias"][i])
        sd[f"{lp}layer_scale1.lambda1"] = torch.from_numpy(layers["ls1"][i])
        sd[f"{lp}layer_scale2.lambda1"] = torch.from_numpy(layers["ls2"][i])
        if "lora_A" in layers:
            sd[f"lora_layers.{i}.lora_A"] = torch.from_numpy(layers["lora_A"][i])
            sd[f"lora_layers.{i}.lora_B"] = torch.from_numpy(layers["lora_B"][i])
    return sd


def _tiny_pair(use_lora=False, curiosity_guided=True, hierarchical=True):
    arch = ModelArchConfig(num_iterations=2, image_size=56, use_curiosity=True,
                           curiosity_guided=curiosity_guided, use_lora=use_lora,
                           lora_targets=("attn_out", "fc1", "fc2", "qkv"),
                           enable_hierarchical_curiosity=hierarchical)
    jm = JModel(arch, vit_cfg=JD.DinoV2Config(**TINY))
    jflat = j_flatten_tree(jm.init(jax.random.PRNGKey(0)))
    tm = TModel(TCfg.ModelArchConfig(**dataclasses.asdict(arch)),
                vit_cfg=TD.DinoV2Config(**TINY), device="cpu")
    return jflat, tm


@pytest.mark.parametrize("hierarchical", [True, False])
def test_converters_match_jax(hierarchical):
    jflat, _ = _tiny_pair(hierarchical=hierarchical)
    sd = reference_state_dict(jflat, seed=1)
    wrapped = {"model_state_dict": sd}
    assert TCT.unwrap_container(wrapped) is sd
    assert TCT.unwrap_container({"main_model": sd}) is sd
    assert TCT.unwrap_container(sd) is sd
    pairs = [
        (TCT.convert_backbone(sd), JCT.convert_backbone(sd)),
        (TCT.convert_ambient(sd), JCT.convert_ambient(sd)),
        (TCT.convert_iterative_focal(sd), JCT.convert_iterative_focal(sd)),
        (TCT.convert_focal_stream(sd, "focal_stream.focal_streams.1"),
         JCT.convert_focal_stream(sd, "focal_stream.focal_streams.1")),
        (TCT.convert_exif_prior(sd), JCT.convert_exif_prior(sd)),
        (TCT.convert_curiosity(sd), JCT.convert_curiosity(sd)),
        (TCT.convert_heads(sd), JCT.convert_heads(sd)),
    ]
    for t, j in pairs:
        j = j_flatten_tree(j)
        assert set(t) == set(j)
        for k in j:
            assert t[k].shape == j[k].shape, k
            np.testing.assert_array_equal(t[k], j[k])
    kept = TCT.apply_skip_prefixes(sd)
    assert kept == JCT.apply_skip_prefixes(sd) and all(k.startswith("backbone.") for k in kept)


def test_filter_and_merge_counts_match_jax():
    jflat, _ = _tiny_pair()
    rng = np.random.RandomState(3)
    incoming = {k: np.asarray(rng.randn(*v.shape), np.float64) for k, v in jflat.items()}
    incoming["fusion/fc0/w"] = np.zeros((3, 3))  # shape mismatch: skipped
    incoming["not/a/param"] = np.zeros(2)  # unknown key: neither
    del incoming["decision_head/fc0/b"]  # missing: keeps the target's value
    merged, loaded, skipped = TCT.filter_and_merge(jflat, incoming)

    def nest(flat):
        tree = {}
        for key, v in flat.items():
            node = tree
            *mods, leaf = key.split("/")
            for m in mods:
                node = node.setdefault(m, {})
            node[leaf] = v
        return tree

    from cognitive_aim_tpu.api import _intify_lists

    jm, jl, js = JCT.filter_and_merge(_intify_lists(nest(jflat)), _intify_lists(nest(incoming)))
    assert (loaded, skipped) == (jl, js) == (len(jflat) - 2, 1)
    jm = j_flatten_tree(jm)
    for k in jflat:
        assert merged[k].dtype == np.float32
        np.testing.assert_array_equal(merged[k], np.asarray(jm[k]))


@pytest.mark.parametrize("use_lora", [False, True], ids=["no_adapters", "adapters"])
def test_flat_params_is_flatten_tree(use_lora):
    """flat_params gives back exactly the JAX flatten_tree keys, shapes and
    values of the weights load_flat_params took: iterative focal, EXIF and
    curiosity on, with and without adapters on all four targets."""
    jflat, tm = _tiny_pair(use_lora=use_lora)
    load_flat_params(tm, jflat)
    got = flat_params(tm)
    assert set(got) == set(jflat)
    assert any(k.startswith("backbone/layers/lora") for k in got) == use_lora
    for k, v in jflat.items():
        assert got[k].dtype == np.float32 and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v)
    quantised = TModel(tm.arch, INT8_BACKBONE, vit_cfg=tm.vit_cfg, device="cpu")
    load_flat_params(quantised, jflat).prepare_params()
    with pytest.raises(ValueError, match="prepare_params"):
        flat_params(quantised)


def test_parameter_counts():
    jflat, tm = _tiny_pair()
    load_flat_params(tm, jflat)
    n = sum(v.size for v in jflat.values())
    assert TLog.count_parameters(tm) == (n, n) == TLog.count_parameters(jflat)
    assert TLog.get_model_size_mb(tm) == pytest.approx(n * 4 / 2 ** 20)
    assert TLog.get_model_size_mb(jflat) == pytest.approx(n * 4 / 2 ** 20)
