"""Adapters (LoRA), their fold, and the unchained int8 block of the port
against the JAX package.

The same numpy-seeded inputs and the same JAX-initialised weights go through
both packages; ``lora_B``, zero at init, is replaced by seeded non-zero
values on both sides (zeros would hide the whole path). The JAX side runs its
Pallas kernels in interpret mode on the CPU; the port runs on CPU tensors, so
its wrappers take their plain versions (the CUDA kernels are compared with
those on the card, tests/test_torch_cuda.py and chip_smoke.py).

Tolerances, with their reasons:
  * float32 functions on identical inputs (``_lora_delta``, ``_mhsa``, the
    folded weights): summation order only, atol 2e-6 (``_mhsa``, two
    projections and a softmax deep: 5e-6).
  * float32 backbone: atol 2e-5 / rtol 1e-4, as tests/test_torch_model.py.
  * fold against runtime adapters, float32: x (W + dW)^T and x W^T + x dW^T
    round differently, 1e-6 relative per product; atol 5e-5 on O(1) outputs.
  * bfloat16 backbone, and the int8 backbone (unchained block): the bf16 steps
    round at other places in the two frameworks; atol 2e-2 / rtol 5e-2, the
    tolerance of the chained block's test in tests/test_torch_model.py.
  * whole model: float32 atol 2e-6 / rtol 1e-5; bfloat16 and int8 atol 1e-2.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from cognitive_aim_tpu.api import flatten_tree
from cognitive_aim_tpu.core import precision as JP
from cognitive_aim_tpu.core.rng import NoiseMode as JNoise
from cognitive_aim_tpu.kernels.int8_ops import quantize_backbone_layers
from cognitive_aim_tpu.models import guidance as JG
from cognitive_aim_tpu.models.cognitive_aim import CognitiveAimModel as JModel
from cognitive_aim_tpu.models.config import ModelArchConfig
from cognitive_aim_tpu.nn import dinov2 as JD
from cognitive_aim_tpu_torch.convert import load_flat_params
from cognitive_aim_tpu_torch.core import precision as TP
from cognitive_aim_tpu_torch.core.rng import NoiseMode
from cognitive_aim_tpu_torch.kernels import int8_gemm as TIG
from cognitive_aim_tpu_torch.models import config as TCfg
from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel as TModel
from cognitive_aim_tpu_torch.nn import dinov2 as TD

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# ViT: hidden 128 as 2 heads of 64 (the kernels' head width), 2 layers; a
# 70x70 image is a 5x5 grid (25 patch tokens) against the 4x4 pretrain grid
VIT = dict(hidden_size=128, num_layers=2, num_heads=2, patch_size=14,
           pretrain_image_size=56)
IMG = 70
ALL_TARGETS = ("qkv", "attn_out", "fc1", "fc2")
LORA = dict(use_lora=True, lora_rank=4, lora_alpha=8, lora_targets=ALL_TARGETS)

FN_TOL = dict(atol=2e-6, rtol=1e-5)
F32_BACKBONE_TOL = dict(atol=2e-5, rtol=1e-4)
FOLD_TOL = dict(atol=5e-5, rtol=1e-4)
BF16_BACKBONE_TOL = dict(atol=2e-2, rtol=5e-2)
F32_TOL = dict(atol=2e-6, rtol=1e-5)
BF16_TOL = dict(atol=1e-2, rtol=0.0)


@pytest.fixture(autouse=True, scope="module")
def _no_grad():
    """The model's forward is differentiable since the port trains; these
    inference tests run under torch.no_grad(), as the engine serves."""
    with torch.no_grad():
        yield


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: PyTorch's intra-op thread pool, sharing the
    cores with XLA's, costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pallas_interpret(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _images(B, seed=0):
    return np.random.RandomState(seed).randn(B, IMG, IMG, 3).astype(np.float32)


def _live_b(layers, seed=11):
    """The layer tree with every ``lora*_B`` leaf (zeros at init) replaced by
    seeded values of the size of a trained adapter's."""
    rng = np.random.RandomState(seed)
    out = dict(layers)
    for name in sorted(layers):
        if name.startswith("lora") and name.endswith("_B"):
            out[name] = jnp.asarray(
                (rng.randn(*layers[name].shape) * 0.05).astype(np.float32))
    return out


class _Wrap(torch.nn.Module):
    """``load_flat_params`` addresses the backbone as ``model.backbone``."""

    def __init__(self, backbone):
        super().__init__()
        self.backbone = backbone


def _load_backbone(params, **cfg_kw):
    model = TD.DinoV2(TD.DinoV2Config(**VIT, **cfg_kw), device="cpu")
    load_flat_params(_Wrap(model),
                     {f"backbone/{k}": v for k, v in flatten_tree(params).items()})
    return model


@functools.lru_cache(maxsize=None)
def _jax_backbone_params(targets=ALL_TARGETS):
    jcfg = JD.DinoV2Config(**VIT, **{**LORA, "lora_targets": targets})
    params = JD.init(jax.random.PRNGKey(3), jcfg)
    params["layers"] = _live_b(params["layers"])
    return params


def _backbone(gelu=True, targets=ALL_TARGETS, use_lora=True):
    """(JAX cfg, JAX params with live adapters, a fresh float32 port backbone
    carrying them)."""
    kw = dict(LORA, lora_targets=targets, use_lora=use_lora, gelu_approx=gelu)
    params = _jax_backbone_params(targets)
    return JD.DinoV2Config(**VIT, **kw), params, _load_backbone(params, **kw)


def _layer(params, i):
    return jax.tree.map(lambda a: a[i], params["layers"])


def _tokens(seed, B=2, N=26, D=VIT["hidden_size"]):
    return np.random.RandomState(seed).randn(B, N, D).astype(np.float32)


# ------------------------------------------------------------ functions ----
@pytest.mark.parametrize("target", ["qkv", "fc1", "fc2"])
def test_lora_delta_matches_jax(target):
    jcfg, params, model = _backbone()
    D = VIT["hidden_size"]
    x = _tokens(1, D=4 * D if target == "fc2" else D)
    want = JD._lora_delta(_layer(params, 1), target, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got = model.layers[1]._lora_delta(target, torch.from_numpy(x))
    assert got.shape == (2, 26, {"qkv": 3 * D, "fc1": 4 * D, "fc2": D}[target])
    assert float(got.abs().max()) > 1e-4  # lora_B is live
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)


def test_lora_delta_is_gated_by_use_lora_and_by_presence():
    _, _, off = _backbone(use_lora=False)
    x = torch.from_numpy(_tokens(2))
    assert off.layers[0].has_adapters and not off.layers[0].live_adapters
    assert off.layers[0]._lora_delta("qkv", x) is None
    _, _, only_out = _backbone(targets=("attn_out",))
    assert only_out.layers[0]._lora_delta("fc1", x) is None
    assert only_out.layers[0].adapter("attn_out")[0].shape == (4, VIT["hidden_size"])


@pytest.mark.parametrize("impl", ["pallas_packed", "plain", "pallas", "plain_heads"])
def test_mhsa_with_adapters_matches_jax(impl):
    """The qkv adapter joins the projection, the attn_out adapter reads the
    attention context; on both layouts."""
    jcfg, params, model = _backbone()
    x = _tokens(3)
    want = JD._mhsa(_layer(params, 0), jnp.asarray(x), jcfg, "xla")
    with torch.no_grad():
        got = model.layers[0].mhsa(torch.from_numpy(x), impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-6, rtol=1e-5)


# ----------------------------------------------------------------- fold ----
def test_merge_lora_matches_jax():
    jcfg, params, model = _backbone()
    scaling = LORA["lora_alpha"] / LORA["lora_rank"]
    want = JD.merge_lora(params, scaling)["layers"]
    assert not any(k.startswith("lora") for k in want)
    assert TD.merge_lora(model, scaling) is model
    D = VIT["hidden_size"]
    for i, blk in enumerate(model.layers):
        assert not blk.has_adapters and not hasattr(blk, "lora_qkv_A")
        qkv = np.concatenate([np.asarray(want[n]["w"][i]).T for n in ("q", "k", "v")], 0)
        np.testing.assert_allclose(blk.qkv.weight.detach().numpy(), qkv, **FN_TOL)
        assert blk.qkv.weight.shape == (3 * D, D)
        for name in ("attn_out", "fc1", "fc2"):
            np.testing.assert_allclose(getattr(blk, name).weight.detach().numpy(),
                                       np.asarray(want[name]["w"][i]).T, **FN_TOL)
    # the fold moved the weights
    assert not np.allclose(model.layers[0].fc1.weight.detach().numpy(),
                           np.asarray(params["layers"]["fc1"]["w"][0]).T, atol=1e-4)


def test_merge_lora_without_adapters_is_a_no_op():
    plain = JD.init(jax.random.PRNGKey(3), JD.DinoV2Config(**VIT))
    model = _load_backbone(plain)
    before = model.layers[0].qkv.weight.detach().clone()
    TD.merge_lora(model, 2.0)
    assert torch.equal(model.layers[0].qkv.weight, before)
    assert JD.merge_lora(plain, 2.0) is plain


@pytest.mark.parametrize("gelu", [False, True], ids=["erf", "tanh"])
def test_folded_backbone_equals_runtime_adapters(gelu):
    jcfg, params, model = _backbone(gelu=gelu)
    x = _images(2, seed=4)
    want = JD.apply(params, jnp.asarray(x), jcfg, attn_impl="xla")
    with_adapters = model(torch.from_numpy(x))
    np.testing.assert_allclose(with_adapters.numpy(), np.asarray(want), **F32_BACKBONE_TOL)
    TD.merge_lora(model, LORA["lora_alpha"] / LORA["lora_rank"])
    folded = model(torch.from_numpy(x))
    np.testing.assert_allclose(folded.numpy(), with_adapters.numpy(), **FOLD_TOL)
    # and the adapters did something
    _, _, off = _backbone(gelu=gelu, use_lora=False)
    assert float((off(torch.from_numpy(x)) - with_adapters).abs().max()) > 1e-3


def test_adapters_are_ignored_without_use_lora():
    """The exact path of the adapter-gated sandwich: a model built without
    ``use_lora`` gives, on a tree that holds adapters, the bits it gives on
    the tree without them; as the JAX package does."""
    jcfg, params, off = _backbone(use_lora=False)
    bare = dict(params, layers={k: v for k, v in params["layers"].items()
                                if not k.startswith("lora")})
    x = _images(2, seed=5)
    assert torch.equal(off(torch.from_numpy(x)),
                       _load_backbone(bare, gelu_approx=True)(torch.from_numpy(x)))
    want = JD.apply(params, jnp.asarray(x), jcfg, attn_impl="xla")
    np.testing.assert_array_equal(
        np.asarray(want), np.asarray(JD.apply(bare, jnp.asarray(x), jcfg, attn_impl="xla")))
    np.testing.assert_allclose(off(torch.from_numpy(x)).numpy(), np.asarray(want),
                               **F32_BACKBONE_TOL)


# -------------------------------------------------------------- convert ----
def test_convert_carries_adapters_untransposed():
    _, params, model = _backbone()
    jl = params["layers"]
    for i, blk in enumerate(model.layers):
        for target in ALL_TARGETS:
            a_name, b_name = TD.adapter_names(target)
            a, b = blk.adapter(target)
            np.testing.assert_array_equal(a.detach().numpy(), np.asarray(jl[a_name][i]))
            np.testing.assert_array_equal(b.detach().numpy(), np.asarray(jl[b_name][i]))
    assert model.layers[0].lora_A.shape == (4, 128)
    assert model.layers[0].lora_qkv_B.shape == (384, 4)
    assert model.layers[0].lora_fc2_A.shape == (4, 512)


def test_convert_raises_on_a_missing_half_and_on_a_wrong_rank():
    _, params, _ = _backbone()
    flat = {f"backbone/{k}": v for k, v in flatten_tree(params).items()}
    half = {k: v for k, v in flat.items() if k != "backbone/layers/lora_fc1_B"}
    with pytest.raises(ValueError, match="unset"):
        load_flat_params(_Wrap(TD.DinoV2(TD.DinoV2Config(**VIT, **LORA), device="cpu")), half)
    wrong = TD.DinoV2(TD.DinoV2Config(**VIT, **{**LORA, "lora_rank": 8}), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        load_flat_params(_Wrap(wrong), flat)


# ----------------------------------------------------------- block rule ----
BLOCK_RULE = {
    # name: (tanh GELU, use_lora, fold first, quantise, attn_impl, chained?)
    "int8_tanh": (True, False, False, True, "pallas_packed", True),
    "int8_tanh_plain_route": (True, False, False, True, "plain_i8qk", True),
    "int8_erf": (False, False, False, True, "pallas_packed", False),
    "int8_tanh_live_adapters": (True, True, False, True, "pallas_packed", False),
    "int8_tanh_adapters_gated_off": (True, False, False, True, "pallas_packed", True),
    "int8_tanh_folded": (True, True, True, True, "pallas_packed_i8qk", True),
    "int8_tanh_heads_route": (True, False, False, True, "pallas", False),
    "float_tanh": (True, False, False, False, "pallas_packed", False),
}


@pytest.mark.parametrize("case", list(BLOCK_RULE))
def test_block_rule(case, monkeypatch):
    """The JAX package's rule: the chained block only when quantised, on a
    packed route, with tanh GELU and no live adapters."""
    gelu, use_lora, fold, quantise, impl, chained = BLOCK_RULE[case]
    _, _, model = _backbone(gelu=gelu, use_lora=use_lora)
    blk = model.layers[0]
    assert blk.has_adapters  # every case holds adapter tensors at first
    if fold:
        blk.merge_lora_(2.0)
    if quantise:
        blk.quantize_(torch.bfloat16)
    assert blk.chained(impl) is chained
    taken = []
    monkeypatch.setattr(TD.Block, "_forward_int8",
                        lambda self, x, *a: taken.append("chained") or x)
    monkeypatch.setattr(TD.Block, "mhsa",
                        lambda self, x, *a: taken.append("unchained") or x)
    dt = torch.bfloat16 if quantise else torch.float32
    blk(torch.from_numpy(_tokens(6)).to(dt), impl)
    assert taken == ["chained" if chained else "unchained"]


def test_fold_after_quantisation_raises():
    _, _, model = _backbone()
    blk = model.layers[0].quantize_(torch.bfloat16)
    assert blk.lora_A.dtype == torch.bfloat16  # adapters stay float, in the compute dtype
    with pytest.raises(RuntimeError, match="before the weights are quantised"):
        blk.merge_lora_(2.0)


# ------------------------------------------------- backbone against JAX ----
def _jax_quantised(params):
    out = dict(params)
    out["layers"] = quantize_backbone_layers(params["layers"])
    return out


UNCHAINED = {
    # name: (tanh GELU, use_lora)
    "erf": (False, False),
    "adapters": (True, True),
    "erf_adapters": (False, True),
}


@pytest.mark.parametrize("case", list(UNCHAINED))
def test_unchained_int8_backbone_matches_jax(case, pallas_interpret, monkeypatch):
    """Quantised, ``pallas_packed``, but erf GELU or live adapters: both
    packages run the unchained block, q, k, v through K15."""
    gelu, use_lora = UNCHAINED[case]
    jcfg, params, model = _backbone(gelu=gelu, use_lora=use_lora)
    for blk in model.layers:
        blk.quantize_(torch.bfloat16)
    model.patch_embed.to(torch.bfloat16), model.final_norm.to(torch.bfloat16)
    k15 = []
    orig = TIG.int8_linear_fused
    monkeypatch.setattr(TIG, "int8_linear_fused",
                        lambda x, *a, **kw: k15.append(tuple(x.shape)) or orig(x, *a, **kw))
    x = _images(2, seed=7)
    want = JD.apply(_jax_quantised(params), jnp.asarray(x), jcfg,
                    compute_dtype=jnp.bfloat16, attn_impl="pallas_packed")
    got = model(torch.from_numpy(x), compute_dtype=torch.bfloat16, attn_impl="pallas_packed")
    assert got.dtype == torch.bfloat16
    assert k15 == [(2, 26, 128)] * 2 and not model.layers[0].chained("pallas_packed")
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **BF16_BACKBONE_TOL)


@pytest.mark.parametrize("impl", ["pallas", "plain_heads"])
def test_unchained_int8_heads_route_matches_jax(impl):
    """On the [B, N, H, Dh] routes q, k, v come from ``int8_ops.int8_linear``
    on the fused weight: the values of the JAX package's three prequantised
    projections."""
    jcfg, params, model = _backbone()
    for blk in model.layers:
        blk.quantize_(torch.bfloat16)
    model.patch_embed.to(torch.bfloat16), model.final_norm.to(torch.bfloat16)
    x = _images(2, seed=8)
    want = JD.apply(_jax_quantised(params), jnp.asarray(x), jcfg,
                    compute_dtype=jnp.bfloat16, attn_impl="xla")
    got = model(torch.from_numpy(x), compute_dtype=torch.bfloat16, attn_impl=impl)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **BF16_BACKBONE_TOL)


@pytest.mark.parametrize("impl", ["pallas", "pallas_packed"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_float_backbone_with_adapters_matches_jax(dtype, impl):
    jcfg, params, model = _backbone()
    x = _images(2, seed=9)
    want = JD.apply(params, jnp.asarray(x), jcfg, compute_dtype=getattr(jnp, dtype),
                    attn_impl="xla")
    got = model(torch.from_numpy(x), compute_dtype=getattr(torch, dtype), attn_impl=impl)
    tol = F32_BACKBONE_TOL if dtype == "float32" else BF16_BACKBONE_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)


def test_heads_route_with_a_key_bias_takes_the_plain_biased_attention(monkeypatch):
    """``attn_impl="pallas"`` with a key bias: the JAX package takes its XLA
    attention there, the port the plain biased attention; K8 is not called."""
    _, _, model = _backbone()
    called = []
    monkeypatch.setattr(TD.FA, "flash_attention",
                        lambda *a: called.append("K8") or TD.FA.attention_reference(*a))
    x = torch.from_numpy(_images(1, seed=10))
    biased = model(x, attn_impl="pallas", filter_layer=1, filter_keep=0.5,
                   filter_prop_attn=True)
    assert called == ["K8"]  # the one block before the filter point
    packed = model(x, attn_impl="pallas_packed", filter_layer=1, filter_keep=0.5,
                   filter_prop_attn=True)
    torch.testing.assert_close(biased, packed, atol=2e-5, rtol=1e-4)


# ----------------------------------------------------------- whole model ----
MODEL_CASES = {
    # name: (JAX policy, port policy, JAX attn_impl, port attn_impl, tolerance)
    "f32": (JP.Policy(backbone_compute_dtype=jnp.float32),
            TP.Policy(backbone_compute_dtype=torch.float32), "xla", "pallas_packed", F32_TOL),
    "f32_heads": (JP.STRICT_F32, TP.STRICT_F32, "xla", "pallas", F32_TOL),
    "bf16": (JP.DEFAULT_POLICY, TP.DEFAULT_POLICY, "xla", "pallas_packed", BF16_TOL),
    "int8": (JP.INT8_BACKBONE, TP.INT8_BACKBONE, "pallas_packed", "pallas_packed", BF16_TOL),
    "int8_erf": (dataclasses.replace(JP.INT8_BACKBONE, fast_gelu=False),
                 dataclasses.replace(TP.INT8_BACKBONE, fast_gelu=False), "pallas_packed",
                 "pallas_packed", BF16_TOL),
}
LORA_ARCH = dict(use_lora=True, lora_rank=4, lora_alpha=8, lora_targets=ALL_TARGETS)


@functools.lru_cache(maxsize=None)
def _model_params(arch):
    jm = JModel(arch, vit_cfg=JD.DinoV2Config(**VIT))
    params = jm.init(jax.random.PRNGKey(0))
    params["backbone"]["layers"] = _live_b(params["backbone"]["layers"])
    return params, flatten_tree(params)


def _model_pair(case, fold=False, **arch_kw):
    jp, tp, jimpl, timpl, _ = MODEL_CASES[case]
    arch = ModelArchConfig(num_iterations=2, image_size=IMG, **{**LORA_ARCH, **arch_kw})
    params, flat = _model_params(arch)
    # the explicit vit_cfg carries no adapter settings: the arch's must win
    jm = JModel(arch, policy=jp, vit_cfg=JD.DinoV2Config(**VIT, gelu_approx=jp.fast_gelu))
    jm.attn_impl = jimpl  # the constructor falls back to "xla" off the TPU
    tm = TModel(TCfg.ModelArchConfig(**dataclasses.asdict(arch)), policy=tp, attn_impl=timpl,
                device="cpu", vit_cfg=TD.DinoV2Config(**VIT, gelu_approx=tp.fast_gelu))
    load_flat_params(tm, flat)
    if fold:
        params = jm.merge_lora_params(params)
        tm.merge_lora_params()
    return jm, jm.prepare_params(params), tm.prepare_params()


@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_model_with_adapters_matches_jax_unguided_and_all_instructions(case,
                                                                       pallas_interpret):
    jm, params, tm = _model_pair(case)
    assert tm.vit_cfg.use_lora and tm.vit_cfg.lora_targets == ALL_TARGETS
    assert all(blk.live_adapters for blk in tm.backbone.layers)
    tol = MODEL_CASES[case][4]
    n = len(JG.INSTRUCTIONS)
    x = _images(n, seed=12)
    fwd = jax.jit(lambda p, im, gi: jm.apply(p, im, None, noise_mode=JNoise.ZEROS,
                                             guidance=gi))
    for guidance in (None, np.arange(n, dtype=np.int32)):
        want = fwd(params, jnp.asarray(x), None if guidance is None else jnp.asarray(guidance))
        got = tm(torch.from_numpy(x), None, noise_mode=NoiseMode.ZEROS,
                 guidance=None if guidance is None else torch.from_numpy(guidance))
        for field in ("depth", "confidence", "attention"):
            np.testing.assert_allclose(
                getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                err_msg=f"{case} {field} guided={guidance is not None}", **tol)


@pytest.mark.parametrize("case", ["f32", "int8"])
def test_folded_model_matches_jax_and_its_runtime_adapters(case, pallas_interpret):
    """``merge_lora_params`` then ``prepare_params``: under int8 the folded
    model is chained again; it answers as the JAX package's folded model,
    and as its own runtime adapters up to the fold's rounding."""
    jm, params, tm = _model_pair(case, fold=True, token_filter_layer=1,
                                 token_filter_keep=0.5)
    assert not any(blk.has_adapters for blk in tm.backbone.layers)
    assert all(blk.chained("pallas_packed") for blk in tm.backbone.layers) == (case == "int8")
    x = _images(3, seed=13)
    g = np.asarray([0, 4, 8], np.int32)
    want = jax.jit(lambda p, im, gi: jm.apply(p, im, None, noise_mode=JNoise.ZEROS,
                                              guidance=gi))(params, jnp.asarray(x),
                                                            jnp.asarray(g))
    got = tm(torch.from_numpy(x), None, noise_mode=NoiseMode.ZEROS,
             guidance=torch.from_numpy(g))
    tol = MODEL_CASES[case][4]
    for field in ("depth", "confidence"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)), **tol)
    _, _, runtime = _model_pair(case, token_filter_layer=1, token_filter_keep=0.5)
    live = runtime(torch.from_numpy(x), None, noise_mode=NoiseMode.ZEROS,
                   guidance=torch.from_numpy(g))
    np.testing.assert_allclose(got.depth.numpy(), live.depth.numpy(),
                               **(FOLD_TOL if case == "f32" else BF16_TOL))


def test_merge_lora_params_without_use_lora_takes_rank_and_alpha():
    """A deployment model built without ``use_lora`` holds the tree's adapters,
    ignores them, and folds them with the rank and alpha it is given."""
    arch = ModelArchConfig(num_iterations=2, image_size=IMG, **LORA_ARCH)
    _, flat = _model_params(arch)
    off_arch = TCfg.ModelArchConfig(num_iterations=2, image_size=IMG)
    vit = TD.DinoV2Config(**VIT, gelu_approx=True)
    x = torch.from_numpy(_images(2, seed=14))

    def build(a):
        return load_flat_params(
            TModel(a, policy=TP.Policy(backbone_compute_dtype=torch.float32),
                   device="cpu", vit_cfg=vit), flat)

    off, on = build(off_arch), build(TCfg.ModelArchConfig(**dataclasses.asdict(arch)))
    assert not off.vit_cfg.use_lora and off.backbone.layers[0].has_adapters
    exact = off(x, noise_mode=NoiseMode.ZEROS).depth
    live = on(x, noise_mode=NoiseMode.ZEROS).depth
    assert float((exact - live).abs().max()) > 1e-5
    assert off.merge_lora_params(rank=4, alpha=8) is off
    assert not off.backbone.layers[0].has_adapters
    torch.testing.assert_close(off(x, noise_mode=NoiseMode.ZEROS).depth, live, **FOLD_TOL)
    assert off.merge_lora_params() is off  # nothing left to fold


def test_merge_lora_params_raises_on_a_rank_of_zero():
    """The JAX package divides alpha by a rank that can resolve to 0; the
    port raises and names what it resolved."""
    arch = ModelArchConfig(num_iterations=2, image_size=IMG, **LORA_ARCH)
    _, flat = _model_params(arch)
    tm = TModel(TCfg.ModelArchConfig(num_iterations=2, image_size=IMG, lora_rank=0,
                                     lora_alpha=8),
                device="cpu", vit_cfg=TD.DinoV2Config(**VIT))
    load_flat_params(tm, flat)
    with pytest.raises(ValueError, match="rank resolved to 0 .alpha 8"):
        tm.merge_lora_params()
    tm.merge_lora_params(rank=4)  # an explicit rank folds
    assert not tm.backbone.layers[0].has_adapters


@pytest.mark.parametrize("path", ["configs/experiment_B.yaml",
                                  "eval_configs/full_cognitive_config.yaml"])
def test_model_builds_from_the_repository_configs_with_use_lora(path):
    root = __file__.rsplit("/tests/", 1)[0]
    with open(f"{root}/{path}") as f:
        raw = yaml.safe_load(f)
    arch = TCfg.resolve_model_config(raw, lookup="nested")  # model.use_lora: true
    assert arch.use_lora
    tm = TModel(arch, device="cpu")  # the full width, parameters left uninitialised
    assert tm.vit_cfg.use_lora and tm.vit_cfg.lora_rank == arch.lora_rank
    blk = tm.backbone.layers[-1]
    assert blk.lora_A.shape == (arch.lora_rank, tm.vit_cfg.hidden_size)
    assert blk.lora_B.shape == (tm.vit_cfg.hidden_size, arch.lora_rank)


def test_quantised_erf_policy_builds_and_serves():
    policy = dataclasses.replace(TP.INT8_BACKBONE, fast_gelu=False)
    arch = TCfg.ModelArchConfig(num_iterations=2, image_size=IMG)
    tm = TModel(arch, policy=policy, device="cpu", vit_cfg=TD.DinoV2Config(**VIT))
    tm.init(torch.Generator().manual_seed(0)).prepare_params()
    out = tm(torch.from_numpy(_images(2, seed=15)), guidance=torch.tensor([1, 2]),
             noise_mode=NoiseMode.ZEROS)
    assert out.depth.shape == (2, 1) and bool(torch.isfinite(out.depth).all())
    assert not tm.backbone.layers[0].chained("pallas_packed")


def test_init_draws_a_small_and_zeroes_b():
    model = TD.DinoV2(TD.DinoV2Config(**VIT, **LORA), device="cpu")
    model.init(torch.Generator().manual_seed(0))
    blk = model.layers[1]
    for target in ALL_TARGETS:
        a, b = blk.adapter(target)
        assert 0.005 < float(a.detach().std()) < 0.02 and float(b.detach().abs().max()) == 0.0
    # with B zero the adapters change nothing
    x = torch.from_numpy(_images(1, seed=16))
    off = TD.DinoV2(TD.DinoV2Config(**VIT), device="cpu")
    off.load_state_dict({k: v for k, v in model.state_dict().items() if "lora" not in k})
    assert torch.equal(model(x), off(x))
