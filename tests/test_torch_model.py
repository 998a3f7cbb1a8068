"""The port against the JAX package, module by module and end to end.

Weights come from the JAX package's own init, carried across with
``convert.load_flat_params``; inputs come from a numpy seed and reach both
sides as numpy arrays. JAX runs its XLA path on the CPU (the conftest pins
the highest matmul precision); the port runs on CPU tensors, so its kernel
wrappers take their plain versions. TF32 is off on the torch side.

Tolerances, with their reasons:
  * float32, both policies (erf and tanh GELU): the two frameworks differ
    only in summation order, ~1e-7 here. The guided softmax at temperature
    0.05 multiplies logit differences by 20, so the attention tolerance is
    20x the float32 rounding of its inputs: atol 2e-6, rtol 1e-5.
  * bfloat16 (default policy): both sides round the backbone and focal
    activations to bf16 (8 bits of mantissa, 4e-3 relative) but at other
    places (layernorm statistics, bias adds, the attention's score type);
    a few rounding steps through two blocks give ~1.5e-3 in depth and
    attention here: atol 1e-2.
  * int8 policy: the JAX package runs its chained int8 block (Pallas, in
    interpret mode), the port the plain versions of the same kernels. The
    int8 GEMMs agree to rounding; the bf16 steps between them (attention,
    residual stream) round at other places, as under the default policy:
    backbone output atol 2e-2 / rtol 5e-2, the tolerance of the JAX
    package's own chained-against-XLA test; depth, confidence and attention
    atol 1e-2, as under the default policy.

Every module of the port is built with ``device="cpu"``: without it the
port builds on the CUDA device and raises where there is none.
"""

import dataclasses
import functools
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cognitive_aim_tpu.api import flatten_tree
from cognitive_aim_tpu.core import precision as JP
from cognitive_aim_tpu.core.rng import NoiseMode as JNoise
from cognitive_aim_tpu.io import preprocess as JPre
from cognitive_aim_tpu.models import curiosity as JC
from cognitive_aim_tpu.models import guidance as JG
from cognitive_aim_tpu.models import streams as JS
from cognitive_aim_tpu.models.cognitive_aim import CognitiveAimModel as JModel
from cognitive_aim_tpu.models import config as JCfg
from cognitive_aim_tpu.models.config import ModelArchConfig
from cognitive_aim_tpu.nn import dinov2 as JD
from cognitive_aim_tpu.nn import layers as JL
from cognitive_aim_tpu.nn import torch_interp as JI
from cognitive_aim_tpu_torch.convert import load_flat_params
from cognitive_aim_tpu_torch.core import precision as TP
from cognitive_aim_tpu_torch.core.rng import NoiseMode, normal_like
from cognitive_aim_tpu_torch.io import preprocess as TPre
from cognitive_aim_tpu_torch.models import curiosity as TC
from cognitive_aim_tpu_torch.models import guidance as TG
from cognitive_aim_tpu_torch.models import config as TCfg
from cognitive_aim_tpu_torch.models import streams as TS
from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel as TModel
from cognitive_aim_tpu_torch.nn import dinov2 as TD
from cognitive_aim_tpu_torch.nn import layers as TL
from cognitive_aim_tpu_torch.nn import torch_interp as TI

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# tiny ViT: hidden 64, 2 layers, 4 heads; a 70x70 image is a 5x5 grid
# against the 4x4 pretrain grid, so the bicubic pos-embed path runs
TINY = dict(hidden_size=64, num_layers=2, num_heads=4, patch_size=14,
            pretrain_image_size=56)
IMG = 70

F32_TOL = dict(atol=2e-6, rtol=1e-5)
BF16_TOL = dict(atol=1e-2, rtol=0.0)

POLICIES = {
    # name: (JAX policy, port policy, tanh GELU, tolerance)
    "strict_f32_erf": (JP.STRICT_F32, TP.STRICT_F32, False, F32_TOL),
    "f32_tanh": (JP.Policy(backbone_compute_dtype=jnp.float32),
                 TP.Policy(backbone_compute_dtype=torch.float32), True, F32_TOL),
    "bf16_default": (JP.DEFAULT_POLICY, TP.DEFAULT_POLICY, True, BF16_TOL),
}
INT8_BACKBONE_TOL = dict(atol=2e-2, rtol=5e-2)


@pytest.fixture(autouse=True, scope="module")
def _no_grad():
    """The model's forward is differentiable since the port trains; these
    inference tests run under torch.no_grad(), as the engine serves."""
    with torch.no_grad():
        yield


def _tarch(arch: ModelArchConfig) -> TCfg.ModelArchConfig:
    """The port's own config class with the same field values."""
    return TCfg.ModelArchConfig(**dataclasses.asdict(arch))


def _images(B, seed=0):
    return np.random.RandomState(seed).randn(B, IMG, IMG, 3).astype(np.float32)


def _exif(B):
    return {"camera_idx": np.arange(B, dtype=np.int32) % 5,
            "focal_length": np.linspace(0.1, 0.9, B).astype(np.float32),
            "aperture": np.full(B, 0.127, np.float32),
            "iso": np.full(B, 0.016, np.float32)}


@functools.lru_cache(maxsize=None)
def _jax_params(arch: ModelArchConfig):
    """JAX init once per arch (the init does not depend on the policy);
    tests only read the result."""
    jm = JModel(arch, vit_cfg=JD.DinoV2Config(**TINY))
    params = jm.init(jax.random.PRNGKey(0))
    return params, flatten_tree(params)


def _pair(policy_name, arch=None):
    jp, tp, gelu, _ = POLICIES[policy_name]
    arch = arch or ModelArchConfig(num_iterations=2, image_size=IMG)
    jm = JModel(arch, policy=jp, attn_impl="xla",
                vit_cfg=JD.DinoV2Config(**TINY, gelu_approx=gelu))
    params, flat = _jax_params(arch)
    tm = TModel(_tarch(arch), policy=tp, device="cpu",
                vit_cfg=TD.DinoV2Config(**TINY, gelu_approx=gelu))
    load_flat_params(tm, flat)
    return jm, params, tm


# --------------------------------------------------------------- dinov2 ----
@pytest.mark.parametrize("gelu", [False, True])
def test_dinov2_matches_jax(gelu):
    jcfg = JD.DinoV2Config(**TINY, gelu_approx=gelu)
    params = JD.init(jax.random.PRNGKey(1), jcfg)
    x = _images(2, seed=1)
    want = JD.apply(params, jnp.asarray(x), jcfg, attn_impl="xla")
    model = TD.DinoV2(TD.DinoV2Config(**TINY, gelu_approx=gelu), device="cpu")
    flat = {f"backbone/{k}": v for k, v in flatten_tree(params).items()}

    class Wrap(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.backbone = model

    load_flat_params(Wrap(), flat)
    for impl in ("pallas_packed", "plain"):
        got = model(torch.from_numpy(x), compute_dtype=torch.float32, attn_impl=impl)
        assert got.shape == (2, 1 + (IMG // 14) ** 2, 64)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


def test_dinov2_runs_in_the_compute_dtype():
    """The default policy's backbone stays bf16 end to end (no silent
    promotion to the f32 parameters)."""
    model = TD.DinoV2(TD.DinoV2Config(**TINY), device="cpu").init(torch.Generator().manual_seed(0))
    out = model(torch.from_numpy(_images(1)), compute_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16


def test_pos_embed_skips_at_the_pretrain_grid():
    model = TD.DinoV2(TD.DinoV2Config(**TINY), device="cpu").init(torch.Generator().manual_seed(0))
    assert model.interpolate_pos_embed(4, 4) is model.pos_embed
    assert model.interpolate_pos_embed(5, 5).shape == (1, 26, 64)


# ---------------------------------------------------------- whole model ----
@pytest.mark.parametrize("policy", list(POLICIES))
def test_model_matches_jax_unguided_and_all_instructions(policy):
    jm, params, tm = _pair(policy)
    tol = POLICIES[policy][3]
    n = len(JG.INSTRUCTIONS)
    x, exif = _images(n), _exif(n)
    jx = jnp.asarray(x)
    jexif = {k: jnp.asarray(v) for k, v in exif.items()}
    texif = {k: torch.from_numpy(v) for k, v in exif.items()}
    for guidance in (None, np.arange(n, dtype=np.int32)):
        want = jm.apply(params, jx, jexif, noise_mode=JNoise.ZEROS,
                        guidance=None if guidance is None else jnp.asarray(guidance))
        got = tm(torch.from_numpy(x), texif, noise_mode=NoiseMode.ZEROS,
                 guidance=None if guidance is None else torch.from_numpy(guidance))
        for field in ("depth", "confidence", "attention"):
            np.testing.assert_allclose(
                getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                err_msg=f"{policy} {field} guided={guidance is not None}", **tol)


def test_model_matches_jax_single_instruction_and_no_exif():
    """A scalar instruction index broadcasts over the batch; without exif
    the fusion input is zero-padded to 192."""
    jm, params, tm = _pair("strict_f32_erf")
    x = _images(3, seed=2)
    want = jm.apply(params, jnp.asarray(x), None, guidance=7, noise_mode=JNoise.ZEROS)
    got = tm(torch.from_numpy(x), None, guidance=7, noise_mode=NoiseMode.ZEROS)
    for field in ("depth", "confidence", "attention", "fused_features"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)), **F32_TOL)


def test_model_matches_jax_curiosity_guided():
    """curiosity_guided adds the focal modulators and the iteration
    amplifier (parameters the default arch does not have)."""
    arch = ModelArchConfig(num_iterations=2, image_size=IMG, curiosity_guided=True)
    jm, params, tm = _pair("strict_f32_erf", arch=arch)
    x, exif = _images(2, seed=3), _exif(2)
    want = jm.apply(params, jnp.asarray(x), {k: jnp.asarray(v) for k, v in exif.items()},
                    guidance=jnp.asarray([1, 8]), noise_mode=JNoise.ZEROS)
    got = tm(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in exif.items()},
             guidance=torch.tensor([1, 8]), noise_mode=NoiseMode.ZEROS)
    for field in ("depth", "confidence", "attention", "curiosity"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)), **F32_TOL)


@pytest.mark.parametrize("use_focal,use_iterative", [(True, True), (True, False),
                                                     (False, True)])
def test_attention_entropy_matches_jax(use_focal, use_iterative):
    """``aux["attention_entropy"]``: present, 0-d and 0.0 exactly where the
    JAX ``apply`` sets it at inference (the focal stream on, guided or not),
    absent with the focal stream off."""
    arch = ModelArchConfig(num_iterations=2, image_size=IMG, use_focal=use_focal,
                           use_iterative=use_iterative)
    jm, params, tm = _pair("strict_f32_erf", arch=arch)
    x = _images(2, seed=4)
    for guidance in (None, np.array([2, 5], dtype=np.int32)):
        want = jm.apply(params, jnp.asarray(x), None, noise_mode=JNoise.ZEROS,
                        guidance=None if guidance is None else jnp.asarray(guidance))
        got = tm(torch.from_numpy(x), None, noise_mode=NoiseMode.ZEROS,
                 guidance=None if guidance is None else torch.from_numpy(guidance))
        assert ("attention_entropy" in got.aux) == ("attention_entropy" in want.aux) \
            == use_focal
        if use_focal:
            ent, jent = got.aux["attention_entropy"], np.asarray(want.aux["attention_entropy"])
            assert ent.shape == () == jent.shape and ent.dtype == torch.float32
            assert float(ent) == float(jent) == 0.0


def test_prepare_params_keeps_the_outputs():
    """Casting the backbone and focal weights once gives the same values the
    per-forward casts give."""
    _, _, tm = _pair("bf16_default")
    x = torch.from_numpy(_images(2))
    want = tm(x, guidance=torch.tensor([3, 6]), noise_mode=NoiseMode.ZEROS)
    tm.prepare_params()
    assert tm.backbone.layers[0].qkv.weight.dtype == torch.bfloat16
    assert tm.backbone.pos_embed.dtype == torch.float32
    got = tm(x, guidance=torch.tensor([3, 6]), noise_mode=NoiseMode.ZEROS)
    for field in ("depth", "confidence", "attention"):
        assert torch.equal(getattr(got, field), getattr(want, field)), field


def test_sampled_noise_is_drawn_from_the_generator():
    _, _, tm = _pair("strict_f32_erf")
    x = torch.from_numpy(_images(2))
    a = tm(x, generator=torch.Generator().manual_seed(0)).curiosity
    b = tm(x, generator=torch.Generator().manual_seed(0)).curiosity
    c = tm(x, generator=torch.Generator().manual_seed(1)).curiosity
    torch.testing.assert_close(a, b)
    assert not torch.equal(a, c)


def test_port_init_gives_finite_outputs():
    arch = ModelArchConfig(num_iterations=2, image_size=IMG)
    tm = TModel(_tarch(arch), vit_cfg=TD.DinoV2Config(**TINY, gelu_approx=True),
                device="cpu")
    tm.init(torch.Generator().manual_seed(0))
    out = tm(torch.from_numpy(_images(3)), guidance=torch.tensor([0, 4, 8]))
    assert torch.isfinite(out.depth).all() and (out.depth > 0).all()
    assert ((out.confidence > 0) & (out.confidence < 1)).all()
    torch.testing.assert_close(out.attention.sum(-1), torch.ones(3))


# ------------------------------------------------------------ converter ----
def test_converter_consumes_every_key_and_sets_every_parameter():
    arch = ModelArchConfig(num_iterations=2, image_size=IMG, curiosity_guided=True)
    _, flat = _jax_params(arch)
    tm = TModel(_tarch(arch), vit_cfg=TD.DinoV2Config(**TINY), device="cpu")
    load_flat_params(tm, flat)  # raises on a leftover key or an unset parameter
    layer = tm.backbone.layers[1]
    D = TINY["hidden_size"]
    np.testing.assert_array_equal(layer.qkv.weight[D:2 * D].detach().numpy(),
                                  flat["backbone/layers/k/w"][1].T)
    np.testing.assert_array_equal(tm.focal_stream.streams[1].query_proj.weight.detach().numpy(),
                                  flat["focal_stream/streams/1/query_proj/w"].T)


def test_converter_raises_on_leftover_keys_and_unset_parameters():
    arch = ModelArchConfig(num_iterations=2, image_size=IMG)
    _, flat = _jax_params(arch)
    tm = TModel(_tarch(arch), vit_cfg=TD.DinoV2Config(**TINY), device="cpu")
    with pytest.raises((KeyError, ValueError)):
        load_flat_params(tm, {**flat, "backbone/layers/stray": np.zeros((2, 4, 64))})
    missing = dict(flat)
    del missing["decision_head/fc0/b"]
    with pytest.raises(ValueError, match="unset"):
        load_flat_params(tm, missing)


# ------------------------------------------------------- small modules ----
@pytest.mark.parametrize("g,n", [(37, 1369), (16, 256), (5, 25), (4, 30)])
def test_mask_table_matches_jax(g, n):
    np.testing.assert_array_equal(TG.mask_table(g, n).numpy(),
                                  np.asarray(JG.mask_table(g, n)))
    for name in ("center", "TopLeft", "bottom-right"):
        assert TG.instruction_index(name) == JG.instruction_index(name)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "nearest"])
def test_resize_weights_match_jax(mode):
    for i, o in ((37, 16), (16, 37), (480, 518), (7, 7)):
        np.testing.assert_array_equal(TI.resize_weights(i, o, mode),
                                      JI.resize_weights(i, o, mode))


@pytest.mark.parametrize("n,d", [(1369, 768), (25, 64), (30, 16)])
def test_focal_tables_match_jax(n, d):
    np.testing.assert_array_equal(TS.focal_pos_encoding_np(n, d),
                                  JS.focal_pos_encoding_np(n, d))
    np.testing.assert_array_equal(TS.center_bias_np(n), JS.center_bias_np(n))


def test_resize_normalize_matches_jax():
    u8 = np.random.RandomState(0).randint(0, 256, (2, 33, 47, 3)).astype(np.uint8)
    want = np.asarray(JPre.resize_normalize(jnp.asarray(u8), 28, 42))
    got = TPre.resize_normalize(torch.from_numpy(u8), 28, 42).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_curiosity_with_exif_matches_jax():
    """The forward passes no exif to curiosity; with exif the geometric
    term runs its MLP."""
    params, flat = _jax_params(ModelArchConfig(num_iterations=2, image_size=IMG))
    cm = TC.Curiosity(64, 256, device="cpu")  # the model's hidden width

    class Wrap(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.curiosity_module = cm

    load_flat_params(Wrap(), {k: v for k, v in flat.items()
                              if k.startswith("curiosity_module/")})
    feats = np.random.RandomState(4).randn(3, 64).astype(np.float32)
    exif = _exif(3)
    want, wunc, _ = JC.curiosity_apply(params["curiosity_module"], jnp.asarray(feats),
                                       {k: jnp.asarray(v) for k, v in exif.items()},
                                       noise_mode=JNoise.ZEROS)
    with torch.no_grad():
        got, unc, comps = TC.curiosity_apply(
            cm, torch.from_numpy(feats), {k: torch.from_numpy(v) for k, v in exif.items()},
            noise_mode=NoiseMode.ZEROS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    np.testing.assert_allclose(unc.numpy(), np.asarray(wunc), **F32_TOL)
    assert not torch.allclose(comps["geometric_uncertainty"], torch.full((3,), 0.5))


def test_torch_var_is_unbiased_over_the_whole_batch():
    x = np.random.RandomState(0).randn(3, 7).astype(np.float32)
    got = TL.torch_var(torch.from_numpy(x)).item()
    np.testing.assert_allclose(got, float(JL.torch_var(jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_allclose(got, x.var(ddof=1), rtol=1e-5)


def test_exploration_history_matches_jax():
    rewards = np.random.RandomState(0).rand(1234).astype(np.float32) - 0.1
    a, b = TC.ExplorationHistory(), JC.ExplorationHistory()
    a.update(rewards)
    b.update(rewards)
    assert a.statistics() == b.statistics()
    assert TC.ExplorationHistory().statistics()["samples"] == 0


def test_noise_zeros_mode_and_int8_policy():
    g = torch.Generator().manual_seed(0)
    z = normal_like(g, (4,), torch.float32, torch.device("cpu"), NoiseMode.ZEROS)
    assert torch.equal(z, torch.zeros(4))
    assert normal_like(g, (4,), torch.float32, torch.device("cpu"),
                       NoiseMode.SAMPLE).abs().sum() > 0
    assert TP.policy_from_name("f32") is TP.STRICT_F32
    int8 = TP.policy_from_name("int8")
    assert int8 is TP.INT8_BACKBONE and int8.quantize_backbone
    # bf16 compute with tanh GELU, as the JAX package's INT8_BACKBONE
    assert int8.backbone_compute_dtype == torch.bfloat16 and int8.fast_gelu
    assert JP.policy_from_name("int8").quantize_backbone
    assert not TP.DEFAULT_POLICY.quantize_backbone


def test_unported_options_raise():
    # adapters, and the token filter's drop mode, merge mode and delta
    # correction are ported (tests/test_torch_lora.py, tests/test_torch_filter.py)
    tm = TModel(TCfg.ModelArchConfig(use_lora=True), vit_cfg=TD.DinoV2Config(**TINY),
                device="cpu")
    assert tm.vit_cfg.use_lora and tm.backbone.layers[0].lora_A.shape == (16, 64)
    for mode in ("token_filter_merge", "token_filter_delta_correct"):
        TModel(TCfg.ModelArchConfig(token_filter_layer=2, token_filter_keep=0.5,
                                    **{mode: True}), vit_cfg=TD.DinoV2Config(**TINY),
               device="cpu")
    TModel(TCfg.ModelArchConfig(token_filter_layer=2, token_filter_keep=0.5),
           vit_cfg=TD.DinoV2Config(**TINY), device="cpu")
    with pytest.raises(ValueError):
        TModel(TCfg.ModelArchConfig(), attn_impl="xla", vit_cfg=TD.DinoV2Config(**TINY),
               device="cpu")


# ----------------------------------------------------------- int8 policy ----
@pytest.fixture
def pallas_interpret(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _int8_pair(attn_impl="pallas_packed"):
    """JAX int8 model with prepared parameters, and the port's, prepared,
    on the same float32 weights."""
    arch = ModelArchConfig(num_iterations=2, image_size=IMG)
    jm = JModel(arch, policy=JP.INT8_BACKBONE, attn_impl="pallas_packed",
                vit_cfg=JD.DinoV2Config(**TINY, gelu_approx=True))
    params, flat = _jax_params(arch)
    tm = TModel(_tarch(arch), policy=TP.INT8_BACKBONE, attn_impl=attn_impl, device="cpu",
                vit_cfg=TD.DinoV2Config(**TINY, gelu_approx=True))
    load_flat_params(tm, flat)
    return jm, jm.prepare_params(params), tm.prepare_params()


def _bf16_round(a):
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def test_int8_weights_carried_across_quantise_to_the_jax_values():
    """f32 JAX weights -> load_flat_params -> prepare_params gives the JAX
    package's int8 values exactly (its [K, N] is the port's [N, K])."""
    _, jq, tm = _int8_pair()
    jl = jq["backbone"]["layers"]
    for i, blk in enumerate(tm.backbone.layers):
        assert blk.quantized
        for name, jname in (("qkv", "qkv_i8"), ("attn_out", "attn_out"),
                            ("fc1", "fc1"), ("fc2", "fc2")):
            lin = getattr(blk, name)
            assert lin.wq.dtype == torch.int8 and lin.ws.dtype == torch.float32
            np.testing.assert_array_equal(lin.wq.numpy(),
                                          np.asarray(jl[jname]["wq"]["q"][i]).T)
            np.testing.assert_allclose(lin.ws.numpy(), np.asarray(jl[jname]["wq"]["s"][i]),
                                       rtol=1e-6, atol=0)
    for j, member in enumerate(tm.focal_stream.streams):
        jw = jq["focal_stream"]["streams"][j]["qkv_i8"]
        np.testing.assert_array_equal(member.qkv_i8.wq.numpy(), np.asarray(jw["wq"]["q"]).T)
        np.testing.assert_allclose(member.qkv_i8.ws.numpy(), np.asarray(jw["wq"]["s"]),
                                   rtol=1e-6, atol=0)


def test_int8_float_leaves_follow_the_jax_cast_rule():
    """The JAX forward casts every layer leaf to bf16 except those under a
    'wq' key, and its kernels then read them in f32: biases, layernorm
    parameters and LayerScales are float32 at bf16-rounded values; int8
    weights and their f32 scales pass untouched."""
    _, jq, tm = _int8_pair()
    jl = jq["backbone"]["layers"]
    i = 1
    blk = tm.backbone.layers[i]
    pairs = [(blk.qkv.bias, jl["qkv_i8"]["b"]), (blk.attn_out.bias, jl["attn_out"]["b"]),
             (blk.fc1.bias, jl["fc1"]["b"]), (blk.fc2.bias, jl["fc2"]["b"]),
             (blk.norm1.weight, jl["norm1"]["scale"]), (blk.norm1.bias, jl["norm1"]["bias"]),
             (blk.norm2.weight, jl["norm2"]["scale"]), (blk.norm2.bias, jl["norm2"]["bias"]),
             (blk.ls1, jl["ls1"]), (blk.ls2, jl["ls2"])]
    rounded_something = False
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.detach().numpy(), _bf16_round(want[i]))
        rounded_something |= not np.array_equal(_bf16_round(want[i]), np.asarray(want[i]))
    assert rounded_something  # the rule is not vacuous on these weights
    ws = blk.fc1.ws.numpy()
    assert not np.array_equal(ws, _bf16_round(ws))  # scales are not rounded
    member = tm.focal_stream.streams[0]
    jfs = jq["focal_stream"]["streams"][0]
    np.testing.assert_array_equal(member.qkv_i8.bias.numpy(), _bf16_round(jfs["qkv_i8"]["b"]))
    assert member.qkv_i8.bias.dtype == member.qkv_i8.ws.dtype == torch.float32
    # the rest of the policy's casts, as under the default policy
    assert member.projection.fc0.weight.dtype == torch.bfloat16
    assert tm.backbone.patch_embed.weight.dtype == torch.bfloat16
    assert tm.backbone.final_norm.weight.dtype == torch.bfloat16
    assert tm.backbone.pos_embed.dtype == torch.float32


def test_int8_backbone_matches_jax_chained_block(pallas_interpret):
    _, jq, tm = _int8_pair()
    x = _images(2, seed=5)
    want = JD.apply(jq["backbone"], jnp.asarray(x), JD.DinoV2Config(**TINY, gelu_approx=True),
                    compute_dtype=jnp.bfloat16, attn_impl="pallas_packed")
    got = tm.backbone(torch.from_numpy(x), compute_dtype=torch.bfloat16,
                      attn_impl="pallas_packed")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **INT8_BACKBONE_TOL)


def test_model_int8_matches_jax_unguided_and_all_instructions(pallas_interpret):
    jm, jq, tm = _int8_pair()
    n = len(JG.INSTRUCTIONS)
    x, exif = _images(n), _exif(n)
    jexif = {k: jnp.asarray(v) for k, v in exif.items()}
    texif = {k: torch.from_numpy(v) for k, v in exif.items()}
    for guidance in (None, np.arange(n, dtype=np.int32)):
        want = jm.apply(jq, jnp.asarray(x), jexif, noise_mode=JNoise.ZEROS,
                        guidance=None if guidance is None else jnp.asarray(guidance))
        got = tm(torch.from_numpy(x), texif, noise_mode=NoiseMode.ZEROS,
                 guidance=None if guidance is None else torch.from_numpy(guidance))
        for field in ("depth", "confidence", "attention"):
            np.testing.assert_allclose(
                getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                err_msg=f"int8 {field} guided={guidance is not None}", **BF16_TOL)


def test_int8_plain_attn_impl_runs_the_same_four_steps():
    """On CPU tensors the wrappers take their plain versions, so
    attn_impl="plain" gives the same bits; and int8 stays close to the
    default policy on the same weights."""
    _, _, a = _int8_pair("pallas_packed")
    _, _, b = _int8_pair("plain")
    x = torch.from_numpy(_images(3, seed=6))
    g = torch.tensor([0, 4, 8])
    oa = a(x, guidance=g, noise_mode=NoiseMode.ZEROS)
    ob = b(x, guidance=g, noise_mode=NoiseMode.ZEROS)
    for field in ("depth", "confidence", "attention"):
        assert torch.equal(getattr(oa, field), getattr(ob, field)), field
    _, _, d = _pair("bf16_default")
    od = d.prepare_params()(x, guidance=g, noise_mode=NoiseMode.ZEROS)
    torch.testing.assert_close(oa.depth, od.depth, atol=0, rtol=2e-2)


def test_int8_block_needs_tanh_gelu():
    """The chained block is chosen by the JAX rule (quantised, packed
    attention, tanh GELU, no live adapters); a quantised block with erf GELU
    runs unchained."""
    blk = TD.Block(TD.DinoV2Config(**TINY, gelu_approx=False), device="cpu")
    blk.init(torch.Generator().manual_seed(0))
    blk.quantize_(torch.bfloat16)
    assert not blk.chained("pallas_packed")
    out = blk(torch.zeros(1, 5, 64, dtype=torch.bfloat16), "pallas_packed")
    assert out.shape == (1, 5, 64) and out.dtype == torch.bfloat16
    tanh = TD.Block(TD.DinoV2Config(**TINY, gelu_approx=True), device="cpu")
    tanh.init(torch.Generator().manual_seed(0)).quantize_(torch.bfloat16)
    assert tanh.chained("pallas_packed") and not tanh.chained("pallas")
    with pytest.raises(RuntimeError, match="already quantised"):
        blk.quantize_(torch.bfloat16)
    with pytest.raises(TypeError, match="float32"):
        TL.Int8Linear.from_float(torch.zeros(4, 4, dtype=torch.bfloat16), torch.zeros(4),
                                 torch.bfloat16)


# ---------------------------------------------------------------- device ----
def test_modules_build_on_the_card_unless_asked_for_the_cpu():
    """device=None is the CUDA device; without one the constructors raise
    instead of falling back to the CPU."""
    arch = TCfg.ModelArchConfig(num_iterations=2, image_size=IMG)
    vit = TD.DinoV2Config(**TINY)
    if torch.cuda.is_available():
        tm = TModel(arch, TP.policy_from_name("int8"), vit_cfg=vit)
        assert {p.device.type for p in tm.parameters()} == {"cuda"}
        return
    for build in (lambda: TModel(arch, TP.policy_from_name("int8"), vit_cfg=vit),
                  lambda: TD.DinoV2(vit), lambda: TL.linear(4, 4), lambda: TL.layernorm(4),
                  lambda: TS.FocalStream(64), lambda: TC.Curiosity(64)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    tm = TModel(arch, TP.policy_from_name("int8"), vit_cfg=vit, device="cpu")
    assert {p.device.type for p in tm.parameters()} == {"cpu"}


# ---------------------------------------------------------------- config ----
def test_config_copy_matches_the_original():
    """The port keeps its own copy of models/config.py: same fields, same
    defaults, same token-filter functions and resolvers."""
    jf, tf = dataclasses.fields(JCfg.ModelArchConfig), dataclasses.fields(TCfg.ModelArchConfig)
    assert [(f.name, f.type, f.default) for f in tf] == [(f.name, f.type, f.default) for f in jf]
    ja, ta = JCfg.ModelArchConfig(), TCfg.ModelArchConfig()
    for prop in ("token_filter_active", "feature_dim", "fusion_dim", "n_streams"):
        assert getattr(ta, prop) == getattr(ja, prop)
    specs = ["", "2:0.35", "2:0.5,4:0.25", "2:0.35@m@r0.5", "3:0.4@d", "2:0.35@s4@f4@p@c0.25"]
    for spec in specs:
        kw = TCfg.parse_token_filter(spec)
        assert kw == JCfg.parse_token_filter(spec)
        assert TCfg.token_filter_spec(TCfg.ModelArchConfig(**kw)) == \
            JCfg.token_filter_spec(JCfg.ModelArchConfig(**kw))
    with pytest.raises(ValueError):
        TCfg.parse_token_filter("2:0.35@x")
    raw = {"model": {"cognitive_modules": ["ambient_stream", "iterative_focal_stream"],
                     "focal_hidden_dim": 128, "exif_config": {"num_cameras": 9}},
           "focal_config": {"num_iterations": 2, "focus_strength": 0.1},
           "dataset": {"image_size": [518, 518]}, "backbone_size": "large"}
    for lookup in ("reference", "nested"):
        assert dataclasses.asdict(TCfg.resolve_model_config(raw, lookup=lookup)) == \
            dataclasses.asdict(JCfg.resolve_model_config(raw, lookup=lookup))
    assert TCfg.resolve_num_cameras(raw) == JCfg.resolve_num_cameras(raw) == 9
    assert TCfg.resolve_image_size(raw) == JCfg.resolve_image_size(raw) == 518


# ------------------------------------------------------------- imports ----
def test_port_imports_no_jax():
    """The card's machine has no jax: after importing every module of the
    port (the engine, the server, the host IO, the utilities, the
    certification toolchain, the parallel layer and the compiled forward
    among them, which start no process group) and scripts/torch_export_model.py
    and the serving and training benchmarks, neither jax nor any
    module of the
    JAX package or of its scripts is loaded; and PIL,
    matplotlib and yaml, which the functions that need them import, are not
    loaded by an import either."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import cognitive_aim_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "assert len(names) > 20, names\n"
        "need = ['api', 'serve', 'io.exif', 'io.checkpoint_torch', 'io.native_loader',\n"
        "        'io.preprocess', 'utils.visualize', 'utils.logging', 'certify.common',\n"
        "        'certify.procedural', 'certify.policy_delta', 'certify.synth_train',\n"
        "        'certify.pretrain', 'certify.attention_stats', 'certify.delta_sweep',\n"
        "        'certify.certify_filter', 'core.mesh', 'parallel.comm', 'parallel.sharding',\n"
        "        'parallel.pipeline', 'utils.profiling', 'kernels._library', 'core.compiled']\n"
        "missing = [n for n in need if pkg.__name__ + '.' + n not in names]\n"
        "assert not missing, missing\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "sys.path.insert(0, 'scripts')\n"
        "for script in ('torch_export_model', 'torch_bench_serving', 'torch_bench_serving_http',\n"
        "               'torch_bench_train', 'torch_bench_train_table'):\n"
        "    importlib.import_module(script)\n"
        "scripts = {'procedural_scenes', 'policy_delta', 'train_synth_ckpt',\n"
        "           'pretrain_procedural', 'attention_stats', 'delta_sweep', 'certify_filter',\n"
        "           'export_model', 'bench_train', 'bench_train_table'}\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'cognitive_aim_tpu' or m.startswith('cognitive_aim_tpu.')\n"
        "       or m.split('.')[0] in scripts]\n"
        "assert not bad, bad\n"
        "lazy = [m for m in sys.modules if m.split('.')[0] in ('PIL', 'matplotlib', 'yaml')]\n"
        "assert not lazy, lazy\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
    )
    root = __file__.rsplit("/tests/", 1)[0]
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120)
