"""The fused variants of the chained int8 block in the port (K9, K11, K12)
against the JAX package.

  K9   ``flash_attention_packed(..., int8_dots=True)``: q and k quantised per
       (row, head) inside the kernel, int8 q k^T
  K11  ``flash_attention_packed_out_res``: attention, int8 attn_out on the f32
       context, LayerScale, residual
  K12  ``int8_attnout_mlp_ln``: K3 then K4 with the residual carried in f32,
       which the chained block runs under ``CAIM_FUSE_AOMLP=1``

The same numpy-seeded inputs go through both packages. The JAX side runs its
Pallas kernels in interpret mode on the CPU; the port runs on CPU tensors, so
its wrappers take their plain versions (the CUDA kernels are compared with
those on the card, tests/test_torch_cuda.py and chip_smoke.py).

The JAX package reads ``CAIM_FUSE_AOMLP`` in Python while it traces, so a
trace made with the variable unset would be reused: the ``fuse_aomlp`` fixture
clears JAX's caches after setting the variable and again on the way out, and
counts the ``pallas_call``s whose body is ``_attnout_mlp_kernel``, so that a
test can assert that the fused JAX kernel is what it was compared with.

Tolerances, with their reasons:
  * K9 in float32: the quantisation is the same IEEE arithmetic on both
    sides and the integer product is exact, so what differs is the summation
    order of the softmax and of P V: atol 2e-5 / rtol 2e-4, as the other
    attention kernels (tests/test_torch_kernels.py). bfloat16: both round P
    and the output to bf16, atol 1e-2.
  * K11 and K12 in float32: atol 2e-4 / rtol 2e-3, the tolerance of the K3 and
    K4 tests (tests/test_torch_int8.py). An int8 activation may land one
    step apart where summation order moves a value across a rounding
    boundary; at these sizes the outputs stay inside the tolerance.
  * K12 against K3 then K4 on bfloat16 inputs: the pair rounds the
    post-attention residual to bf16, K12 does not: not equal, within 2e-2
    (the JAX package's own tolerance, tests/test_kernels.py).
  * backbone and whole model under the int8 policy: atol 2e-2 / rtol 5e-2
    and atol 1e-2, as tests/test_torch_model.py.
"""

import dataclasses
import functools
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cognitive_aim_tpu.api import flatten_tree
from cognitive_aim_tpu.core import precision as JP
from cognitive_aim_tpu.core.rng import NoiseMode as JNoise
from cognitive_aim_tpu.kernels import flash_attention as JFA
from cognitive_aim_tpu.kernels import int8_block as JIB
from cognitive_aim_tpu.kernels import int8_ops as JI8
from cognitive_aim_tpu.models import guidance as JG
from cognitive_aim_tpu.models.cognitive_aim import CognitiveAimModel as JModel
from cognitive_aim_tpu.models.config import ModelArchConfig
from cognitive_aim_tpu.nn import dinov2 as JD
from cognitive_aim_tpu_torch.convert import load_flat_params
from cognitive_aim_tpu_torch.core import precision as TP
from cognitive_aim_tpu_torch.core.rng import NoiseMode
from cognitive_aim_tpu_torch.kernels import flash_attention as TFA
from cognitive_aim_tpu_torch.kernels import int8_block as TIB
from cognitive_aim_tpu_torch.kernels import int8_ops as TI8
from cognitive_aim_tpu_torch.models import config as TCfg
from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel as TModel
from cognitive_aim_tpu_torch.nn import dinov2 as TD

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

KERNEL_TOL = dict(atol=2e-5, rtol=2e-4)
OUT_TOL = dict(atol=2e-4, rtol=2e-3)
BF16_TOL = dict(atol=1e-2, rtol=0.0)
INT8_BACKBONE_TOL = dict(atol=2e-2, rtol=5e-2)
EPS = 1e-6

# tiny ViT of tests/test_torch_model.py: hidden 64, 2 layers, 4 heads, a 5x5 grid
TINY = dict(hidden_size=64, num_layers=2, num_heads=4, patch_size=14, pretrain_image_size=56)
IMG = 70


@pytest.fixture(autouse=True, scope="module")
def _no_grad():
    """The model's forward is differentiable since the port trains; these
    inference tests run under torch.no_grad(), as the engine serves."""
    with torch.no_grad():
        yield


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tensors are tiny: PyTorch's intra-op thread pool, sharing the
    cores with XLA's, costs 100x what it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pallas_calls(monkeypatch):
    """Runs every ``pallas_call`` in interpret mode and lists the names of
    the kernel bodies that were called. The JAX kernels are jitted, so a
    name appears when a shape is traced, not at every call: the kernel tests
    below use token counts no other test uses."""
    from jax.experimental import pallas as pl

    orig, names = pl.pallas_call, []

    def interp(kernel, *a, **kw):
        names.append(getattr(kernel, "func", kernel).__name__)
        kw["interpret"] = True
        return orig(kernel, *a, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)
    return names


@pytest.fixture
def fuse_aomlp(monkeypatch, pallas_calls):
    """``CAIM_FUSE_AOMLP=1`` for both packages, with no JAX trace from
    before the variable was set, and none left behind for other tests."""
    monkeypatch.setenv("CAIM_FUSE_AOMLP", "1")
    jax.clear_caches()
    yield pallas_calls
    monkeypatch.delenv("CAIM_FUSE_AOMLP")
    jax.clear_caches()


def _arrays(shape, n=3, seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) * scale).astype(np.float32) for _ in range(n)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _weights(names_shapes, seed):
    """name -> (JAX {'q': [K, N], 's': [N]}, port {'q': [N, K], 's': [N]})
    quantised from the same float values."""
    r = np.random.RandomState(seed)
    out = {}
    for name, (K, N) in names_shapes.items():
        w = (r.randn(K, N) * 0.05).astype(np.float32)
        out[name] = (JI8.quantize_weight(jnp.asarray(w)),
                     TI8.quantize_weight(torch.from_numpy(w.T.copy())))
    return out


# ---------------------------------------------------------------- K9 ----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [72, 136])
def test_k9_plain_matches_jax_kernel(N, dtype, pallas_calls):
    B, H, D = 2, 4, 32
    q, k, v = _arrays((B, N, H * D), seed=N)
    q[0, 3, :D] = 0.0  # one head's slice of a row all zero: the 1e-12 scale floor
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = JFA.flash_attention_packed(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                                      D ** -0.5, H, 64, True)
    assert pallas_calls == ["_flash_packed_int8_kernel"]
    got = TFA.flash_attention_packed(*(_t(a).to(tdt) for a in (q, k, v)), D ** -0.5, H,
                                     int8_dots=True)
    assert got.dtype == tdt and got.shape == (B, N, H * D)
    tol = KERNEL_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)


def test_k9_scales_are_per_row_and_head_not_k10s_joint_rows():
    """One head with values 100x the others': per-(row, head) scales keep the
    small heads' scores, the joint-row scales of K10 quantise them to zero."""
    B, N, H, D = 1, 40, 2, 64
    q, k, v = (_t(a) for a in _arrays((B, N, H * D), seed=2))
    q[..., :D] *= 100.0
    k[..., :D] *= 100.0
    exact = TFA.flash_attention_packed_plain(q, k, v, D ** -0.5, H)
    per_head = TFA.flash_attention_packed_int8_plain(q, k, v, D ** -0.5, H)
    joint = TFA.flash_attention_packed_i8qk_plain(q, k, v, D ** -0.5, H)
    small = slice(D, 2 * D)  # the head with the small values
    err_head = (per_head - exact)[..., small].abs().max().item()
    err_joint = (joint - exact)[..., small].abs().max().item()
    assert err_head < 0.1 * err_joint
    # the quantisation itself: each head's slice of a row has its own scale
    q8, sq = TFA.quantize_rows_plain(TFA._heads(q, H))
    assert sq.shape == (B, H, N, 1)
    assert torch.all(q8.abs().amax(-1) == 127)


def test_int8_dots_keyword_sits_where_the_jax_signature_has_it():
    names = list(inspect.signature(TFA.flash_attention_packed).parameters)
    assert names == ["q", "k", "v", "scale", "num_heads", "q_block", "int8_dots"]
    assert names == list(inspect.signature(JFA._flash_packed_fwd_only).parameters)
    q, k, v = (_t(a) for a in _arrays((1, 33, 128)))
    by_position = TFA.flash_attention_packed(q, k, v, 0.125, 2, 0, True)
    assert torch.equal(by_position, TFA.flash_attention_packed_int8_plain(q, k, v, 0.125, 2))
    assert torch.equal(TFA.flash_attention_packed(q, k, v, 0.125, 2, 0, False),
                       TFA.flash_attention_packed_plain(q, k, v, 0.125, 2))


# --------------------------------------------------------------- K11 ----
def _k11_case(N, seed):
    B, H, D = 2, 4, 32
    HD = H * D
    q, k, v = _arrays((B, N, HD), seed=seed, scale=0.5)
    (res,) = _arrays((B, N, HD), n=1, seed=seed + 1)
    jw, tw = _weights({"out": (HD, HD)}, seed + 2)["out"]
    r = np.random.RandomState(seed + 3)
    b = (r.randn(HD) * 0.01).astype(np.float32)
    ls = (r.randn(HD) * 0.1 + 0.9).astype(np.float32)
    return (q, k, v, res, b, ls), jw, tw, D ** -0.5, H


@pytest.mark.parametrize("N", [72, 136])
def test_k11_plain_matches_jax_kernel(N, pallas_calls):
    (q, k, v, res, b, ls), jw, tw, scale, H = _k11_case(N, seed=20 + N)
    want = JFA.flash_attention_packed_out_res(
        *(jnp.asarray(a) for a in (q, k, v)), jw["q"], jw["s"], jnp.asarray(b),
        jnp.asarray(ls), jnp.asarray(res), scale, H, q_block=64)
    assert pallas_calls == ["_flash_packed_out_res_kernel"]
    got = TFA.flash_attention_packed_out_res(_t(q), _t(k), _t(v), tw["q"], tw["s"], _t(b),
                                             _t(ls), _t(res), scale, H)
    assert got.shape == res.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


def test_k11_plain_is_k1_then_k3_with_an_unrounded_context():
    """In float32 nothing rounds between attention and projection, so K11's
    plain version is K3's on K1's output; in bfloat16 the pair rounds the
    context to bf16 first and K11 does not: close, not equal. The quantised
    context a check can ask for is that of the f32 context."""
    (q, k, v, res, b, ls), _, tw, scale, H = _k11_case(70, seed=31)
    tq, tk, tv, tres, tb, tls = (_t(a) for a in (q, k, v, res, b, ls))
    fused = TFA.flash_attention_packed_out_res(tq, tk, tv, tw["q"], tw["s"], tb, tls, tres,
                                               scale, H)
    ctx = TFA.flash_attention_packed(tq, tk, tv, scale, H)
    pair = TIB.int8_out_residual(ctx, tw["q"], tw["s"], tb, tls, tres)
    np.testing.assert_allclose(fused.numpy(), pair.numpy(), **OUT_TOL)
    h = [t.bfloat16() for t in (tq, tk, tv, tres)]
    fused16, c8, sc = TFA.flash_attention_packed_out_res(
        h[0], h[1], h[2], tw["q"], tw["s"], tb, tls, h[3], scale, H, return_quantised=True)
    pair16 = TIB.int8_out_residual(TFA.flash_attention_packed(h[0], h[1], h[2], scale, H),
                                   tw["q"], tw["s"], tb, tls, h[3])
    assert fused16.dtype == torch.bfloat16
    assert not torch.equal(fused16, pair16)
    np.testing.assert_allclose(fused16.float().numpy(), pair16.float().numpy(), atol=2e-2,
                               rtol=2e-2)
    want8, wants = TI8.quantize_activations(
        TFA.attention_context_f32(h[0], h[1], h[2], scale, H))
    assert c8.dtype == torch.int8 and sc.shape == (2, 70, 1)
    assert torch.equal(c8, want8) and torch.equal(sc, wants)


# --------------------------------------------------------------- K12 ----
B12, D12, F12 = 2, 128, 256


def _k12_case(seed, N12=70):
    r = np.random.RandomState(seed)

    def f(*shape, scale=1.0, shift=0.0):
        return (r.randn(*shape) * scale + shift).astype(np.float32)

    t = dict(ctx=f(B12, N12, D12, scale=0.5), res=f(B12, N12, D12, scale=0.5),
             g=f(D12, scale=0.1, shift=1.0), be=f(D12, scale=0.05),
             bo=f(D12, scale=0.01), b1=f(F12, scale=0.01), b2=f(D12, scale=0.01),
             ls1=f(D12, scale=0.1, shift=0.8), ls2=f(D12, scale=0.1, shift=0.9))
    return t, _weights({"out": (D12, D12), "fc1": (D12, F12), "fc2": (F12, D12)}, seed + 1)


def _k12_args(t, w, side, conv, dtype=None):
    """The 15 arguments in the JAX order, for the JAX side (0) or the port (1)."""
    act = (lambda a: conv(a)) if dtype is None else (lambda a: conv(a).to(dtype))
    wo, w1, w2 = (w[n][side] for n in ("out", "fc1", "fc2"))
    return (act(t["ctx"]), wo["q"], wo["s"], conv(t["bo"]), conv(t["ls1"]), act(t["res"]),
            conv(t["g"]), conv(t["be"]), w1["q"], w1["s"], conv(t["b1"]),
            w2["q"], w2["s"], conv(t["b2"]), conv(t["ls2"]))


@pytest.mark.parametrize("N12", [72, 96])
def test_k12_plain_matches_jax_kernel(N12, pallas_calls):
    t, w = _k12_case(40 + N12, N12)
    want = JIB.int8_attnout_mlp_ln(*_k12_args(t, w, 0, jnp.asarray), eps=EPS, n_block=64)
    assert pallas_calls == ["_attnout_mlp_kernel"]
    got = TIB.int8_attnout_mlp_ln(*_k12_args(t, w, 1, _t), EPS)
    assert got.shape == (B12, N12, D12) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


def test_k12_carries_the_residual_in_f32_where_k3_then_k4_rounds_it():
    t, w = _k12_case(42)
    a32 = _k12_args(t, w, 1, _t)
    a16 = _k12_args(t, w, 1, _t, torch.bfloat16)

    def pair(a):
        x = TIB.int8_out_residual(a[0], *a[1:5], a[5])
        return TIB.int8_mlp_ln(x, *a[6:], EPS)

    # float32 activations: nothing rounds in between, the same function
    np.testing.assert_allclose(TIB.int8_attnout_mlp_ln(*a32, EPS).numpy(), pair(a32).numpy(),
                               **OUT_TOL)
    fused, split = TIB.int8_attnout_mlp_ln(*a16, EPS), pair(a16)
    assert fused.dtype == split.dtype == torch.bfloat16
    assert not torch.equal(fused, split)
    np.testing.assert_allclose(fused.float().numpy(), split.float().numpy(), atol=2e-2, rtol=2e-2)
    # one cast at the end: the bf16 result is the f32 computation on the same
    # bf16-valued inputs, rounded once
    up = [x.float() if x.dtype == torch.bfloat16 else x for x in a16]
    assert torch.equal(fused, TIB.int8_attnout_mlp_ln(*up, EPS).bfloat16())


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    t, w = _k12_case(43)
    a = _k12_args(t, w, 1, _t, torch.bfloat16)
    (q, k, v, res, b, ls), _, tw, scale, H = _k11_case(70, seed=44)
    q, k, v, res = (_t(x).bfloat16() for x in (q, k, v, res))
    before = [f.launches for f in (*TIB.WRAPPERS, *TFA.WRAPPERS)]
    assert TIB.int8_attnout_mlp_ln in TIB.WRAPPERS
    assert TFA.flash_attention_packed_int8 in TFA.WRAPPERS
    assert TFA.flash_attention_packed_out_res in TFA.WRAPPERS
    assert torch.equal(TIB.int8_attnout_mlp_ln(*a, EPS), TIB.int8_attnout_mlp_ln_plain(*a, EPS))
    assert torch.equal(TFA.flash_attention_packed_int8(q, k, v, scale, H),
                       TFA.flash_attention_packed_int8_plain(q, k, v, scale, H))
    args = (q, k, v, tw["q"], tw["s"], _t(b), _t(ls), res, scale, H)
    assert torch.equal(TFA.flash_attention_packed_out_res(*args),
                       TFA.flash_attention_packed_out_res_plain(*args))
    assert [f.launches for f in (*TIB.WRAPPERS, *TFA.WRAPPERS)] == before


# ------------------------------------------- the chained block's switch ----
def _block(seed=0):
    blk = TD.Block(TD.DinoV2Config(**TINY, gelu_approx=True), device="cpu")
    blk.init(torch.Generator().manual_seed(seed)).quantize_(torch.bfloat16)
    return blk


def _k12_of_block(blk, ctx, x, plain=False):
    fn = TIB.int8_attnout_mlp_ln_plain if plain else TIB.int8_attnout_mlp_ln
    return fn(ctx, blk.attn_out.wq, blk.attn_out.ws, blk.attn_out.bias, blk.ls1, x,
              blk.norm2.weight, blk.norm2.bias, blk.fc1.wq, blk.fc1.ws, blk.fc1.bias,
              blk.fc2.wq, blk.fc2.ws, blk.fc2.bias, blk.ls2, blk.cfg.layer_norm_eps)


@pytest.mark.parametrize("attn_impl", ["pallas_packed", "pallas_packed_i8qk", "plain"])
@pytest.mark.parametrize("biased", [False, True])
@torch.no_grad()
def test_block_reads_the_switch_at_call_time(attn_impl, biased, monkeypatch):
    """One block object, the variable flipped between calls: unset and "0"
    run K3 then K4, "1" runs K12 on the same attention context, after every
    packed attention route, with or without the token filter's key bias."""
    blk = _block()
    (x,) = _arrays((2, 26, 64), n=1, seed=50)
    x = _t(x).bfloat16()
    bias = _t(np.log(np.random.RandomState(51).randint(1, 50, (2, 26)).astype(np.float32))) \
        if biased else None
    monkeypatch.delenv("CAIM_FUSE_AOMLP", raising=False)
    unfused = blk(x, attn_impl, bias)
    monkeypatch.setenv("CAIM_FUSE_AOMLP", "1")
    fused = blk(x, attn_impl, bias)
    monkeypatch.setenv("CAIM_FUSE_AOMLP", "0")
    assert torch.equal(blk(x, attn_impl, bias), unfused)
    assert not torch.equal(fused, unfused)
    np.testing.assert_allclose(fused.float().numpy(), unfused.float().numpy(), atol=2e-2, rtol=2e-2)
    n1 = blk.norm1
    q, k, v = TIB.int8_qkv_proj_ln(x, n1.weight, n1.bias, blk.qkv.wq, blk.qkv.ws,
                                   blk.qkv.bias, blk.cfg.layer_norm_eps)
    ctx = TD.attend(attn_impl, q, k, v, bias, blk.cfg.head_dim ** -0.5, blk.cfg.num_heads)
    assert torch.equal(fused, _k12_of_block(blk, ctx, x, plain=attn_impl == "plain"))


@torch.no_grad()
def test_an_unchained_block_ignores_the_switch(monkeypatch):
    """The switch sits inside the chained int8 block, as in the JAX package:
    a float block and a quantised block with erf GELU do not read it."""
    (x,) = _arrays((1, 26, 64), n=1, seed=52)
    x = _t(x).bfloat16()
    flt = TD.Block(TD.DinoV2Config(**TINY, gelu_approx=True), device="cpu")
    flt.init(torch.Generator().manual_seed(1))
    erf = TD.Block(TD.DinoV2Config(**TINY, gelu_approx=False), device="cpu")
    erf.init(torch.Generator().manual_seed(1)).quantize_(torch.bfloat16)
    for blk in (flt, erf):
        monkeypatch.delenv("CAIM_FUSE_AOMLP", raising=False)
        off = blk(x, "pallas_packed")
        monkeypatch.setenv("CAIM_FUSE_AOMLP", "1")
        assert torch.equal(blk(x, "pallas_packed"), off)


# ------------------------------------------ backbone and whole model ----
def _tarch(arch):
    return TCfg.ModelArchConfig(**dataclasses.asdict(arch))


@functools.lru_cache(maxsize=None)
def _int8_pair():
    """JAX int8 model with prepared parameters, and the port's, prepared,
    on the same float32 weights."""
    arch = ModelArchConfig(num_iterations=2, image_size=IMG)
    jm = JModel(arch, policy=JP.INT8_BACKBONE, attn_impl="pallas_packed",
                vit_cfg=JD.DinoV2Config(**TINY, gelu_approx=True))
    # off a TPU the JAX model falls back to its XLA attention, which never
    # reaches the chained block: name the route again, the tests interpret it
    jm.attn_impl = "pallas_packed"
    params = jm.init(jax.random.PRNGKey(0))
    tm = TModel(_tarch(arch), policy=TP.INT8_BACKBONE, attn_impl="pallas_packed", device="cpu",
                vit_cfg=TD.DinoV2Config(**TINY, gelu_approx=True))
    load_flat_params(tm, flatten_tree(params))
    return jm, jm.prepare_params(params), tm.prepare_params()


def _images(B, seed=0):
    return np.random.RandomState(seed).randn(B, IMG, IMG, 3).astype(np.float32)


def test_k12_on_converted_weights_matches_the_jax_kernel_on_its_tree(pallas_calls):
    """``load_flat_params`` + ``prepare_params`` hand K12 what the JAX block
    hands its kernel (tests/test_torch_model.py holds the tensors equal one by
    one): the same bf16 inputs through a block's own tensors in both packages.
    The JAX forward casts every float leaf of the layer to bf16 first."""
    _, jq, tm = _int8_pair()
    jl, i = jq["backbone"]["layers"], 1
    blk = tm.backbone.layers[i]
    ctx, res = _arrays((2, 27, 64), n=2, seed=60, scale=0.5)

    def leaf(*path):
        a = jl
        for key in path:
            a = a[key]
        return a[i] if "wq" in path else a[i].astype(jnp.bfloat16)

    want = JIB.int8_attnout_mlp_ln(
        jnp.asarray(ctx).astype(jnp.bfloat16), leaf("attn_out", "wq", "q"),
        leaf("attn_out", "wq", "s"), leaf("attn_out", "b"), leaf("ls1"),
        jnp.asarray(res).astype(jnp.bfloat16), leaf("norm2", "scale"), leaf("norm2", "bias"),
        leaf("fc1", "wq", "q"), leaf("fc1", "wq", "s"), leaf("fc1", "b"),
        leaf("fc2", "wq", "q"), leaf("fc2", "wq", "s"), leaf("fc2", "b"), leaf("ls2"),
        eps=blk.cfg.layer_norm_eps)
    assert pallas_calls == ["_attnout_mlp_kernel"]
    with torch.no_grad():
        got = _k12_of_block(blk, _t(ctx).bfloat16(), _t(res).bfloat16())
    assert got.dtype == torch.bfloat16
    # both round the f32 result to bf16 once: one bf16 step of an O(1) value apart
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **BF16_TOL)


def test_int8_backbone_fused_matches_jax_fused(fuse_aomlp):
    _, jq, tm = _int8_pair()
    x = _images(2, seed=5)
    want = JD.apply(jq["backbone"], jnp.asarray(x), JD.DinoV2Config(**TINY, gelu_approx=True),
                    compute_dtype=jnp.bfloat16, attn_impl="pallas_packed")
    assert "_attnout_mlp_kernel" in fuse_aomlp  # the JAX side ran its fused kernel
    assert "_mlp_ln_kernel" not in fuse_aomlp and "_out_res_kernel" not in fuse_aomlp
    got = tm.backbone(torch.from_numpy(x), compute_dtype=torch.bfloat16,
                      attn_impl="pallas_packed")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **INT8_BACKBONE_TOL)


def test_int8_backbone_fused_differs_from_unfused_in_both_packages(fuse_aomlp, monkeypatch):
    """The comparison above is not vacuous: with the variable unset either
    package gives other bits (close ones)."""
    _, jq, tm = _int8_pair()
    x = _images(2, seed=6)
    jcfg = JD.DinoV2Config(**TINY, gelu_approx=True)

    def both():
        j = JD.apply(jq["backbone"], jnp.asarray(x), jcfg, compute_dtype=jnp.bfloat16,
                     attn_impl="pallas_packed")
        t = tm.backbone(torch.from_numpy(x), compute_dtype=torch.bfloat16,
                        attn_impl="pallas_packed")
        return np.asarray(j.astype(jnp.float32)), t.float().numpy()

    j_on, t_on = both()
    monkeypatch.setenv("CAIM_FUSE_AOMLP", "0")
    jax.clear_caches()
    del fuse_aomlp[:]
    j_off, t_off = both()
    assert "_attnout_mlp_kernel" not in fuse_aomlp and "_mlp_ln_kernel" in fuse_aomlp
    assert not np.array_equal(j_on, j_off) and not np.array_equal(t_on, t_off)
    np.testing.assert_allclose(t_on, t_off, **INT8_BACKBONE_TOL)
    monkeypatch.setenv("CAIM_FUSE_AOMLP", "1")  # the fixture's exit removes it


@pytest.mark.parametrize("guided", [False, True], ids=["unguided", "all_nine"])
def test_model_int8_fused_matches_jax_fused(guided, fuse_aomlp):
    jm, jq, tm = _int8_pair()
    n = len(JG.INSTRUCTIONS)
    x = _images(n)
    exif = {"camera_idx": np.arange(n, dtype=np.int32) % 5,
            "focal_length": np.linspace(0.1, 0.9, n).astype(np.float32),
            "aperture": np.full(n, 0.127, np.float32), "iso": np.full(n, 0.016, np.float32)}
    guidance = np.arange(n, dtype=np.int32) if guided else None
    want = jm.apply(jq, jnp.asarray(x), {k: jnp.asarray(v) for k, v in exif.items()},
                    noise_mode=JNoise.ZEROS,
                    guidance=None if guidance is None else jnp.asarray(guidance))
    assert fuse_aomlp.count("_attnout_mlp_kernel") >= 1 and "_mlp_ln_kernel" not in fuse_aomlp
    got = tm(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in exif.items()},
             noise_mode=NoiseMode.ZEROS,
             guidance=None if guidance is None else torch.from_numpy(guidance))
    for field in ("depth", "confidence", "attention"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   err_msg=f"fused int8 {field} guided={guided}", **BF16_TOL)
