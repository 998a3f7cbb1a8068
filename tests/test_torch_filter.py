"""The token-filter fast path of the port, and the attention kernels it
reaches (K7, K10, K10b), against the JAX package.

The same numpy-seeded inputs and the same JAX-initialised weights go through
both packages. The JAX side runs its Pallas kernels in interpret mode on the
CPU; the port runs on CPU tensors, so its wrappers take their plain versions
(the CUDA kernels are compared with those on the card, tests/test_torch_cuda.py
and chip_smoke.py).

Tolerances, with their reasons:
  * K7, K10, K10b plain versions against the JAX kernels in float32: summation
    order and exp/division rounding, atol 2e-5 / rtol 2e-4, the tolerance of
    the K1 test in tests/test_torch_kernels.py. ``quantize_rows`` is the same
    IEEE arithmetic on both sides: int8 values and scales equal exactly.
  * filter functions on identical inputs in float32: atol 2e-6 (importances
    are <= 1, token values O(1)); kept indices equal exactly.
  * filtered backbone, strict float32: the kept set is a discrete function of
    the importances, so the test asserts that the priority gap at every keep
    boundary exceeds 1e-5 (50x the float32 differences between the frameworks)
    and then that every stage keeps identical indices; merge mode and the
    delta correction also assign each dropped token to a kept one by an argmax
    of cosine similarities, so the test asserts that every such argmax leads
    its runner-up by 1e-5 too; outputs atol 2e-5 /
    rtol 1e-4 as the unfiltered backbone test of tests/test_torch_model.py.
  * bfloat16 backbone: both sides round at other places (see
    tests/test_torch_model.py), and a token at the keep boundary may swap, which
    changes that one position's output by O(1): per sample at most 4 of the
    64 tokens may exceed 4e-2, and the median error stays under 1e-2.
  * whole model: float32 atol 2e-6 / rtol 1e-5, bfloat16 and int8 atol 1e-2, as
    tests/test_torch_model.py.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cognitive_aim_tpu.api import flatten_tree
from cognitive_aim_tpu.core import precision as JP
from cognitive_aim_tpu.core.rng import NoiseMode as JNoise
from cognitive_aim_tpu.kernels import flash_attention as JFA
from cognitive_aim_tpu.models.cognitive_aim import CognitiveAimModel as JModel
from cognitive_aim_tpu.models.config import ModelArchConfig, parse_token_filter
from cognitive_aim_tpu.nn import dinov2 as JD
from cognitive_aim_tpu_torch.convert import load_flat_params
from cognitive_aim_tpu_torch.core import precision as TP
from cognitive_aim_tpu_torch.core.rng import NoiseMode
from cognitive_aim_tpu_torch.kernels import flash_attention as TFA
from cognitive_aim_tpu_torch.models import config as TCfg
from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel as TModel
from cognitive_aim_tpu_torch.nn import dinov2 as TD

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# ViT: hidden 128 as 2 heads of 64 (the kernels' head width), 4 layers; a
# 112x112 image is an 8x8 grid (64 patch tokens) against the 4x4 pretrain grid
VIT = dict(hidden_size=128, num_layers=4, num_heads=2, patch_size=14,
           pretrain_image_size=56)
IMG = 112
P = (IMG // 14) ** 2

KERNEL_TOL = dict(atol=2e-5, rtol=2e-4)
FN_TOL = dict(atol=2e-6, rtol=1e-5)
F32_BACKBONE_TOL = dict(atol=2e-5, rtol=1e-4)
F32_TOL = dict(atol=2e-6, rtol=1e-5)
BF16_TOL = dict(atol=1e-2, rtol=0.0)
MIN_GAP = 1e-5  # priority gap at a keep boundary, strict-f32 tests


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
def pallas_interpret(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _arrays(shape, n=3, seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) * scale).astype(np.float32) for _ in range(n)]


def _images(B, seed=0):
    return np.random.RandomState(seed).randn(B, IMG, IMG, 3).astype(np.float32)


def _bias(B, N, seed=3):
    """Zeros, log counts on the 4 trailing keys, one of them an empty group."""
    rng = np.random.RandomState(seed)
    b = np.zeros((B, N), np.float32)
    b[:, -4:] = np.log(rng.randint(1, 891, (B, 4)).astype(np.float32))
    b[0, -2] = np.log(1e-6)
    return b


# ------------------------------------------------------------- kernels ----
@pytest.mark.parametrize("N", [130, 260])
@pytest.mark.parametrize("kernel", ["K7", "K10", "K10b"])
def test_plain_versions_match_jax_kernels(kernel, N, pallas_interpret):
    B, H, D = 2, 2, 64
    q, k, v = _arrays((B, N, H * D))
    bias = _bias(B, N)
    scale = D ** -0.5
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    if kernel == "K7":
        want = JFA.flash_attention_packed_bias(jq, jk, jv, jnp.asarray(bias), scale, H, 128)
        got = TFA.flash_attention_packed_bias(tq, tk, tv, torch.from_numpy(bias), scale, H)
    elif kernel == "K10":
        want = JFA.flash_attention_packed_i8qk(jq, jk, jv, scale, H, 128)
        got = TFA.flash_attention_packed_i8qk(tq, tk, tv, scale, H)
    else:
        want = JFA.flash_attention_packed_i8qk_bias(jq, jk, jv, jnp.asarray(bias), scale, H,
                                                    128)
        got = TFA.flash_attention_packed_i8qk_bias(tq, tk, tv, torch.from_numpy(bias),
                                                   scale, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_matches_jax_exactly(dtype):
    (x,) = _arrays((2, 130, 128), n=1, seed=4, scale=1.7)
    x[0, 3] = 0.0  # an all-zero row takes the 1e-12 floor
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want8, wants = JFA.quantize_rows(jx)
    got8, gots = TFA.quantize_rows(tx)
    assert got8.dtype == torch.int8 and gots.shape == (2, 130, 1)
    np.testing.assert_array_equal(got8.numpy(), np.asarray(want8))
    np.testing.assert_array_equal(gots.numpy(), np.asarray(wants))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_of_q_and_k_together_match_jax_exactly(dtype):
    """The one-launch quantiser of K10's q and k (``quantize_rows(q, k)``):
    its plain version gives JAX ``quantize_rows`` of each tensor bit for bit,
    rows of zeros and a row of +-127 times a power of two included, and
    counts no launch on the CPU."""
    q, k = _arrays((2, 65, 128), n=2, seed=6, scale=1.7)
    q[1, 7] = 0.0
    k[0, 0] = 0.0
    k[1, 3] = np.where(np.arange(128) % 2, 127.0, -127.0) * 0.25  # scale exactly 0.25
    jq, jk = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in (q, k))
    tq, tk = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k))
    n = TFA.quantize_rows.launches
    got = TFA.quantize_rows(tq, tk)
    assert TFA.quantize_rows.launches == n and len(got) == 4
    want = (*JFA.quantize_rows(jq), *JFA.quantize_rows(jk))
    for g, w in zip(got, want):
        assert g.dtype == (torch.int8 if w.dtype == jnp.int8 else torch.float32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got[3][1, 3, 0]) == 0.25
    assert torch.equal(got[2][1, 3].abs(), torch.full((128,), 127, dtype=torch.int8))


def test_bf16_plain_versions_keep_the_dtype_and_count_no_launch():
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _arrays((2, 65, 128)))
    bias = torch.from_numpy(_bias(2, 65))
    before = [w.launches for w in TFA.WRAPPERS]
    outs = [TFA.flash_attention_packed_bias(q, k, v, bias, 0.125, 2),
            TFA.flash_attention_packed_i8qk(q, k, v, 0.125, 2),
            TFA.flash_attention_packed_i8qk_bias(q, k, v, bias, 0.125, 2)]
    assert all(o.dtype == torch.bfloat16 and o.shape == q.shape for o in outs)
    assert [w.launches for w in TFA.WRAPPERS] == before
    # a zero bias is the unbiased function, bit for bit
    zero = torch.zeros(2, 65)
    assert torch.equal(TFA.flash_attention_packed_bias(q, k, v, zero, 0.125, 2),
                       TFA.flash_attention_packed(q, k, v, 0.125, 2))
    assert torch.equal(TFA.flash_attention_packed_i8qk_bias(q, k, v, zero, 0.125, 2), outs[1])


def test_proportional_bias_exactness():
    """If the n dropped tokens are IDENTICAL, attending over [kept, fused]
    with the fused token biased by +log(n) reproduces full attention over
    [kept, n copies] exactly: exp(s + log n) = n exp(s)."""
    B, H, D, n_kept, n_drop = 1, 2, 64, 5, 7
    kept_k, kept_v, q = _arrays((B, n_kept + 1, H * D), seed=9)
    kept_k, kept_v = kept_k[:, :n_kept], kept_v[:, :n_kept]
    one_k, one_v = _arrays((B, 1, H * D), n=2, seed=10)
    cat = np.concatenate
    k_full = torch.from_numpy(cat([kept_k] + [one_k] * n_drop, axis=1))
    v_full = torch.from_numpy(cat([kept_v] + [one_v] * n_drop, axis=1))
    q_full = torch.from_numpy(cat([q[:, :n_kept]] + [q[:, n_kept:]] * n_drop, axis=1))
    want = TFA.flash_attention_packed(q_full, k_full, v_full, D ** -0.5, H)
    bias = torch.zeros(B, n_kept + 1)
    bias[:, -1] = float(np.log(n_drop))
    got = TFA.flash_attention_packed_bias(
        torch.from_numpy(q), torch.from_numpy(cat([kept_k, one_k], axis=1)),
        torch.from_numpy(cat([kept_v, one_v], axis=1)), bias, D ** -0.5, H)
    # float32 rounding of exp and the sums only
    torch.testing.assert_close(got, want[:, :n_kept + 1], atol=1e-6, rtol=1e-5)


# ---------------------------------------------------- filter functions ----
@functools.lru_cache(maxsize=None)
def _backbone(gelu=True):
    """(JAX params, the port's float32 backbone carrying them); read only."""
    jcfg = JD.DinoV2Config(**VIT, gelu_approx=gelu)
    params = JD.init(jax.random.PRNGKey(1), jcfg)
    model = TD.DinoV2(TD.DinoV2Config(**VIT, gelu_approx=gelu), device="cpu")

    class Wrap(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.backbone = model

    load_flat_params(Wrap(), {f"backbone/{k}": v for k, v in flatten_tree(params).items()})
    return jcfg, params, model


def _layer(params, i):
    return jax.tree.map(lambda a: a[i], params["layers"])


def _stream(seed=0, B=2):
    """A token stream [B, 1 + P, D] and the importances of layer 1 on it."""
    jcfg, params, model = _backbone()
    x = np.random.RandomState(seed).randn(B, 1 + P, VIT["hidden_size"]).astype(np.float32)
    imp = np.asarray(JD._cls_importance(_layer(params, 1), jnp.asarray(x), jcfg))
    return x, imp


def _guided_weights(B):
    """Mask-table-like weights: tiers 5 / 2 / 1 over the 8x8 grid."""
    kw = np.ones((B, P), np.float32)
    kw[:, 18:22] = 5.0
    kw[:, 26:30] = 2.0
    kw[1, 40:44] = 3.0
    return kw


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cls_importance_matches_jax(dtype):
    jcfg, params, model = _backbone()
    (x,) = _arrays((2, 1 + P, VIT["hidden_size"]), n=1, seed=5)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    lp = jax.tree.map(lambda a: a.astype(jdt), _layer(params, 2))  # the forward's cast
    want = JD._cls_importance(lp, jnp.asarray(x).astype(jdt), jcfg)
    with torch.no_grad():
        got = TD._cls_importance(model.layers[2], torch.from_numpy(x).to(tdt))
    assert got.dtype == torch.float32 and got.shape == (2, P)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)
    assert (got.sum(-1) <= 1.0 + 1e-6).all()  # the CLS column is left out


def test_cls_importance_int8_dequantises_the_weight_rows():
    """Under the int8 policy the ranking reads wq * s: row slices of the
    port's [3D, D] weight, column slices of the JAX package's [D, 3D]."""
    from cognitive_aim_tpu.kernels.int8_ops import quantize_backbone_layers

    jcfg, params, _ = _backbone()
    model = TD.DinoV2(TD.DinoV2Config(**VIT, gelu_approx=True), device="cpu")

    class Wrap(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.backbone = model

    load_flat_params(Wrap(), {f"backbone/{k}": v for k, v in flatten_tree(params).items()})
    blk = model.layers[1].quantize_(torch.bfloat16)
    (x,) = _arrays((2, 1 + P, VIT["hidden_size"]), n=1, seed=6)
    jl = quantize_backbone_layers(params["layers"])
    lp = jax.tree_util.tree_map_with_path(  # the forward's cast rule
        lambda path, a: a if any(getattr(p, "key", None) == "wq" for p in path)
        else a.astype(jnp.bfloat16), jax.tree.map(lambda a: a[1], jl))
    want = JD._cls_importance(lp, jnp.asarray(x).astype(jnp.bfloat16), jcfg)
    with torch.no_grad():
        got = TD._cls_importance(blk, torch.from_numpy(x).bfloat16())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FN_TOL)


@pytest.mark.parametrize("guided", [False, True])
@pytest.mark.parametrize("ctx_frac", [0.0, 0.25])
def test_keep_indices_match_jax(ctx_frac, guided):
    x, imp = _stream(seed=1)
    kw = _guided_weights(2) if guided else None
    want = JD._keep_indices(jnp.asarray(imp), None if kw is None else jnp.asarray(kw), 20,
                            ctx_frac)
    got = TD._keep_indices(torch.from_numpy(imp), None if kw is None else torch.from_numpy(kw),
                           20, ctx_frac)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.diff(got.numpy(), axis=1) > 0).all()  # ascending, no repeats


def test_keep_indices_prefer_the_lower_index_on_ties():
    """``jax.lax.top_k`` takes the lower index among equal values."""
    imp = np.full((1, 12), 0.05, np.float32)
    imp[0, 7] = 0.2
    want = JD._keep_indices(jnp.asarray(imp), None, 4)
    got = TD._keep_indices(torch.from_numpy(imp), None, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [[0, 1, 2, 7]])


FUSE_CASES = {"no_fuse": dict(fuse=False), "fuse": dict(fuse=True),
              "fuse_groups": dict(fuse=True, groups=True),
              "fuse_ctx": dict(fuse=True, ctx_frac=0.25)}


def _groups():
    ids, n = TD._fuse_group_ids(IMG // 14, IMG // 14, 4)
    return ids, n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(FUSE_CASES))
def test_filter_and_refilter_tokens_match_jax(case, dtype):
    """Stage 1 (``_filter_tokens``) and stage 2 (``_refilter_tokens``) on the
    same stream, importances and guidance weights."""
    opts = FUSE_CASES[case]
    x, imp = _stream(seed=2)
    kw = _guided_weights(2)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = FN_TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)  # one bf16 step
    ids, n_groups = _groups() if opts.get("groups") else (None, 1)
    ctx = opts.get("ctx_frac", 0.0)
    k1, k2 = 30, 12
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    wx, widx = JD._filter_tokens(jx, jnp.asarray(imp), jnp.asarray(kw), k1, fuse=opts["fuse"],
                                 fuse_groups=ids, fuse_n_groups=n_groups, ctx_frac=ctx)
    gx, gidx = TD._filter_tokens(tx, torch.from_numpy(imp), torch.from_numpy(kw), k1,
                                 fuse=opts["fuse"],
                                 fuse_groups=None if ids is None else torch.from_numpy(ids),
                                 fuse_n_groups=n_groups, ctx_frac=ctx)
    n_fused = (n_groups if opts["fuse"] else 0)
    assert gx.shape == (2, 1 + k1 + n_fused, x.shape[-1]) and gx.dtype == tdt
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(widx))
    np.testing.assert_allclose(gx.float().numpy(), np.asarray(wx.astype(jnp.float32)), **tol)

    # stage 2 on the JAX stage-1 stream, so both sides start from equal values
    s1 = np.asarray(wx.astype(jnp.float32))
    imp2 = np.random.RandomState(7).rand(2, k1 + n_fused).astype(np.float32) / k1
    kw_g = np.take_along_axis(kw, np.asarray(widx), axis=1)
    gg = None if ids is None else ids[np.asarray(widx)]
    wx2, widx2 = JD._refilter_tokens(
        jnp.asarray(s1).astype(jdt), jnp.asarray(imp2), k1, jnp.asarray(kw_g), k2,
        fuse=opts["fuse"], groups_gathered=None if gg is None else jnp.asarray(gg),
        n_groups=n_groups, ctx_frac=ctx)
    gx2, gidx2 = TD._refilter_tokens(
        torch.from_numpy(s1).to(tdt), torch.from_numpy(imp2), k1, torch.from_numpy(kw_g), k2,
        fuse=opts["fuse"], groups_gathered=None if gg is None else torch.from_numpy(gg),
        n_groups=n_groups, ctx_frac=ctx)
    np.testing.assert_array_equal(gidx2.numpy(), np.asarray(widx2))
    np.testing.assert_allclose(gx2.float().numpy(), np.asarray(wx2.astype(jnp.float32)), **tol)


def test_scatter_tokens_matches_jax():
    x, imp = _stream(seed=3)
    idx = np.asarray(JD._keep_indices(jnp.asarray(imp), None, 10))
    (short,) = _arrays((2, 1 + 10 + 4, x.shape[-1]), n=1, seed=8)  # 4 context tokens
    want = JD._scatter_tokens(jnp.asarray(x), jnp.asarray(short), jnp.asarray(idx))
    got = TD._scatter_tokens(torch.from_numpy(x), torch.from_numpy(short),
                             torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_refilter_fused_count_mismatch_raises():
    x, imp = _stream(seed=2)
    with pytest.raises(ValueError, match="mismatch"):
        TD._refilter_tokens(torch.from_numpy(x[:, :1 + 10 + 2]), torch.from_numpy(imp[:, :12]),
                            10, None, 4, fuse=True,
                            groups_gathered=torch.zeros(2, 10, dtype=torch.long), n_groups=4)


def test_guided_region_always_kept():
    x, imp = _stream(seed=4)
    kw = np.ones((2, P), np.float32)
    kw[:, 5:9] = 5.0
    _, idx = TD._filter_tokens(torch.from_numpy(x), torch.from_numpy(imp),
                               torch.from_numpy(kw), 6)
    for b in range(2):
        assert {5, 6, 7, 8}.issubset(set(idx[b].tolist()))
        assert (np.diff(idx[b].numpy()) > 0).all()  # ascending: spatial order kept


# ------------------------------------------- merge mode, delta correction ----
def test_cls_importance_returns_the_key_projection():
    jcfg, params, model = _backbone()
    (x,) = _arrays((2, 1 + P, VIT["hidden_size"]), n=1, seed=5)
    wimp, wkeys = JD._cls_importance(_layer(params, 2), jnp.asarray(x), jcfg, return_keys=True)
    with torch.no_grad():
        imp, keys = TD._cls_importance(model.layers[2], torch.from_numpy(x), return_keys=True)
    assert keys.shape == (2, 1 + P, VIT["hidden_size"]) and keys.dtype == torch.float32
    np.testing.assert_allclose(imp.numpy(), np.asarray(wimp), **FN_TOL)
    np.testing.assert_allclose(keys.numpy(), np.asarray(wkeys), atol=1e-5, rtol=1e-5)


def test_complement_indices_match_jax_and_survive_a_boundary_tie():
    imp = np.full((2, 12), 0.05, np.float32)  # every priority tied at the boundary
    imp[0, 7] = 0.2
    idx = np.array(JD._keep_indices(jnp.asarray(imp), None, 4))
    want = JD._complement_indices(jnp.asarray(idx), 12, 8)
    got = TD._complement_indices(torch.from_numpy(idx), 12, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for b in range(2):  # a partition: nothing in both sets, nothing in neither
        assert sorted(idx[b].tolist() + got[b].tolist()) == list(range(12))


def _assign_gap(keys, idx, idx_drop):
    """Lead of every dropped token's best cosine similarity over its second."""
    kn = keys / np.sqrt((keys * keys).sum(-1, keepdims=True) + 1e-12)
    take = lambda a, i: np.take_along_axis(a, i[..., None], axis=1)  # noqa: E731
    sim = np.einsum("bjd,bkd->bjk", take(kn, idx_drop), take(kn, idx))
    top = -np.sort(-sim, axis=-1)
    return float((top[..., 0] - top[..., 1]).min())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_filter_and_refilter_tokens_merge_match_jax(dtype):
    """Stage 1 (``_filter_tokens_merge``), ``_assign_dropped`` and stage 2
    (``_refilter_tokens_merge``) on the same stream, importances, keys and
    guidance weights: identical kept indices, slot maps and sizes."""
    x, imp = _stream(seed=2)
    (keys,) = _arrays((2, 1 + P, VIT["hidden_size"]), n=1, seed=21)
    kw = _guided_weights(2)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tol = FN_TOL if dtype == "float32" else dict(atol=2e-2, rtol=2e-2)  # one bf16 step
    k1, k2 = 30, 12
    want = JD._filter_tokens_merge(jnp.asarray(x).astype(jdt), jnp.asarray(imp),
                                   jnp.asarray(keys), jnp.asarray(kw), k1)
    got = TD._filter_tokens_merge(torch.from_numpy(x).to(tdt), torch.from_numpy(imp),
                                  torch.from_numpy(keys), torch.from_numpy(kw), k1)
    wx, widx, wrep, wsizes = (np.asarray(a.astype(jnp.float32) if a.dtype == jdt else a)
                              for a in want)
    drop = np.asarray(JD._complement_indices(jnp.asarray(widx), P, P - k1))
    assert _assign_gap(keys[:, 1:], widx, drop) > MIN_GAP, "pick another seed"
    assert got[0].dtype == tdt and got[0].shape == (2, 1 + k1, x.shape[-1])
    np.testing.assert_array_equal(got[1].numpy(), widx)
    np.testing.assert_array_equal(got[2].numpy(), wrep)
    np.testing.assert_array_equal(got[3].numpy(), wsizes)
    assert got[3].sum(1).tolist() == [float(P)] * 2  # every token stands in one group
    np.testing.assert_allclose(got[0].float().numpy(), wx, **tol)

    wdrop, wassign = JD._assign_dropped(jnp.asarray(imp), jnp.asarray(keys), None,
                                        jnp.asarray(widx), k1)
    gdrop, gassign = TD._assign_dropped(torch.from_numpy(imp), torch.from_numpy(keys),
                                        torch.from_numpy(widx), k1)
    np.testing.assert_array_equal(gdrop.numpy(), np.asarray(wdrop))
    np.testing.assert_array_equal(gassign.numpy(), np.asarray(wassign))

    # stage 2 on the JAX stage-1 stream, so both sides start from equal values
    imp2 = np.random.RandomState(7).rand(2, k1).astype(np.float32) / k1
    (keys2,) = _arrays((2, 1 + k1, VIT["hidden_size"]), n=1, seed=22)
    kw_g = np.take_along_axis(kw, widx, axis=1)
    want2 = JD._refilter_tokens_merge(jnp.asarray(wx).astype(jdt), jnp.asarray(imp2),
                                      jnp.asarray(keys2), k1, jnp.asarray(kw_g), k2,
                                      jnp.asarray(wsizes))
    got2 = TD._refilter_tokens_merge(torch.from_numpy(wx).to(tdt), torch.from_numpy(imp2),
                                     torch.from_numpy(keys2), k1, torch.from_numpy(kw_g), k2,
                                     torch.from_numpy(wsizes))
    widx2 = np.asarray(want2[1])
    drop2 = np.asarray(JD._complement_indices(jnp.asarray(widx2), k1, k1 - k2))
    assert _assign_gap(keys2[:, 1:], widx2, drop2) > MIN_GAP, "pick another seed"
    for g, w in zip(got2[1:], want2[1:]):  # idx_local, slot_map, new sizes
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got2[3].sum(1).tolist() == [float(P)] * 2
    np.testing.assert_allclose(got2[0].float().numpy(),
                               np.asarray(want2[0].astype(jnp.float32)), **tol)


def test_merge_keep_all_maps_every_position_to_itself():
    x, imp = _stream(seed=3)
    out, idx, rep, sizes = TD._filter_tokens_merge(
        torch.from_numpy(x), torch.from_numpy(imp), torch.from_numpy(x), None, P)
    assert torch.equal(out, torch.from_numpy(x)) and torch.equal(rep, idx)
    assert sizes.tolist() == [[1.0] * P] * 2
    np.testing.assert_array_equal(TD._prop_bias_merge(sizes).numpy(), np.zeros((2, 1 + P)))


def test_merged_positions_read_their_representatives_row():
    """After merge mode every patch position equals the row of the kept
    token that stands for it: kept positions differ pairwise, a dropped one
    repeats a kept one; '@d' instead leaves every position its own value."""
    _, _, model = _backbone()
    x = torch.from_numpy(_images(2, seed=14))
    out, idx = model.forward_with_kept(x, filter_layer=2, filter_keep=0.25, filter_merge=True)
    assert out.shape == (2, 1 + P, VIT["hidden_size"]) and idx.shape == (2, 16)
    for b in range(2):
        rows = out[b, 1:]
        kept = rows[idx[b]]
        assert len(torch.unique(kept, dim=0)) == 16
        # every position is bit-equal to one of the kept rows
        assert bool((rows[:, None] == kept[None]).all(-1).any(-1).all())
    dc, idx_d = model.forward_with_kept(x, filter_layer=2, filter_keep=0.25,
                                        filter_delta_correct=True)
    drop, _ = model.forward_with_kept(x, filter_layer=2, filter_keep=0.25)
    assert torch.equal(idx_d, idx)
    kept_mask = torch.zeros(2, P, dtype=torch.bool).scatter_(1, idx, True)
    assert torch.equal(dc[:, 1:][kept_mask], drop[:, 1:][kept_mask])  # kept tokens: drop mode's
    assert len(torch.unique(dc[0, 1:], dim=0)) == P
    assert not torch.allclose(dc[:, 1:][~kept_mask], drop[:, 1:][~kept_mask])


# ------------------------------------------------------------ backbone ----
SPECS = ["2:0.5", "1:0.6,2:0.3", "1:0.6,2:0.3@f4", "2:0.5@s4", "2:0.4@c0.25",
         "1:0.6,3:0.3@r0.5", "2:0.5@p", "1:0.6,2:0.3@f4@p"]
# merge mode and the delta correction; in bfloat16 an assignment may go to
# another kept token, which moves every position of that group, so the bf16
# test takes the drop-mode specs and the delta correction only
MERGE_SPECS = ["2:0.5@m", "2:0.5@m@p", "1:0.6,2:0.3@m", "1:0.6,2:0.3@m@p@r0.5", "2:0.5@d"]


def _filter_kw(spec):
    """parse_token_filter's arch fields as ``filter_*`` keyword arguments."""
    return {k.replace("token_filter_", "filter_"): v
            for k, v in parse_token_filter(spec).items()}


def _record_keep_indices(monkeypatch, module, jax_side):
    """Wrap a module's ``_keep_indices``; returns the list that receives
    (priority, kept indices, k_keep, ctx_frac) of every call. On the JAX
    side the values leave the jitted forward through a callback."""
    calls = []
    orig = module._keep_indices

    def wrapped(importance, keep_weights, k_keep, ctx_frac=0.0):
        idx = orig(importance, keep_weights, k_keep, ctx_frac)
        prio = importance
        if keep_weights is not None:
            prio = prio + 10.0 * (keep_weights - 1.0)

        def keep(p, i):
            calls.append((np.asarray(p, np.float32), np.asarray(i), k_keep, ctx_frac))

        if jax_side:
            jax.debug.callback(keep, prio, idx, ordered=True)
        else:
            keep(prio, idx)
        return idx

    monkeypatch.setattr(module, "_keep_indices", wrapped)
    return calls


def _jax_backbone(jcfg, params, x, guide=None, **kw):
    """The JAX forward as one jitted graph (op-by-op dispatch compiles every
    primitive on its own and takes several times longer here)."""
    fn = jax.jit(lambda p, im, w: JD.apply(p, im, jcfg, attn_impl="xla", keep_weights=w, **kw))
    out = fn(params, jnp.asarray(x), guide)
    jax.effects_barrier()
    return out


def _record_assign_gaps(monkeypatch):
    """Wrap the port's ``_nearest_kept``; returns the list that receives the
    smallest lead of an argmax over its runner-up, per call."""
    gaps = []
    orig = TD._nearest_kept

    def wrapped(keys, idx, idx_drop):
        gaps.append(_assign_gap(keys.numpy(), idx.numpy(), idx_drop.numpy()))
        return orig(keys, idx, idx_drop)

    monkeypatch.setattr(TD, "_nearest_kept", wrapped)
    return gaps


def _boundary_gap(prio, k):
    s = -np.sort(-prio, axis=1)
    return float((s[:, k - 1] - s[:, k]).min())


@pytest.mark.parametrize("spec", SPECS + MERGE_SPECS)
def test_filtered_backbone_matches_jax_f32(spec, monkeypatch):
    """Strict float32, guided: identical kept indices at every stage (and,
    with a gap at every argmax, identical assignments), the outputs to
    float32 rounding."""
    jcfg, params, model = _backbone(gelu=False)
    x = _images(2, seed=15)  # every keep boundary of every spec is > 4e-5 wide
    kw = _guided_weights(2)
    fkw = _filter_kw(spec)
    jcalls = _record_keep_indices(monkeypatch, JD, jax_side=True)
    tcalls = _record_keep_indices(monkeypatch, TD, jax_side=False)
    gaps = _record_assign_gaps(monkeypatch)
    want = _jax_backbone(jcfg, params, x, guide=jnp.asarray(kw), **fkw)
    got, idx = model.forward_with_kept(torch.from_numpy(x), compute_dtype=torch.float32,
                                       attn_impl="pallas_packed",
                                       keep_weights=torch.from_numpy(kw), **fkw)
    n_stages = len(fkw.get("filter_schedule", ())) or 1
    assert len(jcalls) == len(tcalls) == n_stages
    assert len(gaps) == (n_stages if spec in MERGE_SPECS else 0)
    assert all(g > MIN_GAP for g in gaps), f"pick another seed: {gaps}"
    for (jprio, jidx, k, ctx), (tprio, tidx, _, _) in zip(jcalls, tcalls):
        if not ctx:  # with a reserve the boundary is that of two rankings
            assert _boundary_gap(jprio, k) > MIN_GAP, "pick another seed"
        np.testing.assert_allclose(tprio, jprio, atol=2e-6)
        np.testing.assert_array_equal(tidx, jidx)
    assert got.shape == (2, 1 + P, VIT["hidden_size"])
    assert idx.shape == (2, tcalls[-1][2])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_BACKBONE_TOL)


@pytest.mark.parametrize("spec", SPECS + ["2:0.5@d"])
def test_filtered_backbone_matches_jax_bf16(spec):
    """bfloat16, unguided: the two frameworks round at other places, so a
    token at a keep boundary may swap, and that position's output then
    differs by O(1). All outputs within atol 1e-2 but for the positions of
    at most 2 swapped tokens a sample (2 of 64, 4% of the elements)."""
    jcfg, params, model = _backbone()
    x = _images(2, seed=12)
    fkw = _filter_kw(spec)
    want = _jax_backbone(jcfg, params, x, compute_dtype=jnp.bfloat16, **fkw)
    got = model(torch.from_numpy(x), compute_dtype=torch.bfloat16,
                attn_impl="pallas_packed", **fkw)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
    bad_tokens = (err.max(axis=-1) > BF16_TOL["atol"] * 4).sum(axis=1)  # per sample
    assert (bad_tokens <= 4).all(), bad_tokens
    assert np.median(err) < 1e-2


def test_keep_all_is_exact():
    """keep=0.999 rounds to k = P: the filter machinery runs (gather, split
    run, scatter) and must reproduce the unfiltered forward."""
    _, _, model = _backbone()
    x = torch.from_numpy(_images(2, seed=13))
    ref = model(x)
    out, idx = model.forward_with_kept(x, filter_layer=2, filter_keep=0.999)
    assert idx.shape == (2, P)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


def test_dropped_tokens_keep_their_filter_point_values():
    _, _, model = _backbone()
    x = torch.from_numpy(_images(2, seed=14))
    out, idx = model.forward_with_kept(x, filter_layer=2, filter_keep=0.25)
    ref = model(x)
    frozen = model._run(model.embed(x, torch.float32), 0, 2, "plain")
    frozen = torch.nn.functional.layer_norm(frozen, (VIT["hidden_size"],),
                                            model.final_norm.weight, model.final_norm.bias,
                                            model.final_norm.eps)
    dropped = torch.ones(2, P, dtype=torch.bool).scatter_(1, idx, False)
    torch.testing.assert_close(out[:, 1:][dropped], frozen[:, 1:][dropped])
    assert not torch.allclose(out[:, 1:], ref[:, 1:])
    assert idx.shape == (2, 16)


def test_prop_attn_reaches_the_biased_attention(monkeypatch):
    """Under '@p' every post-filter block gets the bias row (K7's route, K10b's
    with the int8 first product); without it none does."""
    _, _, model = _backbone()
    x = torch.from_numpy(_images(1, seed=15))
    seen = []
    orig = TD.attend

    def spy(attn_impl, q, k, v, k_bias, scale, num_heads):
        seen.append((attn_impl, q.shape[1], None if k_bias is None else tuple(k_bias.shape)))
        return orig(attn_impl, q, k, v, k_bias, scale, num_heads)

    monkeypatch.setattr(TD, "attend", spy)
    model(x, attn_impl="pallas_packed_i8qk", **_filter_kw("1:0.5@f4@p"))
    n = 1 + 32 + 4
    assert seen == [("pallas_packed_i8qk", 1 + P, None)] + \
        [("pallas_packed_i8qk", n, (1, n))] * 3
    seen.clear()
    model(x, attn_impl="plain", **_filter_kw("1:0.5"))
    assert [s[2] for s in seen] == [None] * 4


BAD_SCHEDULES = {
    "duplicate_layer": (dict(filter_schedule=((2, 0.5), (2, 0.25))), "strictly increasing"),
    "keep_increases": (dict(filter_schedule=((1, 0.25), (2, 0.5))), "strictly decreasing"),
    "ctx_frac_one": (dict(filter_layer=2, filter_keep=0.25, filter_ctx_frac=1.0), "ctx_frac"),
    "prop_without_fuse": (dict(filter_layer=2, filter_keep=0.25, filter_fuse=False,
                               filter_prop_attn=True), "prop_attn"),
    "fuse_k_not_square": (dict(filter_layer=2, filter_keep=0.25, filter_fuse_k=3),
                          "perfect square"),
    "delta_with_merge": (dict(filter_layer=2, filter_keep=0.25, filter_delta_correct=True,
                              filter_merge=True), "single-stage drop-mode"),
    "delta_progressive": (dict(filter_schedule=((1, 0.5), (2, 0.25)),
                               filter_delta_correct=True), "single-stage drop-mode"),
    "fuse_k_with_merge": (dict(filter_layer=2, filter_keep=0.25, filter_fuse_k=4,
                               filter_merge=True), "drop-mode only"),
    "fuse_k_with_delta": (dict(filter_layer=2, filter_keep=0.25, filter_fuse_k=4,
                               filter_delta_correct=True), "drop-mode only"),
}


@pytest.mark.parametrize("case", list(BAD_SCHEDULES))
def test_schedule_validation(case):
    """The JAX package's validation, with its messages."""
    jcfg, params, model = _backbone()
    kw, match = BAD_SCHEDULES[case]
    x = _images(1, seed=16)
    with pytest.raises(ValueError, match=match):
        model(torch.from_numpy(x), **kw)
    with pytest.raises(ValueError, match=match):
        JD.apply(params, jnp.asarray(x), jcfg, **kw)


@pytest.mark.parametrize("option", ["filter_merge", "filter_delta_correct"])
def test_merge_and_delta_correct_raise(option):
    """Both modes run; what raises is what the JAX package refuses: '@d' with
    '@m' or a progressive schedule, and '@p' without fuse only in drop mode."""
    _, _, model = _backbone()
    x = torch.from_numpy(_images(1, seed=16))
    out, idx = model.forward_with_kept(x, filter_layer=2, filter_keep=0.5, **{option: True})
    assert out.shape == (1, 1 + P, VIT["hidden_size"]) and idx.shape == (1, P // 2)
    spec = "2:0.5@m" if option == "filter_merge" else "2:0.5@d"
    tm = TModel(TCfg.ModelArchConfig(**parse_token_filter(spec)), device="cpu",
                vit_cfg=TD.DinoV2Config(**VIT))
    assert tm.backbone_kwargs(x)[option] is True
    with pytest.raises(ValueError, match="single-stage drop-mode"):
        model(x, filter_layer=2, filter_keep=0.5, filter_merge=True,
              filter_delta_correct=True)
    # '@p' without the fused token: refused in drop mode, fine in merge mode
    kw = dict(filter_layer=2, filter_keep=0.5, filter_fuse=False, filter_prop_attn=True)
    if option == "filter_merge":
        model(x, filter_merge=True, **kw)
    else:
        with pytest.raises(ValueError, match="prop_attn"):
            model(x, filter_delta_correct=True, **kw)
    # a schedule with no active stage filters nothing and raises nothing
    assert model.forward_with_kept(x, filter_layer=0, **{option: True})[1] is None


# --------------------------------------------------------- whole model ----
MODEL_CASES = {
    # name: (JAX policy, port policy, JAX attn_impl, port attn_impl, tolerance)
    "f32": (JP.Policy(backbone_compute_dtype=jnp.float32),
            TP.Policy(backbone_compute_dtype=torch.float32), "xla", "pallas_packed", F32_TOL),
    "bf16": (JP.DEFAULT_POLICY, TP.DEFAULT_POLICY, "xla", "pallas_packed", BF16_TOL),
    "bf16_i8qk": (JP.DEFAULT_POLICY, TP.DEFAULT_POLICY, "pallas_packed_i8qk",
                  "pallas_packed_i8qk", BF16_TOL),
    "int8": (JP.INT8_BACKBONE, TP.INT8_BACKBONE, "pallas_packed", "pallas_packed", BF16_TOL),
    "int8_i8qk": (JP.INT8_BACKBONE, TP.INT8_BACKBONE, "pallas_packed_i8qk",
                  "pallas_packed_i8qk", BF16_TOL),
}
MODEL_SPEC = "1:0.6,2:0.3@f4@p"


@functools.lru_cache(maxsize=None)
def _model_params(arch):
    jm = JModel(arch, vit_cfg=JD.DinoV2Config(**VIT))
    params = jm.init(jax.random.PRNGKey(0))
    return params, flatten_tree(params)


def _model_pair(case, spec=MODEL_SPEC):
    jp, tp, jimpl, timpl, _ = MODEL_CASES[case]
    arch = ModelArchConfig(num_iterations=2, image_size=IMG, **parse_token_filter(spec))
    params, flat = _model_params(arch)
    jm = JModel(arch, policy=jp, attn_impl=jimpl,
                vit_cfg=JD.DinoV2Config(**VIT, gelu_approx=True))
    tm = TModel(TCfg.ModelArchConfig(**dataclasses.asdict(arch)), policy=tp, attn_impl=timpl,
                device="cpu", vit_cfg=TD.DinoV2Config(**VIT, gelu_approx=True))
    load_flat_params(tm, flat)
    return jm, jm.prepare_params(params), tm.prepare_params()


@pytest.mark.parametrize("guided", [False, True], ids=["unguided", "guided"])
@pytest.mark.parametrize("case", list(MODEL_CASES))
def test_filtered_model_matches_jax(case, guided, pallas_interpret):
    jm, params, tm = _model_pair(case)
    tol = MODEL_CASES[case][4]
    x = _images(3, seed=17)
    g = np.asarray([0, 4, 8], np.int32) if guided else None
    want = jax.jit(lambda p, im, gi: jm.apply(p, im, None, noise_mode=JNoise.ZEROS,
                                              guidance=gi))(
        params, jnp.asarray(x), None if g is None else jnp.asarray(g))
    got = tm(torch.from_numpy(x), None, noise_mode=NoiseMode.ZEROS,
             guidance=None if g is None else torch.from_numpy(g))
    for field in ("depth", "confidence", "attention"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   err_msg=f"{case} {field}", **tol)


@pytest.mark.parametrize("spec", ["2:0.5@m@p", "2:0.5@d"])
@pytest.mark.parametrize("case", ["f32", "bf16", "int8"])
def test_merge_and_delta_model_matches_jax(case, spec, pallas_interpret):
    """The whole model, guided, in merge mode with proportional attention
    (every block after the filter point carries a bias row: K7's route) and
    with the delta correction."""
    jm, params, tm = _model_pair(case, spec)
    tol = MODEL_CASES[case][4]
    x = _images(3, seed=19)
    g = np.asarray([0, 4, 8], np.int32)
    want = jax.jit(lambda p, im, gi: jm.apply(p, im, None, noise_mode=JNoise.ZEROS,
                                              guidance=gi))(params, jnp.asarray(x),
                                                            jnp.asarray(g))
    got = tm(torch.from_numpy(x), None, noise_mode=NoiseMode.ZEROS,
             guidance=torch.from_numpy(g))
    for field in ("depth", "confidence", "attention"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   err_msg=f"{case} {spec} {field}", **tol)


def test_merge_prop_attn_biases_every_block_after_the_filter(monkeypatch):
    _, _, model = _backbone()
    x = torch.from_numpy(_images(1, seed=15))
    seen = []
    orig = TD.attend

    def spy(attn_impl, q, k, v, k_bias, scale, num_heads):
        seen.append((q.shape[1], None if k_bias is None else k_bias.clone()))
        return orig(attn_impl, q, k, v, k_bias, scale, num_heads)

    monkeypatch.setattr(TD, "attend", spy)
    model(x, attn_impl="pallas_packed", **_filter_kw("1:0.5,3:0.25@m@p"))
    assert [n for n, _ in seen] == [1 + P, 1 + 32, 1 + 32, 1 + 16]
    assert seen[0][1] is None
    for n, bias in seen[1:]:  # log group sizes: CLS 0, the groups hold all P tokens
        assert bias.shape == (1, n) and float(bias[0, 0]) == 0.0
        np.testing.assert_allclose(float(bias[0, 1:].exp().sum()), P, rtol=1e-5)


def test_filtered_model_scalar_instruction_and_filter_effect():
    """A scalar instruction broadcasts its mask row over the batch; the
    filter changes the answer (it is on), '@c' is a no-op without guidance."""
    jm, params, tm = _model_pair("f32", "2:0.3")
    x = _images(2, seed=18)
    want = jax.jit(lambda p, im: jm.apply(p, im, None, guidance=7,
                                          noise_mode=JNoise.ZEROS))(params, jnp.asarray(x))
    got = tm(torch.from_numpy(x), None, guidance=7, noise_mode=NoiseMode.ZEROS)
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth), **F32_TOL)
    kw = tm.backbone_kwargs(torch.from_numpy(x), 7)
    assert kw["keep_weights"].shape == (2, P) and kw["filter_keep"] == 0.3
    _, _, exact = _model_pair("f32", "")
    assert "filter_keep" not in exact.backbone_kwargs(torch.from_numpy(x), 7)
    ref = exact(torch.from_numpy(x), None, guidance=7, noise_mode=NoiseMode.ZEROS)
    assert not torch.allclose(ref.depth, got.depth, atol=1e-6, rtol=0)
    _, _, ctx = _model_pair("f32", "2:0.3@c0.5")
    a = tm(torch.from_numpy(x), None, noise_mode=NoiseMode.ZEROS)
    b = ctx(torch.from_numpy(x), None, noise_mode=NoiseMode.ZEROS)
    assert torch.equal(a.depth, b.depth)
