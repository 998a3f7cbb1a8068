"""The port's int8 scheme and chained int8 block against the JAX package.

``kernels/int8_ops.py`` and ``kernels/int8_block.py`` of the port against
their JAX counterparts on the same inputs (numpy seed; B 2, N 70, D 128,
F 256). The JAX side runs its Pallas kernels in interpret mode on the CPU
(as tests/test_kernels.py does); the port's wrappers get CPU tensors, so
they run their plain PyTorch versions. The CUDA kernels themselves are
compared with the plain versions in tests/test_torch_cuda.py.

Weights: JAX keeps [K, N] and scales per column, the port [N, K] and scales
per row; the same values, transposed.

Tolerances, those of the JAX package's own kernel tests
(tests/test_kernels.py): f32 outputs atol 2e-4 / rtol 2e-3 (qkv: 2e-5 /
2e-4); int8 outputs may differ by 1 in under 1% of the elements (tanh and
the layernorm sums differ in the last ulp between the frameworks, which
moves a value across a rounding boundary); row scales rtol 2e-4. The weight
quantisation and the integer products are exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cognitive_aim_tpu.kernels import int8_block as JIB
from cognitive_aim_tpu.kernels import int8_gemm as JIG
from cognitive_aim_tpu.kernels import int8_ops as JI8
from cognitive_aim_tpu_torch.kernels import int8_block as TIB
from cognitive_aim_tpu_torch.kernels import int8_gemm as TIG
from cognitive_aim_tpu_torch.kernels import int8_ops as TI8

B, N, D, F = 2, 70, 128, 256
EPS = 1e-6
OUT_TOL = dict(atol=2e-4, rtol=2e-3)
QKV_TOL = dict(atol=2e-5, rtol=2e-4)


@pytest.fixture
def pallas_interpret(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _inputs(seed=0):
    """numpy inputs of one block; weights in the JAX [K, N] layout."""
    r = np.random.RandomState(seed)

    def f(*shape, scale=1.0, shift=0.0):
        return (r.randn(*shape) * scale + shift).astype(np.float32)

    return dict(
        x=f(B, N, D, scale=0.5), res=f(B, N, D, scale=0.5),
        g=f(D, scale=0.1, shift=1.0), be=f(D, scale=0.05),
        w_qkv=f(D, 3 * D, scale=0.05), b_qkv=f(3 * D, scale=0.01),
        w_out=f(D, D, scale=0.05), b_out=f(D, scale=0.01),
        w1=f(D, F, scale=0.05), b1=f(F, scale=0.01),
        w2=f(F, D, scale=0.05), b2=f(D, scale=0.01),
        ls=f(D, scale=0.1, shift=0.9))


def _jq(w):
    """JAX-side quantised weight {'q': [K, N], 's': [N]}."""
    return JI8.quantize_weight(jnp.asarray(w))


def _tq(w):
    """Port-side quantised weight from the same float values, [N, K]."""
    return TI8.quantize_weight(torch.from_numpy(w.T.copy()))


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_int8_close(got, want):
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert np.mean(diff != 0) < 0.01


# -------------------------------------------------------------- int8_ops ----
@pytest.mark.parametrize("name", ["w_qkv", "w_out", "w1", "w2"])
def test_quantize_weight_matches_jax_exactly(name):
    w = _inputs()[name]
    want, got = _jq(w), _tq(w)
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]).T)
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    assert got["q"].dtype == torch.int8 and got["q"].is_contiguous()


def test_quantize_weight_of_a_zero_channel_keeps_the_floor_scale():
    w = torch.zeros(4, 8)
    w[1, 3] = 2.0
    out = TI8.quantize_weight(w)
    assert out["s"][0].item() == pytest.approx(1e-12)
    assert out["q"][1, 3].item() == 127 and out["q"][0].abs().sum().item() == 0


def test_quantize_activations_matches_jax_exactly():
    x = _inputs()["x"]
    wq, ws = JI8.quantize_activations(jnp.asarray(x))
    q, s = TI8.quantize_activations(_t(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))


def test_round_half_even_and_clip():
    """x / s lands on .5 boundaries: round-half-even, as jnp.round."""
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -127.0]])
    q, s = TI8.quantize_activations(x)
    assert s.item() == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0, -2, -127]]


def test_int_matmul_is_exact_beyond_float32():
    """Sums of 127^2 * 3072 exceed 2^24: a float32 product would round."""
    K = 3072
    xq = torch.full((3, K), 127, dtype=torch.int8)
    wq = torch.full((5, K), 127, dtype=torch.int8)
    wq[0, 0] = 126
    acc = TI8.int_matmul(xq, wq)
    assert acc.dtype == torch.int32
    assert acc[0, 1].item() == 127 * 127 * K
    assert acc[0, 0].item() == 127 * 127 * K - 127


@pytest.mark.parametrize("bias", [True, False])
def test_int8_matmul_prequant_and_linear_match_jax(bias):
    t = _inputs()
    jw, tw = _jq(t["w1"]), _tq(t["w1"])
    b = t["b1"] if bias else None
    xq, sx = JI8.quantize_activations(jnp.asarray(t["x"]))
    want = JI8.int8_matmul_prequant(xq, sx, jw, None if b is None else jnp.asarray(b),
                                    jnp.float32)
    got = TI8.int8_matmul_prequant(_t(xq), _t(sx), tw, None if b is None else _t(b),
                                   torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **QKV_TOL)
    want = JI8.int8_linear(jnp.asarray(t["x"]), jw, None if b is None else jnp.asarray(b))
    got = TI8.int8_linear(_t(t["x"]), tw, None if b is None else _t(b))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **QKV_TOL)


def test_quantize_backbone_layers_matches_jax_exactly():
    """Stacked layer tree, fused qkv_i8 included; the port's leaves are the
    JAX leaves with the last two axes swapped."""
    r = np.random.RandomState(1)
    L = 2
    dims = {"q": (D, D), "k": (D, D), "v": (D, D), "attn_out": (D, D),
            "fc1": (D, F), "fc2": (F, D)}
    jl = {n: {"w": (r.randn(L, *kn) * 0.05).astype(np.float32),
              "b": (r.randn(L, kn[1]) * 0.01).astype(np.float32)}
          for n, kn in dims.items()}
    jl["ls1"] = np.ones((L, D), np.float32)
    tl = {n: ({"w": _t(v["w"].transpose(0, 2, 1).copy()), "b": _t(v["b"])}
              if isinstance(v, dict) else _t(v)) for n, v in jl.items()}
    want = JI8.quantize_backbone_layers(
        {n: ({k: jnp.asarray(a) for k, a in v.items()} if isinstance(v, dict)
             else jnp.asarray(v)) for n, v in jl.items()})
    got = TI8.quantize_backbone_layers(tl)
    assert set(got) == set(want)
    for name in (*dims, "qkv_i8"):
        assert "w" not in got[name]
        np.testing.assert_array_equal(got[name]["wq"]["q"].numpy(),
                                      np.asarray(want[name]["wq"]["q"]).transpose(0, 2, 1))
        np.testing.assert_array_equal(got[name]["wq"]["s"].numpy(),
                                      np.asarray(want[name]["wq"]["s"]))
        np.testing.assert_array_equal(got[name]["b"].numpy(), np.asarray(want[name]["b"]))
    assert got["qkv_i8"]["wq"]["q"].shape == (L, 3 * D, D)
    assert torch.equal(got["ls1"], tl["ls1"])


# ------------------------------------------------------------ int8_block ----
def _qkv_case(ln):
    t = _inputs(2)
    jw, tw = _jq(t["w_qkv"]), _tq(t["w_qkv"])
    x, b = t["x"], t["b_qkv"]
    if ln:
        want = JIB.int8_qkv_proj_ln(jnp.asarray(x), jnp.asarray(t["g"]), jnp.asarray(t["be"]),
                                    jw["q"], jw["s"], jnp.asarray(b), eps=EPS, n_block=64,
                                    out_dtype=jnp.float32)
        got = TIB.int8_qkv_proj_ln(_t(x), _t(t["g"]), _t(t["be"]), tw["q"], tw["s"], _t(b),
                                   EPS, torch.float32)
    else:
        want = JIB.int8_qkv_proj(jnp.asarray(x), jw["q"], jw["s"], jnp.asarray(b),
                                 n_block=64, out_dtype=jnp.float32)
        got = TIB.int8_qkv_proj(_t(x), tw["q"], tw["s"], _t(b), torch.float32)
    return got, want


@pytest.mark.parametrize("ln", [True, False], ids=["int8_qkv_proj_ln", "int8_qkv_proj"])
def test_qkv_proj_matches_jax_kernel(ln, pallas_interpret):
    got, want = _qkv_case(ln)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.shape == (B, N, D) and g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **QKV_TOL)


def test_out_residual_matches_jax_kernel(pallas_interpret):
    t = _inputs(3)
    jw, tw = _jq(t["w_out"]), _tq(t["w_out"])
    want = JIB.int8_out_residual(jnp.asarray(t["x"]), jw["q"], jw["s"], jnp.asarray(t["b_out"]),
                                 jnp.asarray(t["ls"]), jnp.asarray(t["res"]), n_block=64)
    got = TIB.int8_out_residual(_t(t["x"]), tw["q"], tw["s"], _t(t["b_out"]), _t(t["ls"]),
                                _t(t["res"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


def _fc1(t, jw, tw):
    want = JIB.int8_fc1_gelu_ln(jnp.asarray(t["x"]), jnp.asarray(t["g"]), jnp.asarray(t["be"]),
                                jw["q"], jw["s"], jnp.asarray(t["b1"]), eps=EPS, n_block=64)
    got = TIB.int8_fc1_gelu_ln(_t(t["x"]), _t(t["g"]), _t(t["be"]), tw["q"], tw["s"],
                               _t(t["b1"]), EPS)
    return got, want


def test_fc1_gelu_ln_matches_jax_kernel(pallas_interpret):
    t = _inputs(4)
    (h8, sh), (jh8, jsh) = _fc1(t, _jq(t["w1"]), _tq(t["w1"]))
    assert h8.dtype == torch.int8 and h8.shape == (B, N, F)
    assert sh.dtype == torch.float32 and sh.shape == (B, N, 1)
    np.testing.assert_allclose(sh.numpy(), np.asarray(jsh), rtol=2e-4)
    _assert_int8_close(h8.numpy(), np.asarray(jh8))


def test_out_residual_prequant_matches_jax_kernel(pallas_interpret):
    """Both sides read the JAX fc1's int8 hidden and scales."""
    t = _inputs(5)
    _, (jh8, jsh) = _fc1(t, _jq(t["w1"]), _tq(t["w1"]))
    jw, tw = _jq(t["w2"]), _tq(t["w2"])
    want = JIB.int8_out_residual_prequant(jh8, jsh, jw["q"], jw["s"], jnp.asarray(t["b2"]),
                                          jnp.asarray(t["ls"]), jnp.asarray(t["x"]),
                                          n_block=64)
    got = TIB.int8_out_residual_prequant(_t(jh8), _t(jsh), tw["q"], tw["s"], _t(t["b2"]),
                                         _t(t["ls"]), _t(t["x"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


def test_mlp_ln_matches_jax_one_kernel_mlp(pallas_interpret):
    """K4 as K4a + K4b against the JAX package's single-kernel MLP."""
    t = _inputs(6)
    j1, t1, j2, t2 = _jq(t["w1"]), _tq(t["w1"]), _jq(t["w2"]), _tq(t["w2"])
    want = JIB.int8_mlp_ln(jnp.asarray(t["x"]), jnp.asarray(t["g"]), jnp.asarray(t["be"]),
                           j1["q"], j1["s"], jnp.asarray(t["b1"]), j2["q"], j2["s"],
                           jnp.asarray(t["b2"]), jnp.asarray(t["ls"]), eps=EPS, n_block=64)
    got = TIB.int8_mlp_ln(_t(t["x"]), _t(t["g"]), _t(t["be"]), t1["q"], t1["s"], _t(t["b1"]),
                          t2["q"], t2["s"], _t(t["b2"]), _t(t["ls"]), EPS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **OUT_TOL)


# K13 at the shapes of a block's projections: (weight, bias, input width)
PROJ_SHAPES = {"attn_out": ("w_out", "b_out", D), "fc1": ("w1", "b1", D),
               "fc2": ("w2", "b2", F), "qkv": ("w_qkv", "b_qkv", D)}


def _proj_input(t, K, seed=0):
    return t["x"] if K == D else (
        np.random.RandomState(seed).randn(B, N, K).astype(np.float32) * 0.5)


@pytest.mark.parametrize("shape", list(PROJ_SHAPES))
def test_int8_proj_matches_jax_kernel(shape, pallas_interpret):
    """K13: no split, any input width (fc2 reads rows F wide)."""
    wname, bname, K = PROJ_SHAPES[shape]
    t = _inputs(10)
    x = _proj_input(t, K)
    jw, tw = _jq(t[wname]), _tq(t[wname])
    want = JIB.int8_proj(jnp.asarray(x), jw["q"], jw["s"], jnp.asarray(t[bname]), n_block=64,
                         out_dtype=jnp.float32)
    got = TIB.int8_proj(_t(x), tw["q"], tw["s"], _t(t[bname]), torch.float32)
    assert got.shape == (B, N, t[wname].shape[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **QKV_TOL)


def test_int8_fc1_gelu_matches_jax_kernel_and_k4a_on_normed_rows(pallas_interpret):
    """K14 against the JAX kernel, and against K4a fed rows that the plain
    layernorm has normalised, with a unit layernorm inside (how the JAX
    package's own tests tie the two)."""
    t = _inputs(11)
    jw, tw = _jq(t["w1"]), _tq(t["w1"])
    jh8, jsh = JIB.int8_fc1_gelu(jnp.asarray(t["x"]), jw["q"], jw["s"], jnp.asarray(t["b1"]),
                                 n_block=64)
    h8, sh = TIB.int8_fc1_gelu(_t(t["x"]), tw["q"], tw["s"], _t(t["b1"]))
    assert h8.dtype == torch.int8 and h8.shape == (B, N, F) and sh.shape == (B, N, 1)
    np.testing.assert_allclose(sh.numpy(), np.asarray(jsh), rtol=2e-4)
    _assert_int8_close(h8.numpy(), np.asarray(jh8))
    normed = TIB._ln_f32(_t(t["x"]), _t(t["g"]), _t(t["be"]), EPS)
    a8, sa = TIB.int8_fc1_gelu(normed, tw["q"], tw["s"], _t(t["b1"]))
    b8, sb = TIB.int8_fc1_gelu_ln(_t(t["x"]), _t(t["g"]), _t(t["be"]), tw["q"], tw["s"],
                                  _t(t["b1"]), EPS)
    assert torch.equal(a8, b8) and torch.equal(sa, sb)


@pytest.mark.parametrize("bias", [True, False])
def test_int8_gemm_fused_matches_jax_kernel(bias, pallas_interpret):
    """K15 on flattened rows, and ``int8_linear_fused`` over leading
    dimensions with a missing bias as zeros and the output in x's dtype."""
    t = _inputs(12)
    jw, tw = _jq(t["w_qkv"]), _tq(t["w_qkv"])
    x2 = t["x"].reshape(B * N, D)
    want = JIG.int8_gemm_fused(jnp.asarray(x2), jw["q"], jw["s"], jnp.asarray(t["b_qkv"]),
                               m_block=64, out_dtype=jnp.float32)
    got = TIG.int8_gemm_fused(_t(x2), tw["q"], tw["s"], _t(t["b_qkv"]), torch.float32)
    assert got.shape == (B * N, 3 * D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **QKV_TOL)
    b = t["b_qkv"] if bias else None
    want = JIG.int8_linear_fused(jnp.asarray(t["x"]), jw, None if b is None else jnp.asarray(b))
    got = TIG.int8_linear_fused(_t(t["x"]), tw, None if b is None else _t(b))
    assert got.shape == (B, N, 3 * D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **QKV_TOL)
    # the function XLA's int8_linear computes, which the other projections take
    np.testing.assert_allclose(got.numpy(), TI8.int8_linear(_t(t["x"]), tw,
                                                            None if b is None else _t(b)).numpy(),
                               **QKV_TOL)


def test_int8_linear_fused_bf16_rounds_once():
    t = _inputs(13)
    tw = _tq(t["w_qkv"])
    x = _t(t["x"]).bfloat16()
    got = TIG.int8_linear_fused(x, tw, _t(t["b_qkv"]))
    assert got.dtype == torch.bfloat16
    f32 = TIG.int8_gemm_fused(x.reshape(B * N, D), tw["q"], tw["s"], _t(t["b_qkv"]),
                              torch.float32)
    assert torch.equal(got, f32.bfloat16().view(B, N, 3 * D))


# ------------------------------------------------ the port's own contracts ----
@pytest.mark.parametrize("F,shape", [(256, (2, 128)), (512, (4, 128)), (1536, (4, 384)),
                                     (3072, (8, 384)), (4096, (8, 512)), (2176, None),
                                     (1280, None), (0, None)])
def test_fc1_cluster_shape_covers_the_model_widths(F, shape):
    """The one-pass fc1 GEMM's cluster: at most 8 CTAs of 2 NW columns each
    own all F columns of a row tile (ViT-S's 1536 in 4, ViT-B's 3072 and
    ViT-L's 4096 in 8 CTAs); a width no such cluster splits (17 x 128, or
    5 x 256: no kernel has 128-column warpgroups) has no kernel."""
    assert TIB.fc1_cluster_shape(F) == shape


def test_fc1_wrappers_raise_on_widths_no_cluster_splits_before_any_launch():
    """The width check comes before the device check of a launch: a CUDA
    tensor is not needed to see it, so it is held here on the plain path's
    inputs by calling the check itself."""
    with pytest.raises(ValueError):
        TIB._check_fc1_width("int8_fc1_gelu", 2176)
    TIB._check_fc1_width("int8_fc1_gelu", 3072)


@pytest.mark.parametrize("M,N,parts,cols", [
    # the ViT-B slice's M 10960 (86 row tiles) on 132 SMs: qkv 2304 in three
    # parts takes 8 rounds of 192 or 12 of 128 (a tie: the wider), N 768 3 of
    # 192 against 4 of 128, N 3072 11 of 192 against 16 of 128
    (10960, 2304, 3, 192), (10952, 2304, 1, 192), (10960, 768, 1, 128),
    (10960, 3072, 1, 128),
    # the filtered stream's 8 x 481 rows (31 row tiles): one round of 192 for
    # N 768 against two of 128
    (3848, 2304, 3, 192), (3848, 768, 1, 192),
    # ViT-S (384, 1152, 1536), ViT-L (1024, 3072 in parts, 4096), test widths
    (10960, 1152, 3, 192), (10960, 384, 1, 128), (10960, 3072, 3, 128),
    (10960, 4096, 1, 128), (17, 384, 3, 128), (17, 256, 1, 128), (1, 960, 1, 192),
    # widths no tile divides
    (10960, 320, 1, None), (17, 192, 3, None), (10960, 0, 1, None), (0, 768, 1, None)])
def test_gemm_tile_cols_covers_the_model_widths(M, N, parts, cols):
    """The int8 GEMM's tile width: of 192 and 128, the one that divides the
    output (each of q, k, v for the qkv GEMMs) and costs the fewest rounds of
    132 tiles times its width, the wider on a tie; None where neither
    divides."""
    assert TIB.gemm_tile_cols(M, N, parts) == cols


def test_gemm_wrappers_raise_on_widths_no_tile_divides_before_any_launch(monkeypatch):
    """The width check comes before the library is built or a launch made:
    the launch paths of K3 / K4b and of K13 / K15, given tensors that pass
    every other check, raise on an output width of 320 (5 x 64) without
    touching the library."""
    from cognitive_aim_tpu_torch.kernels import _build

    def no_library():
        raise AssertionError("the library was reached")

    monkeypatch.setattr(_build, "library", no_library)
    x = torch.zeros(1, 8, 128, dtype=torch.bfloat16)
    w = {"q": torch.zeros(320, 128, dtype=torch.int8), "s": torch.ones(320)}
    b, ls = torch.zeros(320), torch.ones(320)
    res = torch.zeros(1, 8, 320, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="tile"):
        TIB._launch_out_residual("int8_out_residual", x, None, w["q"], w["s"], b, ls, res)
    with pytest.raises(ValueError, match="tile"):
        TIB.launch_int8_linear("int8_proj", "caim_int8_proj", x.view(8, 128), w["q"], w["s"], b)
    x8, s8 = torch.zeros(1, 8, 128, dtype=torch.int8), torch.ones(1, 8, 1)
    with pytest.raises(ValueError, match="tile"):
        TIB._launch_out_residual("int8_out_residual_prequant", x8, s8, w["q"], w["s"], b, ls,
                                 res)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    t = {k: _t(v) for k, v in _inputs(7).items()}
    w1, w2, wo = (_tq(_inputs(7)[n]) for n in ("w1", "w2", "w_out"))
    before = [w.launches for w in TIB.WRAPPERS]
    got = TIB.int8_mlp_ln(t["x"], t["g"], t["be"], w1["q"], w1["s"], t["b1"],
                          w2["q"], w2["s"], t["b2"], t["ls"], EPS)
    want = TIB.int8_mlp_ln_plain(t["x"], t["g"], t["be"], w1["q"], w1["s"], t["b1"],
                                 w2["q"], w2["s"], t["b2"], t["ls"], EPS)
    assert torch.equal(got, want)
    got = TIB.int8_out_residual(t["x"], wo["q"], wo["s"], t["b_out"], t["ls"], t["res"])
    assert torch.equal(got, TIB.int8_out_residual_plain(t["x"], wo["q"], wo["s"], t["b_out"],
                                                        t["ls"], t["res"]))
    assert [w.launches for w in TIB.WRAPPERS] == before


def test_bf16_activations_keep_the_dtype_contract():
    """bf16 in: q, k, v and the residual outputs come back bf16, the hidden
    int8 with f32 scales; the arithmetic between is f32 (one cast at the end)."""
    t = {k: _t(v) for k, v in _inputs(8).items()}
    x, res = t["x"].bfloat16(), t["res"].bfloat16()
    wqkv, w1, w2 = (_tq(_inputs(8)[n]) for n in ("w_qkv", "w1", "w2"))
    q, k, v = TIB.int8_qkv_proj_ln(x, t["g"], t["be"], wqkv["q"], wqkv["s"], t["b_qkv"])
    assert q.dtype == k.dtype == v.dtype == torch.bfloat16
    h8, sh = TIB.int8_fc1_gelu_ln(x, t["g"], t["be"], w1["q"], w1["s"], t["b1"])
    assert (h8.dtype, sh.dtype) == (torch.int8, torch.float32)
    out = TIB.int8_out_residual_prequant(h8, sh, w2["q"], w2["s"], t["b2"], t["ls"], res)
    assert out.dtype == torch.bfloat16
    # the f32 value rounded once: equal to the f32 computation cast to bf16
    f32 = TIB.int8_out_residual_prequant(h8, sh, w2["q"], w2["s"], t["b2"], t["ls"],
                                         res.float())
    assert torch.equal(out, f32.bfloat16())


def test_layernorm_and_gelu_follow_the_kernel_formulas():
    """Variance as the mean of squared deviations with eps inside the rsqrt;
    tanh GELU as torch's own."""
    x = _t(_inputs(9)["x"])
    g, be = _t(_inputs(9)["g"]), _t(_inputs(9)["be"])
    want = torch.nn.functional.layer_norm(x, (D,), g, be, EPS)
    torch.testing.assert_close(TIB._ln_f32(x, g, be, EPS), want, atol=2e-6, rtol=1e-5)
    torch.testing.assert_close(TIB._gelu_tanh(x),
                               torch.nn.functional.gelu(x, approximate="tanh"),
                               atol=1e-6, rtol=1e-5)
