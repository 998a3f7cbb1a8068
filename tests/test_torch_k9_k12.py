"""K9 and K12 as the port's CUDA wrappers run them, against the JAX package,
on the CPU.

  K9   the CUDA wrapper quantises q and k per (row, head) in one launch
       (``quantize_heads``), then runs K10's int8 attention program on
       those scales. Its plain version is that decomposition
       (``quantize_heads_plain``, then ``_i8qk_attend_plain`` on [B, H, N]
       scales), held here to JAX's ``_quant_rows`` on each head's slice, to
       the per-head formulation of the TPU kernel body, and to the JAX kernel
       ``flash_attention_packed(int8_dots=True)`` in interpret mode.
  K12  one kernel, a thread-block cluster of C CTAs a 64-row tile: each CTA
       sums its own columns of a row and the CTAs' sums are added in rank
       order. ``_ln_f32_cluster`` below is that scheme in plain PyTorch, held
       to JAX's ``_ln_f32``; ``attnout_mlp_shape`` is the kernel's shape rule.

The CUDA kernels themselves are held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).

Tolerances, with their reasons:
  * the quantisers: the same IEEE f32 arithmetic on both sides (a true
    division, round half to even, clip): bit-equal. JAX runs ``_quant_rows``
    eagerly here, op by op, as XLA compiles a division by a constant into a
    multiplication inside a jitted function.
  * K9 against the JAX kernel: as tests/test_torch_fused.py, atol 2e-5 / rtol
    2e-4 in float32 (softmax and P V summation order), atol 1e-2 in bfloat16.
  * the cluster layernorm against ``_ln_f32``: the sums are taken in another
    order, so f32 rounding differs: atol 1e-5 on normalised values of
    magnitude up to ~5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cognitive_aim_tpu.kernels import flash_attention as JFA
from cognitive_aim_tpu.kernels import int8_block as JIB
from cognitive_aim_tpu_torch.kernels import flash_attention as TFA
from cognitive_aim_tpu_torch.kernels import int8_block as TIB

KERNEL_TOL = dict(atol=2e-5, rtol=2e-4)
BF16_TOL = dict(atol=1e-2, rtol=0.0)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Runs every ``pallas_call`` in interpret mode (the JAX package's Pallas
    kernels have no CPU lowering) and lists the kernel bodies called."""
    from jax.experimental import pallas as pl

    orig, names = pl.pallas_call, []

    def interp(kernel, *a, **kw):
        names.append(getattr(kernel, "func", kernel).__name__)
        kw["interpret"] = True
        return orig(kernel, *a, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)
    return names


def _arrays(shape, n=3, seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) * scale).astype(np.float32) for _ in range(n)]


def _rows(B, N, H, seed):
    """q [B, N, H*64] with heads of very different sizes, one head's slice of a
    row all zero (the 1e-12 floor), and one head of a row at +-127 steps."""
    (q,) = _arrays((B, N, H * 64), n=1, seed=seed)
    q *= np.random.RandomState(seed + 1).rand(B, N, H).repeat(64, axis=-1) * 5.0
    q[0, 3, :64] = 0.0
    q[0, 5, 64:128] = np.sign(q[0, 5, 64:128])
    return q


# ---------------------------------------------------------------- K9 ----
@pytest.mark.parametrize("B,N,H", [(2, 70, 4), (1, 33, 12), (2, 17, 16)])
def test_k9_head_quantiser_is_jax_quant_rows_on_each_head(B, N, H):
    q = _rows(B, N, H, seed=N)
    q8, sq = TFA.quantize_heads_plain(torch.from_numpy(q), H)
    assert q8.shape == (B, N, H * 64) and q8.dtype == torch.int8
    assert sq.shape == (B, H, N) and sq.dtype == torch.float32 and sq.is_contiguous()
    for h in range(H):
        j8, js = JFA._quant_rows(jnp.asarray(q[..., h * 64:(h + 1) * 64]))
        np.testing.assert_array_equal(q8[..., h * 64:(h + 1) * 64].numpy(), np.asarray(j8))
        np.testing.assert_array_equal(sq[:, h].numpy(), np.asarray(js)[..., 0])
    assert float(sq[0, 0, 3]) == np.float32(1e-12)


def test_k9_head_quantiser_takes_q_and_k_together():
    q, k = (torch.from_numpy(_rows(2, 40, 4, seed=s)) for s in (7, 8))
    both = TFA.quantize_heads_plain(q, 4, k)
    assert len(both) == 4
    for got, want in zip(both, (*TFA.quantize_heads_plain(q, 4), *TFA.quantize_heads_plain(k, 4))):
        assert torch.equal(got, want)


def _k9_per_head_body(q, k, v, scale, H):
    """The TPU kernel body's formulation (``_flash_packed_int8_kernel``):
    each head's slice quantised on its own, its integer scores, then
    ``s32 * (sq * scale) * sk`` and the f32 softmax."""
    out = []
    for h in range(H):
        sl = slice(h * 64, (h + 1) * 64)
        q8, sq = TFA.quantize_rows_plain(q[..., sl])
        k8, sk = TFA.quantize_rows_plain(k[..., sl])
        s32 = torch.matmul(q8.float(), k8.float().transpose(-1, -2))  # [B, N, N], exact
        s = s32 * (sq * scale) * sk.transpose(-1, -2)
        p = torch.softmax(s, dim=-1).to(v.dtype)
        out.append(torch.matmul(p, v[..., sl]))
    return torch.cat(out, dim=-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k9_decomposed_as_the_wrapper_runs_it(dtype, pallas_interpret):
    """The plain per-head quantiser, then K10's arithmetic on [B, H, N]
    scales: K9's plain version, bit for bit the TPU body's per-head
    formulation, and within the kernel tolerance of the JAX kernel."""
    B, N, H = 2, 88, 4
    q, k, v = _arrays((B, N, H * 64), seed=3)
    q[1, 2, 64:128] = 0.0
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    scale = 64 ** -0.5
    q8, sq, k8, sk = TFA.quantize_heads_plain(tq, H, tk)
    got = TFA._i8qk_attend_plain(q8, sq, k8, sk, tv, None, scale, H, head_scales=True)
    assert torch.equal(got, TFA.flash_attention_packed_int8_plain(tq, tk, tv, scale, H))
    assert torch.equal(got, _k9_per_head_body(tq, tk, tv, scale, H))
    jdt = getattr(jnp, dtype)
    want = JFA.flash_attention_packed(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                                      scale, H, 64, True)
    assert pallas_interpret == ["_flash_packed_int8_kernel"]
    tol = KERNEL_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)


def test_k10_plain_keeps_its_bits_through_the_shared_attend():
    """K10's plain version on joint-row scales [B, N, 1] is the same
    arithmetic as before the K9 scales joined it: the integer scores times
    the row scales times the key scales."""
    B, N, H = 2, 50, 3
    q, k, v = (torch.from_numpy(a) for a in _arrays((B, N, H * 64), seed=5))
    q8, sq, k8, sk = TFA.quantize_rows_plain(q, k)
    s32 = torch.matmul(TFA._heads(q8.float(), H), TFA._heads(k8.float(), H).transpose(-1, -2))
    s = s32 * (sq * 0.125)[:, None] * sk.transpose(1, 2)[:, None]
    assert torch.equal(TFA.flash_attention_packed_i8qk_plain(q, k, v, 0.125, H),
                       TFA._attend(s, v, H))


def test_cpu_quantize_heads_counts_no_launch():
    q = torch.from_numpy(_rows(1, 9, 2, seed=4))
    n = TFA.quantize_heads.launches
    assert TFA.quantize_heads in TFA.WRAPPERS
    got = TFA.quantize_heads(q, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, TFA.quantize_heads_plain(q, 2)))
    assert TFA.quantize_heads.launches == n


# --------------------------------------------------------------- K12 ----
def _ln_f32_cluster(xf, g, b, eps, parts):
    """``_ln_f32`` in the order K12's kernel sums: each row's values summed in
    ``parts`` equal slices of columns (one a CTA of the cluster), the slices'
    sums added in order, then the mean; the squared deviations from it the
    same way. The kernel's order inside a slice is its own: this is the
    scheme, not its bits."""
    K = xf.shape[-1]

    def sliced_sum(t):
        total = None
        for part in t.split(K // parts, dim=-1):
            s = part.sum(dim=-1, keepdim=True)
            total = s if total is None else total + s
        return total

    mu = sliced_sum(xf) / xf.new_full((1,), float(K))
    var = sliced_sum(torch.square(xf - mu)) / xf.new_full((1,), float(K))
    return (xf - mu) * torch.rsqrt(var + eps) * g.float() + b.float()


@pytest.mark.parametrize("K,parts", [(128, 2), (768, 8), (1024, 8), (768, 1)])
def test_k12_cluster_layernorm_matches_jax_ln_f32(K, parts):
    r = np.random.RandomState(K + parts)
    xf = (r.randn(3, 40, K) * 2.0 + r.randn(3, 40, 1) * 3.0).astype(np.float32)
    g = (r.randn(K) * 0.1 + 1.0).astype(np.float32)
    b = (r.randn(K) * 0.05).astype(np.float32)
    got = _ln_f32_cluster(torch.from_numpy(xf), torch.from_numpy(g), torch.from_numpy(b),
                             1e-6, parts)
    want = JIB._ln_f32(jnp.asarray(xf), jnp.asarray(g), jnp.asarray(b), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    # and the port's own _ln_f32, which the plain K12 runs
    torch.testing.assert_close(got, TIB._ln_f32(torch.from_numpy(xf), torch.from_numpy(g),
                                                torch.from_numpy(b), 1e-6), atol=1e-5, rtol=0)


@pytest.mark.parametrize("K,F,want", [
    (768, 3072, (8, 192, 1)),   # ViT-B
    (1024, 4096, (8, 128, 2)),  # ViT-L: two sweeps of 128 hidden columns a warpgroup
    (128, 512, (2, 128, 1)),    # the tests' width
    (256, 512, None), (384, 1536, None), (768, 4096, None), (1024, 3072, None),
    (768, 768, None), (2048, 2048, None), (0, 0, None),
])
def test_k12_shape_rule(K, F, want):
    assert TIB.attnout_mlp_shape(K, F) == want
    if want is None:
        with pytest.raises(ValueError):
            TIB._check_attnout_mlp_width("int8_attnout_mlp_ln", K, F)
    else:
        C, nwc, sweeps = want
        assert K % C == 0 and F == C * 2 * nwc * sweeps
        TIB._check_attnout_mlp_width("int8_attnout_mlp_ln", K, F)


def test_k12_cpu_takes_any_width_and_counts_no_launch():
    """The shape rule is the CUDA kernel's: on CPU tensors the plain version
    runs at any width."""
    r = np.random.RandomState(1)
    B, N, D, F = 1, 6, 64, 256

    def t(*shape, s=1.0, b=0.0):
        return torch.from_numpy((r.randn(*shape) * s + b).astype(np.float32))

    from cognitive_aim_tpu_torch.kernels.int8_ops import quantize_weight
    wo, w1, w2 = (quantize_weight(t(n, k, s=0.05)) for n, k in ((D, D), (F, D), (D, F)))
    args = (t(B, N, D), wo["q"], wo["s"], t(D, s=0.01), t(D, s=0.1, b=0.9), t(B, N, D),
            t(D, s=0.1, b=1.0), t(D, s=0.05), w1["q"], w1["s"], t(F, s=0.01), w2["q"],
            w2["s"], t(D, s=0.01), t(D, s=0.1, b=0.8))
    assert TIB.attnout_mlp_shape(D, F) is None
    n = TIB.int8_attnout_mlp_ln.launches
    assert torch.equal(TIB.int8_attnout_mlp_ln(*args), TIB.int8_attnout_mlp_ln_plain(*args))
    assert TIB.int8_attnout_mlp_ln.launches == n
