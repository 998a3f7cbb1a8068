"""The port's K1, K6 and K8 against the JAX package's Pallas kernels.

The JAX side runs its Pallas kernels in interpret mode on the CPU (as
tests/test_kernels.py does); the port's wrappers get CPU tensors, so they
run their plain PyTorch versions. Inputs come from a numpy seed and reach
both sides as numpy arrays. The CUDA kernels themselves are compared with
the plain versions in tests/test_torch_cuda.py.

Tolerances: f32 on both sides, so the differences are summation order and
exp/division rounding: atol 2e-5 / rtol 2e-4, the tolerance the JAX
package's own kernel tests hold its kernels to.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cognitive_aim_tpu.kernels import flash_attention as JFA
from cognitive_aim_tpu.kernels import focal_attention as JFO
from cognitive_aim_tpu_torch.kernels import flash_attention as TFA
from cognitive_aim_tpu_torch.kernels import focal_attention as TFO

ATOL, RTOL = 2e-5, 2e-4


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


@pytest.mark.parametrize("N", [130, 257])
def test_flash_packed_plain_matches_jax_kernel(N, pallas_interpret):
    B, H, D = 2, 4, 64
    q, k, v = _arrays((B, N, H * D))
    scale = D ** -0.5
    want = JFA.flash_attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      scale, H, 128)
    got = TFA.flash_attention_packed(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), scale, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("N", [130, 256])
def test_focal_plain_matches_jax_kernel(N, pallas_interpret):
    D = 128
    q, k, v = _arrays((2, N, D), scale=0.5)
    scale = float(np.sqrt(D // 8))
    want = JFO.focal_attention_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     scale, q_block=64)
    got = TFO.focal_attention_fused(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), scale)
    for name, w, g in zip(("attended", "colmean", "diag", "rowmax"), want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N", [130, 257])
def test_flash_attention_plain_matches_jax_kernel(N, dtype, pallas_interpret):
    """K8 on [B, N, H, Dh]; bf16: both sides round P and the output to bf16,
    one bf16 step of an O(1) value apart at most."""
    B, H, D = 2, 3, 64
    q, k, v = _arrays((B, N, H, D))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = JFA.flash_attention(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                               scale=D ** -0.5, q_block=128, k_block=128)
    got = TFA.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)), D ** -0.5)
    assert got.shape == (B, N, H, D) and got.dtype == tdt
    tol = dict(atol=ATOL, rtol=RTOL) if dtype == "float32" else dict(atol=1e-2, rtol=0)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)


def test_flash_attention_plain_is_the_jax_reference_and_takes_views():
    """``attention_reference`` against the JAX function of that name, on
    separately projected tensors and on the column slices of one fused
    [B, N, 3 H Dh] projection (the views K8's kernel reads in place)."""
    B, N, H, D = 2, 70, 2, 64
    (qkv,) = _arrays((B, N, 3 * H * D), n=1, seed=3)
    tq, tk, tv = (t.view(B, N, H, D) for t in torch.from_numpy(qkv).split(H * D, dim=-1))
    assert not tq.is_contiguous()
    jq, jk, jv = (jnp.asarray(a).reshape(B, N, H, D)
                  for a in np.split(qkv, 3, axis=-1))
    want = JFA.attention_reference(jq, jk, jv, D ** -0.5)
    n8 = TFA.flash_attention.launches
    got = TFA.flash_attention(tq, tk, tv, D ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    assert torch.equal(got, TFA.attention_reference(tq.contiguous(), tk.contiguous(),
                                                    tv.contiguous(), D ** -0.5))
    # the packed kernel's function on the same memory, head by head
    packed = TFA.flash_attention_packed(*(t.reshape(B, N, H * D) for t in (tq, tk, tv)),
                                        D ** -0.5, H)
    np.testing.assert_allclose(got.reshape(B, N, H * D).numpy(), packed.numpy(),
                               atol=ATOL, rtol=RTOL)
    assert TFA.flash_attention.launches == n8  # CPU tensors launch nothing


@pytest.mark.parametrize("N", [1, 63, 64, 65, 127, 128, 129])
def test_flash_packed_plain_matches_jax_kernel_at_short_lengths(N, pallas_interpret):
    """The lengths where the CUDA kernel's tiles are mostly padding: one
    token, one short of a tile, one past it (the card tests hold the kernel
    to this plain version there)."""
    B, H, D = 2, 2, 64
    q, k, v = _arrays((B, N, H * D), seed=N)
    want = JFA.flash_attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      D ** -0.5, H, 128)
    got = TFA.flash_attention_packed(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), D ** -0.5, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def _bias_row(B, N, kind):
    """Key-side logit bias [B, N] as the token filter makes it: zeros; log
    token counts on the (up to) 4 trailing keys with one empty group at
    log(1e-6); log counts on every key."""
    r = np.random.RandomState(3)
    b = np.zeros((B, N), np.float32)
    if kind == "groups":
        g = min(4, N)
        b[:, -g:] = np.log(r.randint(1, 891, (B, 4)))[:, 4 - g:]
        b[0, -min(2, N)] = np.log(1e-6)
    elif kind == "every_key":
        b[:] = np.log(r.randint(1, 891, (B, N)))
    return b


@pytest.mark.parametrize("N", [1, 65, 129, 481])
@pytest.mark.parametrize("kind", ["zeros", "groups", "every_key"])
def test_flash_packed_bias_plain_matches_jax_kernel_at_short_lengths(N, kind,
                                                                     pallas_interpret):
    """K7's plain version on the filter's bias rows at lengths inside one or
    a few key tiles (the card tests hold the kernel to it there)."""
    B, H, D = 2, 2, 64
    q, k, v = _arrays((B, N, H * D), seed=N)
    bias = _bias_row(B, N, kind)
    want = JFA.flash_attention_packed_bias(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           jnp.asarray(bias), D ** -0.5, H, 128)
    got = TFA.flash_attention_packed_bias(torch.from_numpy(q), torch.from_numpy(k),
                                          torch.from_numpy(v), torch.from_numpy(bias),
                                          D ** -0.5, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    """A wrapper counts kernel launches only; CPU tensors run the plain
    version, bit for bit."""
    q, k, v = (torch.from_numpy(a) for a in _arrays((1, 70, 128)))
    n1, n6 = TFA.flash_attention_packed.launches, TFO.focal_attention_fused.launches
    got = TFA.flash_attention_packed(q, k, v, 0.125, 2)
    assert torch.equal(got, TFA.flash_attention_packed_plain(q, k, v, 0.125, 2))
    got6 = TFO.focal_attention_fused(q, k, v, 4.0)
    for a, b in zip(got6, TFO.focal_attention_plain(q, k, v, 4.0)):
        assert torch.equal(a, b)
    assert TFA.flash_attention_packed.launches == n1
    assert TFO.focal_attention_fused.launches == n6


def test_bf16_plain_versions_keep_the_dtype_contract():
    """attended/ctx come back in the input dtype; the row views in f32."""
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _arrays((2, 65, 128)))
    assert TFA.flash_attention_packed(q, k, v, 0.125, 2).dtype == torch.bfloat16
    att, *views = TFO.focal_attention_fused(q, k, v, 4.0)
    assert att.dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in views)


def test_focal_plain_views_are_consistent():
    """rowmax = 1/l and diag = exp(s_ii - m)/l: the identities the CUDA
    kernel computes the row views from."""
    q, k, v = (torch.from_numpy(a).double() for a in _arrays((2, 50, 64)))
    scale = 8 ** 0.5
    _, colmean, diag, rowmax = TFO.focal_attention_plain(q, k, v, scale)
    s = q @ k.transpose(-1, -2) / scale
    m = s.amax(-1)
    l = torch.exp(s - m[..., None]).sum(-1)
    torch.testing.assert_close(rowmax, (1.0 / l).float())
    s_ii = torch.diagonal(s, dim1=-2, dim2=-1)
    torch.testing.assert_close(diag, (torch.exp(s_ii - m) / l).float())
    torch.testing.assert_close(colmean.sum(-1), torch.ones(2, dtype=torch.float32))
