"""The kernel wrappers' differentiability contract against the JAX package.

K1 (also with ``int8_dots``, K9), K7, K10, K10b and K6 carry ``jax.custom_vjp``
in the JAX package: the Pallas forward, the XLA reference's vjp backward.
The port gives each an ``autograd.Function`` whose backward recomputes the
float plain version (kernels/_grad.py). Here its gradients meet ``jax.grad``
through the JAX kernel, run in interpret mode on the CPU as
tests/test_kernels.py runs it; the port's wrappers get CPU tensors and run
their plain versions forward. Every other wrapper has no backward in either
package and raises under grad (JAX's ``jax.grad`` through K8's
``pallas_call`` raises too: pinned below).

Tolerances: strict float32 atol 1e-5 / rtol 1e-5 (summation order and
exp rounding, on gradients of unit scale); bfloat16 atol 2e-2 / rtol 2e-2
(both sides round every product to bf16 at their own places).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cognitive_aim_tpu.kernels import flash_attention as JFA
from cognitive_aim_tpu.kernels import focal_attention as JFO
from cognitive_aim_tpu_torch.kernels import flash_attention as TFA
from cognitive_aim_tpu_torch.kernels import focal_attention as TFO
from cognitive_aim_tpu_torch.kernels import int8_block as TIB
from cognitive_aim_tpu_torch.kernels import int8_gemm as TIG
from cognitive_aim_tpu_torch.kernels.int8_ops import quantize_weight

F32_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
DTYPES = {"f32": (jnp.float32, torch.float32, F32_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


@pytest.fixture
def pallas_interpret(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _arrays(shapes, seed=0, scale=0.5):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype(np.float32) for s in shapes]


def _grads_jax(fn, inputs, weights, jdt):
    """jax.grad of sum(out_i * w_i) over the outputs in ``weights``."""
    def loss(*a):
        outs = fn(*a)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum((o.astype(jnp.float32) * w).sum() for o, w in zip(outs, weights)
                   if w is not None)
    args = [jnp.asarray(x, jdt) for x in inputs]
    return jax.grad(loss, argnums=tuple(range(len(args))))(*args)


def _grads_torch(fn, inputs, weights, tdt):
    args = [torch.tensor(x, dtype=tdt, requires_grad=True) for x in inputs]
    outs = fn(*args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert all(o.grad_fn is not None for o in outs)
    loss = sum((o.float() * torch.from_numpy(w)).sum() for o, w in zip(outs, weights)
               if w is not None)
    loss.backward()
    return [a.grad for a in args]


def _compare(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w.astype(jnp.float32)),
                                   **tol)


# attention kernels: (JAX function, port function, with a key bias)
ATTENTION = {
    "K1": (lambda q, k, v, s, h: JFA.flash_attention_packed(q, k, v, s, h, 0),
           TFA.flash_attention_packed, False),
    "K1_int8_dots": (lambda q, k, v, s, h: JFA.flash_attention_packed(q, k, v, s, h, 0, True),
                     lambda q, k, v, s, h: TFA.flash_attention_packed(q, k, v, s, h,
                                                                      int8_dots=True), False),
    "K7": (lambda q, k, v, b, s, h: JFA.flash_attention_packed_bias(q, k, v, b, s, h, 0),
           TFA.flash_attention_packed_bias, True),
    "K10": (lambda q, k, v, s, h: JFA.flash_attention_packed_i8qk(q, k, v, s, h, 0),
            TFA.flash_attention_packed_i8qk, False),
    "K10b": (lambda q, k, v, b, s, h: JFA.flash_attention_packed_i8qk_bias(q, k, v, b, s, h, 0),
             TFA.flash_attention_packed_i8qk_bias, True),
}
# the int8 first product takes bfloat16 operands (the bf16 policy's route)
CASES = [("K1", "f32"), ("K1", "bf16"), ("K7", "f32"), ("K7", "bf16"),
         ("K1_int8_dots", "bf16"), ("K10", "bf16"), ("K10b", "bf16")]


@pytest.mark.parametrize("kernel,dtype", CASES)
def test_attention_grad_matches_jax(kernel, dtype, pallas_interpret):
    jfn, tfn, biased = ATTENTION[kernel]
    jdt, tdt, tol = DTYPES[dtype]
    B, N, H, Dh = 2, 37, 2, 64
    q, k, v, w = _arrays([(B, N, H * Dh)] * 4)
    scale = Dh ** -0.5
    if biased:
        bias = np.log(np.random.RandomState(5).randint(1, 4, (B, N))).astype(np.float32)
        want = _grads_jax(lambda a, b, c, d: jfn(a, b, c, d.astype(jnp.float32), scale, H),
                          [q, k, v, bias], [w], jdt)
        got = _grads_torch(lambda a, b, c, d: tfn(a, b, c, d.float(), scale, H),
                           [q, k, v, bias], [w], tdt)
    else:
        want = _grads_jax(lambda a, b, c: jfn(a, b, c, scale, H), [q, k, v], [w], jdt)
        got = _grads_torch(lambda a, b, c: tfn(a, b, c, scale, H), [q, k, v], [w], tdt)
    _compare(got, want, tol)


@pytest.mark.parametrize("used", ["all", "attended_colmean"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_focal_grad_matches_jax(dtype, used, pallas_interpret):
    """K6: the gradients of all four outputs; an unused output counts as a
    zero gradient on both sides."""
    jdt, tdt, tol = DTYPES[dtype]
    B, N, D = 2, 49, 128
    q, k, v, w0 = _arrays([(B, N, D)] * 4, seed=1)
    w1, w2, w3 = _arrays([(B, N)] * 3, seed=2, scale=30.0)
    weights = [w0, w1, w2, w3] if used == "all" else [w0, w1, None, None]
    scale = float(np.sqrt(D // 8))
    want = _grads_jax(lambda a, b, c: JFO.focal_attention_fused(a, b, c, scale),
                      [q, k, v], weights, jdt)
    got = _grads_torch(lambda a, b, c: TFO.focal_attention_fused(a, b, c, scale),
                       [q, k, v], weights, tdt)
    _compare(got, want, tol)


def test_int8_qk_forward_stays_int8_backward_is_float():
    """K10 on the CPU runs its int8 plain version forward, and its backward
    is the float reference's (the straight-through rule): the plain int8
    version's own autograd would give zero gradients through ``round``."""
    B, N, H, Dh = 1, 20, 2, 64
    q, k, v, w = (torch.from_numpy(a) for a in _arrays([(B, N, H * Dh)] * 4, seed=3))
    scale = Dh ** -0.5
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = TFA.flash_attention_packed_i8qk(qq, kk, vv, scale, H)
    torch.testing.assert_close(out.detach(),
                               TFA.flash_attention_packed_i8qk_plain(q, k, v, scale, H),
                               rtol=0, atol=0)
    (out * w).sum().backward()
    qf, kf, vf = (t.clone().requires_grad_(True) for t in (q, k, v))
    (TFA.flash_attention_packed_plain(qf, kf, vf, scale, H) * w).sum().backward()
    for a, b in ((qq, qf), (kk, kf), (vv, vf)):
        torch.testing.assert_close(a.grad, b.grad, rtol=0, atol=0)
        assert a.grad.abs().max() > 0


def test_differentiable_wrappers_untouched_without_grad():
    """Under no_grad (and on inputs that do not require grad) the wrappers
    return what they returned before: no graph, no counted launch on the
    CPU."""
    B, N, H, Dh = 1, 9, 2, 64
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _arrays([(B, N, H * Dh)] * 3))
    before = TFA.flash_attention_packed.launches
    with torch.no_grad():
        out = TFA.flash_attention_packed(q, k, v, 0.125, H)
        att = TFO.focal_attention_fused(q, k, v, 3.0)
    assert out.grad_fn is None and all(t.grad_fn is None for t in att)
    torch.testing.assert_close(out, TFA.flash_attention_packed_plain(q.detach(), k.detach(),
                                                                     v.detach(), 0.125, H),
                               rtol=0, atol=0)
    assert TFA.flash_attention_packed.launches == before


def test_jax_k8_has_no_backward(pallas_interpret):
    """K8 (``flash_attention``) has no custom_vjp: ``jax.grad`` through its
    pallas_call raises, so the port's K8 raises too."""
    q = jnp.asarray(_arrays([(1, 16, 2, 64)])[0])
    with pytest.raises(Exception):
        jax.grad(lambda a: JFA.flash_attention(a, q, q, 0.125, q_block=16,
                                               k_block=16).sum())(q)


def _int8_cases():
    """Each gradient-less wrapper with CPU inputs of a small shape: (name,
    function, float inputs, the other inputs, a builder of the call)."""
    B, N, D, F, H = 1, 8, 128, 256, 2
    rng = np.random.RandomState(7)

    def f(*shape):
        return torch.from_numpy((rng.randn(*shape) * 0.5).astype(np.float32))

    def w8(n, k):
        w = quantize_weight(f(n, k))
        return w["q"], w["s"]

    ln = (torch.ones(D), torch.zeros(D))
    wqkv, wo, w1, w2 = w8(3 * D, D), w8(D, D), w8(F, D), w8(D, F)
    b3, bd, bf, ls = f(3 * D), f(D), f(F), torch.full((D,), 0.5)
    h8, sh = TIB.int8_fc1_gelu_plain(f(B, N, D), *w1, bf)
    return {
        "K2": lambda x: TIB.int8_qkv_proj_ln(x, *ln, *wqkv, b3, 1e-6, torch.float32),
        "K5": lambda x: TIB.int8_qkv_proj(x, *wqkv, b3, torch.float32),
        "K3": lambda x: TIB.int8_out_residual(x, *wo, bd, ls, x),
        "K4": lambda x: TIB.int8_mlp_ln(x, *ln, *w1, bf, *w2, bd, ls),
        "K4a": lambda x: TIB.int8_fc1_gelu_ln(x, *ln, *w1, bf),
        "K4b": lambda x: TIB.int8_out_residual_prequant(h8, sh, *w2, bd, ls, x),
        "K12": lambda x: TIB.int8_attnout_mlp_ln(x, *wo, bd, ls, x, *ln, *w1, bf, *w2, bd, ls),
        "K13": lambda x: TIB.int8_proj(x, *wqkv, b3, torch.float32),
        "K14": lambda x: TIB.int8_fc1_gelu(x, *w1, bf),
        "K15": lambda x: TIG.int8_gemm_fused(x[0], *wqkv, b3, torch.float32),
        "K8": lambda x: TFA.flash_attention(*(x.view(B, N, H, D // H),) * 3, 0.125),
        "K11": lambda x: TFA.flash_attention_packed_out_res(x, x, x, *wo, bd, ls, x, 0.125, H),
        "Q": lambda x: TFA.quantize_rows(x, x),
        "Qh": lambda x: TFA.quantize_heads(x, H, x),
    }, f(B, N, D)


@pytest.mark.parametrize("name", ["K2", "K3", "K4", "K4a", "K4b", "K5", "K8", "K11", "K12",
                                  "K13", "K14", "K15", "Q", "Qh"])
def test_gradless_wrapper_raises_under_grad(name):
    cases, x = _int8_cases()
    call = cases[name]
    with pytest.raises(RuntimeError, match="no backward"):
        call(x.clone().requires_grad_(True))
    with torch.no_grad():
        out = call(x.clone().requires_grad_(True))
    outs = out if isinstance(out, (tuple, list)) else (out,)
    assert all(torch.isfinite(o.float()).all() for o in outs)
    # inputs that do not require grad run forward with grad enabled as well
    call(x)
