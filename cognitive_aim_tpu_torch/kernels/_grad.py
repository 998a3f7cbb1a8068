"""The differentiability contract of the kernel wrappers, the JAX package's.

The JAX package differentiates five of its Pallas kernels with
``jax.custom_vjp``: the forward runs the kernel, the backward differentiates
the XLA reference on the saved inputs (a recompute: the score matrix is never
kept). They are K1 ``flash_attention_packed`` (also with ``int8_dots``, K9),
K7 ``flash_attention_packed_bias``, K10 ``flash_attention_packed_i8qk``, K10b
``flash_attention_packed_i8qk_bias`` and K6 ``focal_attention_fused``; the
int8-QK^T kernels differentiate the FLOAT reference, straight through the
quantisation. Here ``recompute_vjp`` is that rule: an ``autograd.Function``
whose forward calls the wrapper's op (the CUDA kernel for CUDA tensors, the
plain version for CPU tensors), saves the inputs only, and
whose backward recomputes the float plain reference under
``torch.enable_grad()`` and returns ``torch.autograd.grad`` of it.

Each kernel reaches PyTorch as a ``caim`` custom op (``_library``) whose CUDA
implementation calls the library's C entry through ctypes on raw pointers;
the ops register no autograd formula, so autograd must never reach one with
grad enabled. The differentiable wrappers call theirs inside
``_Recompute.forward``, where grad is off. No other TPU kernel has a backward
in the JAX package (``jax.grad`` through them raises), so every other
wrapper calls ``forbid_grad`` and raises, before its op is called, when grad
is enabled and an input requires it.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def needs_grad(tensors: Sequence) -> bool:
    """Grad is enabled and one of ``tensors`` requires it."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def forbid_grad(name: str, *args) -> None:
    """Raise where autograd would need a backward this wrapper does not have."""
    if needs_grad(args):
        raise RuntimeError(
            f"{name}: the kernel has no backward (neither has the JAX package's); "
            f"call it under torch.no_grad() or on inputs that do not require grad")


class _Recompute(torch.autograd.Function):
    """forward(fn, reference, n, *args): ``fn(*args)``, with the first ``n``
    args differentiable; backward: the vjp of ``reference(*args)``
    recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, fn, reference, n, *args):
        ctx.reference, ctx.n, ctx.rest = reference, n, args[n:]
        ctx.save_for_backward(*args[:n])
        return fn(*args)

    @staticmethod
    def backward(ctx, *grads):
        inputs = ctx.saved_tensors
        # the profiler's range of the recompute (a no-op when it is off)
        with torch.enable_grad(), torch.profiler.record_function(
                f"recompute_vjp {ctx.reference.__name__}"):
            leaves = [t.detach().requires_grad_(True) for t in inputs]
            outs = ctx.reference(*leaves, *ctx.rest)
            outs = outs if isinstance(outs, (tuple, list)) else (outs,)
            # an output whose gradient is None (or was never used) counts as zeros
            pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
            got = torch.autograd.grad([o for o, _ in pairs], leaves,
                                      [g.to(o.dtype) for o, g in pairs],
                                      allow_unused=True)
        return (None, None, None, *got, *(None for _ in ctx.rest))


def recompute_vjp(fn: Callable, reference: Callable, n_diff: int, *args):
    """``fn(*args)``, differentiable in its first ``n_diff`` tensor args
    through ``reference`` when grad is enabled and one of them requires it;
    else ``fn(*args)`` as it is."""
    if not needs_grad(args[:n_diff]):
        return fn(*args)
    return _Recompute.apply(fn, reference, n_diff, *args)
