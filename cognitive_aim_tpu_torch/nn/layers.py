"""Layers (counterpart of cognitive_aim_tpu/nn/layers.py).

Modules hold the parameters, in PyTorch's layouts (``nn.Linear`` weights are
[out, in]); the ``*_apply`` functions reproduce the JAX package's type rules.
Where the JAX package casts a stream's parameters to the compute dtype and
then multiplies them with float32 activations, JAX promotes the product to
float32 with the weights rounded to the compute dtype; ``param_dtype``
reproduces that rounding.

Modules are built with ``skip_init``: no random draw happens at
construction. ``nn/init.py`` fills them from a ``torch.Generator``, or
``convert.load_flat_params`` from JAX weights. ``device=None`` builds on the
CUDA device (``core/device.py``); the CPU has to be asked for.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from cognitive_aim_tpu_torch.core.device import resolve_device
from cognitive_aim_tpu_torch.kernels.int8_ops import quantize_weight
from cognitive_aim_tpu_torch.nn import init as tinit
from cognitive_aim_tpu_torch.parallel import comm


# ---------------------------------------------------------------- linear ----
def linear(in_dim: int, out_dim: int, device=None) -> nn.Linear:
    return skip_init(nn.Linear, in_dim, out_dim, device=resolve_device(device))


def linear_apply(lin: nn.Linear, x: torch.Tensor,
                 param_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ w + b`` with JAX's promotion: the weights are first rounded to
    ``param_dtype`` (when given), then both sides run in the promoted type."""
    w, b = lin.weight, lin.bias
    if param_dtype is not None:
        w, b = w.to(param_dtype), b.to(param_dtype)
    dt = torch.promote_types(x.dtype, w.dtype)
    return F.linear(x.to(dt), w.to(dt), b.to(dt))


# ----------------------------------------------------------- int8 linear ----
class Int8Linear(nn.Module):
    """The int8 state of a dense projection (kernels/int8_ops.py): ``wq``
    int8 [out, in], ``ws`` f32 [out] per-output-channel scales, ``bias`` f32
    [out]. The kernels use the bias in f32 after the JAX package has cast it
    to the compute dtype, so ``from_float`` keeps it in f32 at the value
    rounded to ``round_dtype``; the weight is quantised from its float32
    value, before any cast."""

    def __init__(self, wq: torch.Tensor, ws: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.register_buffer("wq", wq.contiguous())
        self.register_buffer("ws", ws.contiguous())
        self.register_buffer("bias", bias.contiguous())

    @classmethod
    def from_float(cls, weight: torch.Tensor, bias: torch.Tensor,
                   round_dtype: torch.dtype) -> "Int8Linear":
        if weight.dtype != torch.float32:
            raise TypeError("Int8Linear.from_float quantises float32 weights, "
                            f"got {weight.dtype} (quantise before any cast)")
        w = quantize_weight(weight.detach())
        return cls(w["q"], w["s"], round_through(bias.detach(), round_dtype))


def round_through(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 tensor holding ``t`` rounded to ``dtype``."""
    return t.to(dtype).float()


# ------------------------------------------------------------------- mlp ----
class MLP(nn.Module):
    """Chain of linears fc0..fc{n-1}; dims = [in, h1, ..., out]."""

    def __init__(self, dims: Sequence[int], device=None):
        super().__init__()
        self.n = len(dims) - 1
        for i in range(self.n):
            setattr(self, f"fc{i}", linear(dims[i], dims[i + 1], device))

    def layer(self, i: int) -> nn.Linear:
        return getattr(self, f"fc{i}")

    def init(self, g: torch.Generator) -> "MLP":
        for i in range(self.n):
            tinit.linear_default_(self.layer(i), g)
        return self


def mlp_apply(mlp: MLP, x: torch.Tensor, *, act: Callable = F.relu,
              final_act: Optional[Callable] = None,
              param_dtype: Optional[torch.dtype] = None,
              dropout_rate: float = 0.0, dropout_after: Sequence[int] = (),
              generator: Optional[torch.Generator] = None,
              train: bool = False) -> torch.Tensor:
    """Linears with ``act`` between them (not after the last unless
    ``final_act``). ``dropout_after`` lists the hidden layers (0-based) after
    whose activation a Dropout sits, as in an ``nn.Sequential``; it drops
    only under ``train`` with a ``generator``, as the JAX function needs both
    ``train`` and a key."""
    for i in range(mlp.n):
        x = linear_apply(mlp.layer(i), x, param_dtype)
        if i < mlp.n - 1:
            x = act(x)
            if train and dropout_rate > 0.0 and i in dropout_after and generator is not None:
                x = dropout(x, dropout_rate, generator)
    if final_act is not None:
        x = final_act(x)
    return x


# --------------------------------------------------------------- dropout ----
def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout: each element kept with probability ``1 - rate`` and
    scaled by ``1 / (1 - rate)``; the mask is drawn from ``generator`` (which
    lives on x's device), never from the global generator."""
    keep = 1.0 - rate
    shape, rows = comm.global_shape(x.shape)  # a data-parallel rank's rows
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if rows is not None:
        mask = mask[rows]
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


# ------------------------------------------------------------- layernorm ----
def layernorm(dim: int, eps: float = 1e-6, device=None) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=eps, device=resolve_device(device))


def layernorm_apply(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm in x's dtype; the statistics accumulate in float32."""
    return F.layer_norm(x, ln.normalized_shape, ln.weight.to(x.dtype),
                        ln.bias.to(x.dtype), ln.eps)


# ------------------------------------------------------------- embedding ----
def embedding(num: int, dim: int, device=None) -> nn.Embedding:
    return skip_init(nn.Embedding, num, dim, device=resolve_device(device))


def embedding_apply(emb: nn.Embedding, idx: torch.Tensor) -> torch.Tensor:
    return emb.weight[idx]


# -------------------------------------------------------------- variance ----
def torch_var(x: torch.Tensor) -> torch.Tensor:
    """Unbiased sample variance over ALL elements, across the batch — what
    the reference's ``tensor.var()`` computes in the focal uniformity
    fallbacks. Returns a 0-d tensor (no host sync). Inside
    ``parallel.comm.batch_shard`` the batch is the global one."""
    shard = comm.current_shard()
    if shard is None:
        n = x.numel()
        return ((x - x.mean()) ** 2).sum() / max(n - 1, 1)
    n = x.numel() * shard.total // (shard.hi - shard.lo)
    mean = comm.batch_sum(x.sum()) / n
    return comm.batch_sum(((x - mean) ** 2).sum()) / max(n - 1, 1)


def torch_std(x: torch.Tensor) -> torch.Tensor:
    """``tensor.std()``: unbiased over ALL elements, across the batch (the
    global one inside ``parallel.comm.batch_shard``)."""
    if comm.current_shard() is None:
        return x.std()
    return torch.sqrt(torch_var(x))
