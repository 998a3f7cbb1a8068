"""Differentiable collectives over one axis of a mesh.

Where the JAX package lets GSPMD insert the collectives of a sharded
program, the port calls them by hand, each with the backward that keeps
gradients equal to the unsharded program's (Megatron's conjugate pairs):

  ``copy_to``      identity forward, all-reduce backward: a replicated input
                   feeding a layer split by its outputs;
  ``reduce_from``  all-reduce forward, identity backward: the partial sums of
                   a layer split by its inputs;
  ``gather_from``  all-gather forward, this rank's slice backward: every rank
                   goes on with the whole tensor and computes the same thing,
                   so each rank's cotangent is already the whole one;
  ``split_to``     this rank's slice forward, all-gather backward.

A group of None (the mesh without a process group) makes each of them the
identity. A real group of one rank still runs its collective.

``batch_shard`` marks a forward that runs one rank's rows of a global
batch. Inside it the model's random draws (``core/rng.normal_like``,
``nn/layers.dropout``) draw the global batch's values and keep the rank's
rows, and its statistics over the whole batch (the focal stream's
uniformity tests, ``nn/layers.torch_var`` and the token-norm spread) sum over
the batch axes: a rank of world N then computes what world 1 does for its
rows, as one global key and one global program do in the JAX package.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over the group in place (no autograd)."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's pieces of equal shape, concatenated along ``dim`` in rank
    order (no autograd)."""
    if group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim)


def _own_slice(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, r = group_size(group), group_rank(group)
    return t.narrow(dim, r * (t.shape[dim] // n), t.shape[dim] // n)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.group, ctx.dim).contiguous(), None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _own_slice(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    return x if group is None else _GatherFrom.apply(x, group, dim)


def split_to(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    return x if group is None else _SplitTo.apply(x, group, dim)


def gather_batch(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """This rank's rows -> the global batch's rows, on every rank, over the
    batch axes (the last axis innermost, so ("replica", "data") lays rows out
    replica-major). Differentiable as ``gather_from``."""
    for axis in reversed(axes if isinstance(axes, tuple) else (axes,)):
        x = gather_from(x, mesh.group(axis), 0)
    return x


def group_of(mesh, axis: str) -> Optional["dist.ProcessGroup"]:
    """The mesh's group of ``axis``, or None where the mesh has no such
    axis or no process group."""
    if mesh is None or axis not in mesh.axis_names:
        return None
    return mesh.group(axis)


@dataclasses.dataclass(frozen=True)
class BatchShard:
    lo: int  # this rank's rows [lo, hi) of a global batch of ``total``
    hi: int
    total: int
    groups: Tuple = ()  # the process groups of the batch axes


_SHARD: contextvars.ContextVar = contextvars.ContextVar("caim_batch_shard", default=None)


@contextlib.contextmanager
def batch_shard(mesh, lo: int, hi: int, total: int, axes=()):
    """Run the forward inside as rows [lo, hi) of a global batch of
    ``total``, sharded over the mesh's ``axes`` (see the module docstring)."""
    axes = axes if isinstance(axes, tuple) else (axes,)
    groups = tuple(g for g in (group_of(mesh, a) for a in axes) if g is not None)
    token = _SHARD.set(BatchShard(lo, hi, total, groups))
    try:
        yield
    finally:
        _SHARD.reset(token)


def current_shard() -> Optional[BatchShard]:
    return _SHARD.get()


def global_shape(shape):
    """(shape of the draw, rows to keep or None): inside ``batch_shard`` a
    draw of this rank's rows is drawn at the global batch's shape."""
    sh = _SHARD.get()
    if sh is None:
        return tuple(shape), None
    if shape[0] != sh.hi - sh.lo:
        raise ValueError(f"a draw of {tuple(shape)} inside a batch shard of rows "
                         f"[{sh.lo}, {sh.hi}): its leading dim is not the batch")
    return (sh.total, *shape[1:]), slice(sh.lo, sh.hi)


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the batch axes of the current batch shard
    (differentiable as ``reduce_from``); ``t`` itself outside one."""
    sh = _SHARD.get()
    for g in () if sh is None else sh.groups:
        t = reduce_from(t, g)
    return t
