"""Pipeline parallelism, the GPipe schedule (counterpart of
cognitive_aim_tpu/parallel/pipeline.py).

The backbone's L blocks are cut into S equal stage chunks along the mesh's
``pipe`` axis; stage s runs blocks [s L/S, (s+1) L/S). A rank's rows of the
batch are split into M microbatches, and stage s runs microbatch m at step
m + s of M + S - 1: it receives m from stage s - 1 (stage 0 takes it from
its own rows), runs its chunk, and sends the result to stage s + 1. The last
stage holds every finished microbatch and broadcasts them to all stages, so
every stage returns the same [b, ...] rows, as JAX's masked psum does. The
bubble is (S - 1) / (M + S - 1).

Differentiable: the backward runs the reversed schedule. Each point-to-point
op is an autograd function whose backward moves the cotangent the other way
(stage s + 1 -> s), and the final broadcast hands the last stage its own
cotangent only: every stage computes the same loss on the replicated output,
so summing the stages' cotangents would count the backbone S times. Autograd
takes the nodes of a rank in reverse order of creation, so every stage
meets the microbatches in the order M - 1, ..., 0, and the sends and
receives of the backward pair up across stages. The gradients of a stage's
blocks and of stage 0's embedding are whole on the rank that ran them and 0
elsewhere: the trainer sums them over ``pipe``.

Every stage's microbatch inputs (received, or stage 0's own rows) hang off an
empty leaf, its anchor, so that each stage's backward runs its sends and
receives even where it has no parameter to train. ``loss.backward()``
reaches them by itself; ``torch.autograd.grad(loss, inputs)`` takes only
the paths to its inputs, so a caller that names its inputs runs the
forward inside ``grad_anchors()`` and passes the anchors among them (the
trainer does), or a stage would never send its cotangents back.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.utils.checkpoint

from cognitive_aim_tpu_torch.core.mesh import DATA_AXIS, Mesh, world_size

PIPE_AXIS = "pipe"

_ANCHORS: contextvars.ContextVar = contextvars.ContextVar("caim_pipeline_anchors",
                                                          default=None)


@contextlib.contextmanager
def grad_anchors():
    """Collect the anchors of the schedules run inside: a list to pass
    among the inputs of ``torch.autograd.grad``."""
    found: List[torch.Tensor] = []
    token = _ANCHORS.set(found)
    try:
        yield found
    finally:
        _ANCHORS.reset(token)


def make_pipeline_mesh(n_stages: int, device=None) -> Mesh:
    """2-D (data, pipe) mesh. The pipe axis is innermost, so consecutive
    stages are consecutive ranks (neighbouring devices of a node)."""
    n = world_size()
    if n % n_stages != 0:
        raise ValueError(f"n_stages={n_stages} does not divide n_devices={n}")
    return Mesh(((DATA_AXIS, n // n_stages), (PIPE_AXIS, n_stages)), device)


def _peer(group, stage: int) -> int:
    return dist.get_global_rank(group, stage)


class _Tie(torch.autograd.Function):
    """Stage 0's microbatch, tied to the anchor (identity)."""

    @staticmethod
    def forward(ctx, anchor, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, g


class _Recv(torch.autograd.Function):
    """Receive a microbatch from stage ``src``; backward: send its cotangent
    back. ``anchor`` is a leaf that requires grad, so the received tensor
    joins the graph."""

    @staticmethod
    def forward(ctx, anchor, like, src, group):
        ctx.src, ctx.group = src, group
        buf = torch.empty_like(like)
        dist.recv(buf, _peer(group, src), group=group)
        return buf

    @staticmethod
    def backward(ctx, g):
        dist.send(g.contiguous(), _peer(ctx.group, ctx.src), group=ctx.group)
        return None, None, None, None


class _Send(torch.autograd.Function):
    """Send a microbatch to stage ``dst`` and return an empty token that
    ties the send into the graph; backward: receive the cotangent of what
    was sent."""

    @staticmethod
    def forward(ctx, y, dst, group):
        ctx.dst, ctx.group = dst, group
        ctx.like = (y.shape, y.dtype, y.device)
        dist.send(y.contiguous(), _peer(group, dst), group=group)
        return y.new_zeros(0)

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device = ctx.like
        g = torch.empty(shape, dtype=dtype, device=device)
        dist.recv(g, _peer(ctx.group, ctx.dst), group=ctx.group)
        return g, None, None


class _Replicate(torch.autograd.Function):
    """The last stage's outputs to every stage (broadcast); backward: the
    last stage keeps its own cotangent, the others pass an empty cotangent
    to their send tokens, which then receive from the next stage."""

    @staticmethod
    def forward(ctx, out, src, group, *tokens):
        ctx.src, ctx.group, ctx.n_tokens = src, group, len(tokens)
        ctx.is_src = dist.get_rank(group) == src
        buf = out.contiguous().clone()
        dist.broadcast(buf, _peer(group, src), group=group)
        return buf

    @staticmethod
    def backward(ctx, g):
        tokens = tuple(g.new_zeros(0) for _ in range(ctx.n_tokens))
        return (g if ctx.is_src else None), None, None, *tokens


def pipelined_scan(mesh: Mesh, layers: Sequence, x: torch.Tensor, block_fn: Callable,
                   n_micro: int, remat: bool = False) -> torch.Tensor:
    """Run ``for layer in layers: x = block_fn(layer, x)`` pipelined over the
    mesh's ``pipe`` axis with ``n_micro`` microbatches of this rank's rows.

    layers: the L per-layer objects (the backbone's Blocks, or per-layer
      parameter dicts); L must divide by the pipe axis' size. Stage s reads
      its own chunk of them only.
    x: this rank's rows [b, ...] (its data shard); b must divide by
      ``n_micro``. Every stage passes them; stage 0's feed the schedule.
    block_fn: (layer, x) -> x for ONE layer; it must keep x's shape and dtype.
    remat: recompute each stage chunk in the backward (the GPipe memory
      discipline: keep the microbatch boundaries, recompute the blocks'
      intermediates inside a stage).
    Returns [b, ...] on every stage: the sequential result, up to the
    rounding of smaller matmuls."""
    S = mesh.shape[PIPE_AXIS]
    L = len(layers)
    if L % S != 0:
        raise ValueError(f"{L} layers do not divide over {S} stages")
    b = x.shape[0]
    if b % n_micro != 0:
        raise ValueError(f"local batch {b} does not divide into {n_micro} microbatches")
    s = mesh.index[PIPE_AXIS]
    group = mesh.group(PIPE_AXIS)
    chunk = list(layers[s * L // S:(s + 1) * L // S])

    def apply_chunk(c):
        for layer in chunk:
            c = block_fn(layer, c)
        return c

    run = apply_chunk
    if remat:
        def run(c):
            return torch.utils.checkpoint.checkpoint(apply_chunk, c, use_reentrant=False)

    micros = x.chunk(n_micro, dim=0)
    if S == 1:
        return torch.cat([run(m) for m in micros], dim=0)
    anchor = x.new_zeros(0)
    if torch.is_grad_enabled():
        anchor.requires_grad_(True)
        if _ANCHORS.get() is not None:
            _ANCHORS.get().append(anchor)
    outs, tokens = [], []
    for m in micros:  # stage s runs microbatch i at step i + s
        inp = _Tie.apply(anchor, m) if s == 0 else _Recv.apply(anchor, m, s - 1, group)
        y = run(inp)
        if s < S - 1:
            tokens.append(_Send.apply(y, s + 1, group))
        else:
            outs.append(y)
    out = torch.cat(outs, dim=0) if outs else torch.zeros_like(x)
    return _Replicate.apply(out, S - 1, group, *tokens)

