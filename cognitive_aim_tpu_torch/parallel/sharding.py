"""Sharding rules: DP over ``data``, optional TP over ``model`` (counterpart
of cognitive_aim_tpu/parallel/sharding.py).

Data parallelism: each rank takes its rows of the global batch
(``shard_batch``); parameters are replicated and the trainer sums the
gradients over the batch axes. Tensor parallelism (Megatron-style, inside
each backbone block): q, k, v and fc1 split their outputs over ``model``,
attn_out and fc2 their inputs, with one all-reduce after each of the two
(parallel/comm.py); the blocks then hold only their rank's pieces.

The port's weights are [out, in], and its q, k and v are one fused [3D, D]
projection (``Block.qkv``), read as q, k, v thirds. So JAX's column rules
for q, k and v become a head split of each third: a rank of ``tp`` holds
heads [r H / tp, (r + 1) H / tp) of q, of k and of v, and K1 sees the packed
[B, N, (H / tp) 64] layout of its own heads. Everything else is replicated,
as in the JAX package: norms, LayerScale, embeddings, streams, heads and the
adapters. Biases of the row-split layers are added once, after the sum.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from cognitive_aim_tpu_torch.core.mesh import MODEL_AXIS, Mesh, batch_axes, batch_rows
from cognitive_aim_tpu_torch.parallel import comm


@dataclasses.dataclass(frozen=True)
class Spec:
    """How a tensor lies on the mesh: replicated (``dim`` None), or split
    along ``dim`` over the mesh axes ``axes``; with ``parts`` > 1 the dim is
    that many equal blocks, each split on its own (the fused qkv: q, k, v)."""
    dim: Optional[int] = None
    axes: tuple = ()
    parts: int = 1


REPLICATED = Spec()

# Name suffix (block indices dropped) -> Spec of the backbone blocks' [out, in]
# weights and [out] biases under tensor parallelism.
_TP_RULES = {
    ("layers", "qkv", "weight"): Spec(0, (MODEL_AXIS,), 3),
    ("layers", "qkv", "bias"): Spec(0, (MODEL_AXIS,), 3),
    ("layers", "attn_out", "weight"): Spec(1, (MODEL_AXIS,)),
    ("layers", "fc1", "weight"): Spec(0, (MODEL_AXIS,)),
    ("layers", "fc1", "bias"): Spec(0, (MODEL_AXIS,)),
    ("layers", "fc2", "weight"): Spec(1, (MODEL_AXIS,)),
}


def _path_names(name: str):
    return tuple(p for p in name.split(".") if not p.isdigit())


def spec_for(name: str, tensor_parallel: bool = False) -> Spec:
    if tensor_parallel:
        names = _path_names(name)
        for suffix, spec in _TP_RULES.items():
            if names[-len(suffix):] == suffix:
                return spec
    return REPLICATED


def param_shardings(mesh: Mesh, model: nn.Module, tensor_parallel: bool = False
                    ) -> Dict[str, Spec]:
    """Parameter name -> Spec: replicated by default; the backbone blocks'
    projections split over ``model`` when tensor_parallel."""
    del mesh  # the rules name axes; every mesh of the package has them or size 1
    return {n: spec_for(n, tensor_parallel) for n, _ in model.named_parameters()}


def _group(mesh: Mesh, spec: Spec):
    (axis,) = spec.axes
    return mesh.group(axis), mesh.shape[axis], mesh.index[axis]


def local_piece(mesh: Mesh, t: torch.Tensor, spec: Spec) -> torch.Tensor:
    """This rank's piece of the whole tensor ``t``."""
    if spec.dim is None:
        return t
    _, n, r = _group(mesh, spec)
    shape = list(t.shape)
    size = shape[spec.dim]
    if size % (spec.parts * n) != 0:
        raise ValueError(f"dim {spec.dim} of {tuple(t.shape)} does not split into "
                         f"{spec.parts} x {n}")
    v = t.reshape(*shape[:spec.dim], spec.parts, size // spec.parts, *shape[spec.dim + 1:])
    piece = v.narrow(spec.dim + 1, r * size // spec.parts // n, size // spec.parts // n)
    return piece.reshape(*shape[:spec.dim], -1, *shape[spec.dim + 1:])


def whole(mesh: Mesh, t: torch.Tensor, spec: Spec) -> torch.Tensor:
    """The whole tensor from every rank's piece (a collective over the
    spec's axis); the inverse of ``local_piece``."""
    if spec.dim is None:
        return t
    group, n, _ = _group(mesh, spec)
    shape = list(t.shape)
    v = t.reshape(*shape[:spec.dim], spec.parts, shape[spec.dim] // spec.parts,
                  *shape[spec.dim + 1:])
    full = comm.all_gather(v, group, spec.dim + 1) if group is not None else v
    return full.reshape(*shape[:spec.dim], -1, *shape[spec.dim + 1:])


def shard_params(mesh: Mesh, model: nn.Module, tensor_parallel: bool = False) -> nn.Module:
    """Place ``model``'s parameters on the mesh, in place: every rank takes
    global rank 0's values (one program, one set of weights, as a device_put
    of one host array), then the split parameters keep their rank's piece and
    the backbone blocks get the ``model`` group, which routes their forward
    through the tensor-parallel collectives. A model already sharded is made
    whole first. Tensor parallelism needs float blocks (not the int8 policy's
    quantised ones)."""
    unshard_params(model)
    specs = param_shardings(mesh, model, tensor_parallel)
    if mesh.distributed and mesh.size > 1:
        with torch.no_grad():
            for p in model.parameters():
                dist.broadcast(p.data, 0)
    if tensor_parallel:
        blocks = getattr(getattr(model, "backbone", model), "layers", [])
        if any(blk.quantized for blk in blocks):
            raise ValueError("tensor_parallel needs float backbone blocks, not the int8 "
                             "policy's quantised ones")
        H = blocks[0].cfg.num_heads if len(blocks) else 1
        if H % mesh.shape[MODEL_AXIS] != 0:
            raise ValueError(f"{H} heads do not split over model={mesh.shape[MODEL_AXIS]}")
        with torch.no_grad():
            for name, p in model.named_parameters():
                if specs[name].dim is not None:
                    p.data = local_piece(mesh, p.data, specs[name]).contiguous().clone()
        for blk in blocks:
            blk.tp = mesh.group(MODEL_AXIS)
    model._sharding = (mesh, specs)
    return model


def unshard_params(model: nn.Module) -> nn.Module:
    """Make every split parameter whole again (in place) and take the blocks
    off the ``model`` group; a no-op for a model that is not sharded."""
    placed = getattr(model, "_sharding", None)
    if placed is None:
        return model
    mesh, specs = placed
    with torch.no_grad():
        for name, p in model.named_parameters():
            if specs[name].dim is not None:
                p.data = whole(mesh, p.data, specs[name])
    for blk in getattr(getattr(model, "backbone", model), "layers", []):
        blk.tp = None
    del model._sharding
    return model


@contextlib.contextmanager
def unsharded(model: nn.Module):
    """Inside, the model holds whole parameters (a collective in and out);
    the same Parameter objects, sharded again on the way out."""
    placed = getattr(model, "_sharding", None)
    if placed is None:
        yield model
        return
    mesh, specs = placed
    tp = any(s.dim is not None for s in specs.values())
    unshard_params(model)
    try:
        yield model
    finally:
        with torch.no_grad():
            for name, p in model.named_parameters():
                if specs[name].dim is not None:
                    p.data = local_piece(mesh, p.data, specs[name]).contiguous().clone()
        if tp:
            for blk in getattr(getattr(model, "backbone", model), "layers", []):
                blk.tp = mesh.group(MODEL_AXIS)
        model._sharding = (mesh, specs)


def batch_shardings(mesh: Mesh, batch):
    """The Spec of every leaf of a batch: its leading (batch) dim split over
    ``data`` (and ``replica`` on a multi-host mesh)."""
    axes = batch_axes(mesh)
    spec = Spec(0, axes if isinstance(axes, tuple) else (axes,))
    if isinstance(batch, dict):
        return {k: batch_shardings(mesh, v) for k, v in batch.items()}
    return spec


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a global batch (a dict of arrays or tensors,
    nested dicts included); the batch must divide over the batch axes."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    lo, hi = batch_rows(mesh, batch.shape[0])
    return batch[lo:hi]
