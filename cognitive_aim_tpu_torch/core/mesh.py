"""Device mesh (counterpart of cognitive_aim_tpu/core/mesh.py).

A ``Mesh`` is a named grid of the ranks of ``torch.distributed``'s world,
with the JAX package's axis names:

  ``data``     batch (data-parallel) axis: gradients are summed over it;
  ``model``    tensor-parallel axis of the ViT blocks (heads and MLP split);
  ``replica``  cross-node data parallelism of the multi-host mesh;

and ``pipe`` (parallel/pipeline.py) for the GPipe schedule. The program is
SPMD: every rank runs the same code and holds its own piece of each batch
and each split tensor; the mesh gives each axis its process group and this
rank's index on it.

With no process group initialised, ``make_mesh()`` is the world-1 mesh: it
reads no environment, its groups are None and every collective of the
package is the identity, so ``mesh=None`` paths behave as they did before
meshes existed. ``initialize_distributed`` starts the process group (NCCL
on the card, gloo for ``device="cpu"``); a mesh built after it holds real
groups, also at world 1, so its collectives run.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from cognitive_aim_tpu_torch.core.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
REPLICA_AXIS = "replica"  # cross-node data parallelism


class Mesh:
    """Axis name -> size, in order (the last axis varies fastest over the
    ranks), with one process group per axis (``group``), this rank's
    coordinates (``index``) and, where a process group exists, the
    ``DeviceMesh`` that DTensor and ``torch.distributed.checkpoint`` read."""

    def __init__(self, shape: Sequence[Tuple[str, int]], device=None):
        self.axis_names = tuple(n for n, _ in shape)
        self.shape: Dict[str, int] = {n: int(s) for n, s in shape}
        self.size = math.prod(self.shape.values())
        self.distributed = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if self.distributed else 1
        if self.size != world:
            raise ValueError(f"mesh {self.shape} holds {self.size} ranks; the world has {world}")
        self.rank = dist.get_rank() if self.distributed else 0
        sizes = tuple(self.shape.values())
        self.index = {n: int(i) for n, i in
                      zip(self.axis_names, np.unravel_index(self.rank, sizes))}
        if device is None and self.distributed:
            device = "cuda" if dist.get_backend() == "nccl" else "cpu"
        self.device = None if device is None else torch.device(device)
        self.device_mesh = None
        self._groups: Dict[str, Optional[dist.ProcessGroup]] = dict.fromkeys(self.axis_names)
        if self.distributed:
            from torch.distributed.device_mesh import init_device_mesh

            self.device_mesh = init_device_mesh(self.device.type, sizes,
                                                mesh_dim_names=self.axis_names)
            self._groups = {n: self.device_mesh.get_group(n) for n in self.axis_names}

    def group(self, axis: str) -> Optional["dist.ProcessGroup"]:
        """The process group of this rank's line along ``axis`` (None on
        the mesh without a process group)."""
        return self._groups[axis]


def default_mesh_shape(n_devices: int, model_parallel: int = 1) -> Tuple[int, int]:
    """(data, model) mesh shape. model_parallel must divide n_devices."""
    if n_devices % model_parallel != 0:
        raise ValueError(
            f"model_parallel={model_parallel} does not divide n_devices={n_devices}")
    return (n_devices // model_parallel, model_parallel)


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_mesh(model_parallel: int = 1, device=None) -> Mesh:
    """A 2-D (data, model) mesh over the world; the world-1 mesh when no
    process group is initialised."""
    dp, mp = default_mesh_shape(world_size(), model_parallel)
    return Mesh(((DATA_AXIS, dp), (MODEL_AXIS, mp)), device)


def initialize_distributed(device=None, **kw) -> None:
    """Start ``torch.distributed`` for a multi-process run: the address, rank
    and world come from torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``) unless passed as keywords
    (``init_method``, ``rank``, ``world_size``). NCCL on the card, with
    ``LOCAL_RANK``'s device made current; gloo for ``device="cpu"``. Nothing
    falls back: an NCCL start that fails raises. Call once per process."""
    dev = resolve_device(device)
    backend = kw.pop("backend", "nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend=backend, **kw)


def make_multihost_mesh(model_parallel: int = 1, replicas: Optional[int] = None,
                        device=None) -> Mesh:
    """3-D (replica, data, model) mesh for multi-node runs: ``replica`` spans
    the nodes and carries only the gradient sums; ``data`` and ``model`` stay
    within a node. ``replicas`` defaults to the node count, world /
    ``LOCAL_WORLD_SIZE`` (torchrun's ranks per node; one node without it)."""
    n = world_size()
    if replicas is None:
        replicas = max(1, n // int(os.environ.get("LOCAL_WORLD_SIZE", n)))
    if n % (replicas * model_parallel) != 0:
        raise ValueError(f"replicas={replicas} * model_parallel={model_parallel} "
                         f"does not divide n_devices={n}")
    dp = n // (replicas * model_parallel)
    return Mesh(((REPLICA_AXIS, replicas), (DATA_AXIS, dp), (MODEL_AXIS, model_parallel)),
                device)


def batch_axes(mesh: Mesh):
    """Mesh axes the batch dim shards over: (replica, data) on a multihost
    mesh, data alone on the 2-D mesh."""
    if REPLICA_AXIS in mesh.axis_names:
        return (REPLICA_AXIS, DATA_AXIS)
    return DATA_AXIS


def _axes(mesh: Mesh):
    a = batch_axes(mesh)
    return a if isinstance(a, tuple) else (a,)


def batch_shards(mesh: Mesh) -> int:
    """How many pieces the batch is cut into: the product of the batch axes."""
    return math.prod(mesh.shape[a] for a in _axes(mesh))


def batch_shard_index(mesh: Mesh) -> int:
    """This rank's piece of the batch, replica-major as JAX lays out
    ``P(("replica", "data"))``."""
    i = 0
    for a in _axes(mesh):
        i = i * mesh.shape[a] + mesh.index[a]
    return i


def batch_rows(mesh: Mesh, batch_size: int) -> Tuple[int, int]:
    """[lo, hi) of this rank's rows of a global batch; the batch must
    divide over the batch axes."""
    n = batch_shards(mesh)
    if batch_size % n != 0:
        raise ValueError(f"batch {batch_size} does not divide over the mesh's "
                         f"{n} batch shards {mesh.shape}")
    b = batch_size // n
    i = batch_shard_index(mesh)
    return i * b, (i + 1) * b


def pad_batch_to_devices(batch_size: int, mesh: Mesh) -> int:
    """Smallest batch >= batch_size divisible by the batch-sharded axes."""
    dp = batch_shards(mesh)
    return int(math.ceil(batch_size / dp) * dp)
