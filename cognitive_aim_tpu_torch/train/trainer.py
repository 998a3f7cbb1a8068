"""Training engine (counterpart of cognitive_aim_tpu/train/trainer.py).

One step differentiates the JAX trainer's loss through the model's training
forward (``forward(train=True)``): SILog depth loss on the per-image scalar
target, plus ``curiosity_weight`` times the curiosity loss once the
curiosity warm-up is over, plus ``attention_entropy_weight`` times the focal
attention entropy. The optimizer is the JAX trainer's optax chain, restated
on torch tensors so that a step lands on the same parameters:

  * ``clip_by_global_norm(grad_clip)`` then ``adamw(schedule, wd, 0.9,
    0.999, 1e-8)``: Adam's bias corrections, the decay added to the update,
    the learning rate of the update count before it;
  * per parameter group, as ``optax.multi_transform`` runs them: each group
    clips by its own global norm and keeps its own moments; a frozen
    parameter gets no update at all (``set_to_zero``), and no gradient;
  * ``optax.MultiSteps`` for ``accumulation_steps`` k > 1: the k
    micro-gradients are AVERAGED (Welford's running mean), the average is
    clipped, and the parameters move every k-th micro-step only;
  * the schedule counts optimizer updates: ``total = epochs *
    steps_per_epoch // k``; ``warmup_cosine`` is optax's
    ``warmup_cosine_decay_schedule(0, lr, warm, total, 1e-6)`` (the decay
    length includes the warm-up), ``cosine`` its ``cosine_decay_schedule``
    with ``alpha = 1e-6 / lr``, anything else the staircase
    ``exponential_decay(lr, 30 * steps_per_epoch, 0.1)``.

Parameter groups follow the JAX labels: ``train_only_lora`` trains the
backbone adapters (every tensor whose name has a part starting with
``lora``) and, with ``sandwich_heads``, every non-backbone tensor in a
``train_heads`` group of its own (its own lr where ``heads_lr > 0``);
``freeze_backbone`` freezes the backbone except the parts named exactly
``lora_A`` / ``lora_B`` (so an adapter on another target, ``lora_<target>_A``,
is frozen, as in the JAX package).

The model keeps float32 master weights: the trainer never calls
``prepare_params`` (which casts in place), and the float backbone and focal
stream cast their weights to the compute dtype at each call.

Noise and dropout: a step takes a ``torch.Generator`` on the model's device
(dropout masks, VAE noise); with none, dropout is off and every noise draw
is 0. ``guided_training`` draws one instruction per sample on the device.
``alt_model`` (a model of the same parameter names, for instance the token
filter toggled off) runs every other step on the main model's parameters:
the trainer makes its parameters the main model's own Parameter objects, so
that the backward's per-block recompute reads the trained weights too (a
``functional_call`` swaps them back before the backward runs).

The compiled step (the JAX trainer's jitted ``_build_step``, which jits loss,
gradients, the optax chain and the update as one program): on the card each
kind of micro-step (``StepKey``: main or alternate model, accumulating or
updating, with or without noise streams and a guided draw; the batch's
layout) is one CUDA graph in ``graphs`` (core/compiled.py's ``GraphCache``,
one memory pool): the batch's copy into static inputs, the loss, the
gradients through K1 / K6 and their recompute backward, the MultiSteps
mean, every group's clipped AdamW and, on an NCCL mesh, the gathers and
all-reduces. The first call of a kind runs the step eagerly and captures
it; every later call replays it. The eager step and the graph are one
function (``_step_body``), whose every value the host changes from step to
step is a device tensor: the optimizer's state and counts, and one vector
of scalars the host fills before the call (curiosity on, the KL weight, the
MultiSteps divisor, each group's learning rate and bias corrections, from
the host's copy of the update count). Draws come from one generator a
stream (``NOISE_STREAMS``, ``GUIDE_STREAM``), registered with the graph and
seeded before each replay as the eager ``fold_in`` chain seeds them.
``reset_params`` and the checkpoint loaders write the parameters in place
and reset the state in place, so the graphs stay valid. What the step reads
from Python (``CAIM_TRAIN_REMAT``, the config's weights) is read at capture,
as JAX reads it while tracing. The eval forward is one graph a batch shape.
The pipelined (GPipe) step and a gloo mesh on the card run eagerly and say
so at construction; on the CPU every step runs eagerly.

Checkpoints are the JAX trainer's npz layout: ``params/<flat name>``
(``convert.flat_params``), ``meta/epoch``, ``meta/best_val_loss`` and
``__meta__/train_filter`` when the token filter trains, plus the adapters'
``__meta__/adapter_rank`` / ``_alpha`` / ``_targets`` stamps, which the JAX
trainer does not write and its loader skips; a ``.pth`` resumes
the model's parameters through ``io/checkpoint_torch.py``. A checkpoint of
either trainer loads in the other and in both engines.

On a mesh (``mesh=``, core/mesh.py; ``make_mesh()`` when None, the world-1
mesh without a process group, which changes nothing) the step is one SPMD
program, as the JAX trainer's jitted step over its mesh:

  * data parallelism over ``data`` (and ``replica``): ``train_step`` takes
    the global batch on every rank, each rank runs the forward on its rows
    (``shard_batch``), and the predictions, curiosity scores and focal
    entropies are gathered (``comm.gather_batch``), so every rank computes
    the global batch's loss; the gradients are summed over the batch axes
    once an update, after the micro-steps' mean. Random draws take the
    global batch's values (``comm.batch_shard``), so world N trains what
    world 1 does;
  * ``tensor_parallel`` over ``model`` (parallel/sharding.py): the blocks
    hold their ranks' pieces, the optimiser updates pieces, and the clip's
    global norm sums the split parameters' squares over ``model`` and counts
    each replicated one once;
  * ``pipeline_stages`` > 1 with ``pipeline_n_micro`` (parallel/pipeline.py)
    on a (data, pipe) mesh: the backbone runs the GPipe schedule. Every rank
    keeps the whole model, so evaluation and checkpoints are unchanged; the
    gradients of the blocks and the embedding are summed over ``pipe`` (each
    is whole on the stage that ran it and 0 elsewhere), the heads' are the
    same on every stage and are not.

``save_checkpoint_orbax`` / ``load_checkpoint_orbax`` keep the JAX names; the
format is ``torch.distributed.checkpoint`` (DCP), not orbax: every rank
writes and reads only its own pieces (split parameters as DTensors, the fused
qkv as [3, D, D] split on its middle dim), and a checkpoint saved on one
mesh loads onto a mesh of another shape. The npz checkpoints are written by
rank 0 from the whole parameters.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import math
import os
import shutil
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from cognitive_aim_tpu_torch.convert import flat_params, load_flat_params
from cognitive_aim_tpu_torch.core.compiled import GraphCache
from cognitive_aim_tpu_torch.core.mesh import MODEL_AXIS, batch_axes, batch_rows, make_mesh
from cognitive_aim_tpu_torch.core.rng import NoiseMode, Streams, fold_in, fold_seed
from cognitive_aim_tpu_torch.models import guidance as G
from cognitive_aim_tpu_torch.models.config import token_filter_spec
from cognitive_aim_tpu_torch.parallel import comm
from cognitive_aim_tpu_torch.parallel import pipeline as PL
from cognitive_aim_tpu_torch.parallel.sharding import (
    param_shardings,
    shard_params,
    spec_for,
    unsharded,
)
from cognitive_aim_tpu_torch.train import losses as LS
from cognitive_aim_tpu_torch.train.metrics import calculate_depth_metrics
from cognitive_aim_tpu_torch.train.schedules import beta_schedule

logger = logging.getLogger(__name__)

# a step's device scalars, one f32 vector the host fills before each call:
# curiosity on (1 or 0), the KL weight, the MultiSteps divisor (mini-step +
# 1), then each group's learning rate and bias corrections
_CUR, _KL, _ACC_DIV, _GROUP0 = 0, 1, 2, 3
# the streams the model folds out of a step's generator (curiosity, focal,
# dropout; 99 the fused features' dropout: models/cognitive_aim.py), and
# the guided-training draw's
NOISE_STREAMS = (0, 1, 2, 99)
GUIDE_STREAM = 1 << 20


class StepKey(NamedTuple):
    """What a captured micro-step is specialised on, besides the batch's
    layout: the alternate model or the main one, an update or an
    accumulation only, noise streams (a generator given), a guided draw."""
    alt: bool
    update: bool
    noise: bool
    guided_draw: bool


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 2e-5
    weight_decay: float = 0.015
    epochs: int = 10
    batch_size: int = 8
    accumulation_steps: int = 1
    scheduler: str = "cosine"  # cosine | warmup_cosine | step
    warmup_epochs: int = 0
    grad_clip: float = 1.0
    loss_lambda: float = 0.5
    curiosity_warmup_epochs: int = 0
    curiosity_weight: float = 0.1
    curiosity_loss_type: str = "robust"
    uncertainty_weight: float = 0.1
    attention_entropy_weight: float = 0.0
    # the curiosity KL weight's schedule over epochs (train/schedules.py)
    beta_schedule: str = "constant"
    beta_start: float = 0.1
    beta_end: float = 0.1
    log_interval: int = 10
    save_interval: int = 1
    steps_per_epoch: int = 100  # for the learning-rate schedule
    freeze_backbone: bool = True
    tensor_parallel: bool = False
    seed: int = 0
    # "sample" draws the VAE noise at validation, "zeros" makes it 0
    eval_noise_mode: str = "sample"
    # one uniform random instruction per sample per step
    guided_training: bool = False
    # train the backbone adapters only; with sandwich_heads also every
    # non-backbone tensor, at heads_lr where > 0
    train_only_lora: bool = False
    sandwich_heads: bool = False
    heads_lr: float = 0.0
    pipeline_stages: int = 0
    pipeline_n_micro: int = 4
    rich_logging: bool = False
    num_save_images: int = 12

    @classmethod
    def from_raw(cls, raw: Dict[str, Any], steps_per_epoch: int = 100):
        """The shipped YAML schema, with the JAX trainer's fallbacks for the
        keys a config may lack."""
        tr = raw.get("training", {})
        cur = raw.get("curiosity", raw.get("model", {}).get("curiosity", {})) or {}
        loss_cfg = tr.get("loss", {}) if isinstance(tr.get("loss"), dict) else {}
        logging_cfg = raw.get("logging", {})
        vp = cur.get("variational_params", {})
        return cls(
            learning_rate=float(tr.get("learning_rate", 2e-5)),
            weight_decay=float(tr.get("weight_decay", 0.015)),
            epochs=int(tr.get("epochs", 10)),
            batch_size=int(tr.get("batch_size", 8)),
            accumulation_steps=int(tr.get("accumulation_steps", 1)),
            scheduler=str(tr.get("scheduler", "cosine")),
            warmup_epochs=int(tr.get("warmup_epochs", 0)),
            grad_clip=float(tr.get("grad_clip_value", 1.0)),
            loss_lambda=float(loss_cfg.get("lambda", cur.get("lambda", 0.5))),
            curiosity_warmup_epochs=int(cur.get("warmup_epochs", 0)),
            curiosity_loss_type=str(cur.get("loss_type", "robust")),
            uncertainty_weight=float(cur.get("uncertainty_weight", 0.1)),
            attention_entropy_weight=float(tr.get("attention_entropy_weight", 0.0)),
            beta_schedule=str(vp.get("beta_schedule", "constant")),
            beta_start=float(vp.get("beta_start", 0.1)),
            beta_end=float(vp.get("beta_end", 0.1)),
            log_interval=int(logging_cfg.get("log_interval", 10)),
            save_interval=int(logging_cfg.get("save_interval", tr.get("save_every", 1))),
            steps_per_epoch=steps_per_epoch,
            freeze_backbone=bool(raw.get("freeze_backbone",
                                         raw.get("model", {}).get("freeze_backbone", True))),
            eval_noise_mode=str(raw.get("validation", {}).get("noise_mode", "sample")),
            guided_training=bool(tr.get("guided_training", False)),
            rich_logging=any(
                logging_cfg.get("curiosity", {}).get(k)
                for k in ("log_curiosity_stats", "log_attention_weights",
                          "log_exploration_history", "save_curiosity_heatmaps")),
            num_save_images=int(logging_cfg.get("num_save_images", 12)),
        )


def scalar_depth_target(depths: torch.Tensor) -> torch.Tensor:
    """[B] per-image target: the spatial mean of [B, H, W] maps, or [B]
    scalars as they are."""
    if depths.ndim == 1:
        return depths
    return depths.reshape(depths.shape[0], -1).mean(dim=1)


def _batch_tensors(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A batch's tensors, flat (``exif/<name>``) and where they are (host
    arrays as host tensors): float32 images and depths, int64 guidance."""
    def t(v, dtype=None):
        return torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v, dtype=dtype)

    out = {"images": t(batch["images"], torch.float32),
           "depths": t(batch["depths"], torch.float32)}
    if "guidance" in batch:
        out["guidance"] = t(batch["guidance"], torch.long)
    for k, v in batch.get("exif", {}).items():
        out[f"exif/{k}"] = t(v)
    return out


def _nest(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """``_batch_tensors``' layout back to the trainer's batch (``exif`` a
    dict, where there is one)."""
    batch = {k: v for k, v in flat.items() if not k.startswith("exif/")}
    exif = {k[len("exif/"):]: v for k, v in flat.items() if k.startswith("exif/")}
    if exif:
        batch["exif"] = exif
    return batch


def lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """The learning rate at optimizer update ``count`` (0 for the first):
    the JAX trainer's optax schedules."""
    lr = cfg.learning_rate
    k = max(1, cfg.accumulation_steps)
    total = max(1, cfg.epochs * cfg.steps_per_epoch // k)
    warm = cfg.warmup_epochs * cfg.steps_per_epoch // k

    def cosine(init: float, steps: int, alpha: float):
        if steps <= 0:
            raise ValueError(f"the cosine schedule needs positive decay steps, got {steps}")

        def f(count):
            c = min(count, steps)
            return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / steps)) + alpha)
        return f

    if cfg.scheduler in ("warmup_cosine", "cosine"):
        if warm > 0:
            decay = cosine(lr, total - warm, 1e-6 / lr)

            def warmup_cosine(count):
                if count < warm:
                    return -lr * (1.0 - count / warm) + lr
                return decay(count - warm)
            return warmup_cosine
        return cosine(lr, total, 1e-6 / lr)
    # StepLR(step_size = 30 epochs, gamma = 0.1)
    period = 30 * cfg.steps_per_epoch
    return lambda count: lr * 0.1 ** (count // period)


class _AdamWGroup:
    """optax ``chain(clip_by_global_norm(clip), adamw(lr, wd))`` over one
    group of parameters (updated in place). ``split`` marks the parameters
    that a tensor-parallel rank holds a piece of: their squares are summed
    over ``tp_group`` for the global norm.

    The state lives on the device, as optax's: the moments and the update
    count. The update reads its learning rate and bias corrections from
    device scalars the host fills before the step (``scalars``, from the
    host's copy of the count, ``updates``), so that one captured update
    serves every count."""

    def __init__(self, params: List[torch.nn.Parameter], lr: Callable[[int], float],
                 weight_decay: float, clip: float, split: Optional[List[bool]] = None,
                 tp_group=None):
        self.params = params
        self.lr, self.wd, self.clip = lr, weight_decay, clip
        self.split = [i for i, s in enumerate(split or []) if s]
        self.tp_group = tp_group
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.count = torch.zeros((), dtype=torch.int64,
                                 device=params[0].device if params else None)
        self.updates = 0  # the host's copy of ``count``

    def reset(self):
        """Fresh state, in place: the captured steps keep reading these
        buffers."""
        if self.params:
            torch._foreach_zero_(self.mu)
            torch._foreach_zero_(self.nu)
        self.count.zero_()
        self.updates = 0

    def scalars(self) -> List[float]:
        """The next update's learning rate and bias corrections (host
        values, for the step's device scalars)."""
        c = self.updates
        return [self.lr(c), 1 - 0.9 ** (c + 1), 1 - 0.999 ** (c + 1)]

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], lr: torch.Tensor, bc1: torch.Tensor,
               bc2: torch.Tensor):
        """One update from ``grads``; ``lr``, ``bc1``, ``bc2``: 0-d device
        tensors (``scalars``)."""
        if not self.params:
            return
        b1, b2, eps = 0.9, 0.999, 1e-8
        sq = [(g.float() ** 2).sum() for g in grads]
        if self.split and self.tp_group is not None:
            part = comm.all_reduce_(torch.stack([sq[i] for i in self.split]), self.tp_group)
            for j, i in enumerate(self.split):
                sq[i] = part[j]
        gn = torch.sqrt(torch.stack(sq).sum())
        keep = gn < self.clip  # a device scalar: no host sync
        grads = [torch.where(keep, g, (g / gn) * self.clip) for g in grads]
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                        1 - b2))
        self.count.add_(1)
        den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(self.nu, bc2)), eps)
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc1), den)
        if self.wd:
            torch._foreach_add_(upd, torch._foreach_mul(self.params, self.wd))
        torch._foreach_add_(self.params, torch._foreach_mul(upd, lr.neg()))


class Trainer:
    def __init__(self, model, cfg: TrainConfig, output_dir: str = "./outputs",
                 writer=None, alt_model=None, mesh=None):
        """``model``: a CognitiveAimModel with float32 parameters, trained in
        place. ``alt_model``: a second variant with the same parameter names
        (the token filter toggled off, say), run on the main model's
        parameters at every other step, so the weights stay native to both
        paths. ``mesh``: the core/mesh.py mesh of the step (``make_mesh()``
        when None; a (data, pipe) mesh of ``pipeline_stages`` under
        pipelining)."""
        self.device = next(model.parameters()).device
        if cfg.pipeline_stages > 1:
            if cfg.tensor_parallel:
                raise ValueError(
                    "pipeline_stages and tensor_parallel are mutually "
                    "exclusive (the pipe mesh has no `model` axis)")
            if mesh is None:
                mesh = PL.make_pipeline_mesh(cfg.pipeline_stages)
            elif PL.PIPE_AXIS not in mesh.axis_names:
                raise ValueError(
                    f"pipeline_stages={cfg.pipeline_stages} needs a mesh "
                    f"with a 'pipe' axis, got {mesh.axis_names}")
        self.mesh = mesh if mesh is not None else make_mesh(device=self.device)
        self.model = model
        self.alt_model = alt_model
        self.cfg = cfg
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.writer = writer
        self.epoch = 0
        self.best_val_loss = float("inf")
        # the card's captured steps and eval forwards (one pool, one lock);
        # None on the CPU, for the pipelined step and under gloo, which run
        # eagerly and say so
        self.graphs: Optional[GraphCache] = None
        gloo = self.mesh.distributed and torch.distributed.get_backend() != "nccl"
        if self.device.type == "cuda" and not (self.pipelined or gloo):
            self.graphs = GraphCache(self.device)
        elif self.device.type == "cuda":
            logger.warning("the training step runs eagerly: %s",
                           f"pipeline_stages={cfg.pipeline_stages} (the GPipe step's capture "
                           "is not ported)" if self.pipelined else
                           "gloo's collectives pass through the host, which a CUDA graph "
                           "cannot capture")
        self._opt_key = None
        if alt_model is not None:
            self._share_parameters()
        self._place()
        self._reset_optimizer()

    @property
    def pipelined(self) -> bool:
        return self.cfg.pipeline_stages > 1

    def _place(self):
        """Shard the parameters on the mesh (shard_params) and hand the
        alternate model's blocks the same ``model`` group."""
        shard_params(self.mesh, self.model, self.cfg.tensor_parallel)
        if self.alt_model is not None:
            for a, b in zip(self.alt_model.backbone.layers, self.model.backbone.layers):
                a.tp = b.tp

    # ------------------------------------------------------- optimizer ----
    def _label(self, name: str) -> str:
        parts = name.split(".")
        c = self.cfg
        if c.train_only_lora:
            if any(p.startswith("lora") for p in parts):
                return "train"
            if c.sandwich_heads and parts[0] != "backbone":
                return "train_heads"
            return "freeze"
        if c.freeze_backbone and parts[0] == "backbone":
            return "train" if any(p in ("lora_A", "lora_B") for p in parts) else "freeze"
        return "train"

    def _share_parameters(self):
        """Make every parameter of ``alt_model`` the main model's Parameter
        of the same name, so both variants read and train one set."""
        mine = dict(self.model.named_parameters())
        theirs = [n for n, _ in self.alt_model.named_parameters()]
        if set(theirs) != set(mine):
            raise ValueError(f"alt_model's parameters differ from the model's: "
                             f"{sorted(set(theirs) ^ set(mine))[:6]}")
        for name in theirs:
            owner, _, leaf = name.rpartition(".")
            mod = self.alt_model.get_submodule(owner) if owner else self.alt_model
            if mod._parameters[leaf].shape != mine[name].shape:
                raise ValueError(f"alt_model {name}: shape {tuple(mod._parameters[leaf].shape)}"
                                 f" != {tuple(mine[name].shape)}")
            mod._parameters[leaf] = mine[name]

    def _reset_optimizer(self):
        """Fresh optimizer state (moments, counts, accumulator). Where the
        trained parameters, their groups and the optimizer's settings are
        those of the state held, it is reset in place and every captured
        step is kept; else it is made anew and the graphs are dropped."""
        c = self.cfg
        if self.alt_model is not None:
            self._share_parameters()
        named = list(self.model.named_parameters())
        labels = {n: self._label(n) for n, _ in named}
        for n, p in named:
            p.requires_grad_(labels[n] != "freeze")
        trainable = [(n, p) for n, p in named if labels[n] != "freeze"]
        key = (tuple((n, id(p), tuple(p.shape), labels[n]) for n, p in trainable),
               c.weight_decay, c.grad_clip, c.heads_lr > 0.0 and c.sandwich_heads,
               c.accumulation_steps, c.tensor_parallel)
        sched = lr_schedule(c)
        heads_lr = sched
        if c.sandwich_heads and c.heads_lr > 0.0:
            heads_lr = lambda count: c.heads_lr  # noqa: E731
        self._mini_step = 0
        self._global_step = 0
        if key == self._opt_key:
            self._groups["train"].lr, self._groups["train_heads"].lr = sched, heads_lr
            for group in self._groups.values():
                group.reset()
            if self._acc is not None:
                torch._foreach_zero_(self._acc)
            return
        self._opt_key, self.labels, self._trainable = key, labels, trainable
        specs = param_shardings(self.mesh, self.model, c.tensor_parallel)
        tp_group = comm.group_of(self.mesh, MODEL_AXIS) if c.tensor_parallel else None
        self._groups = {
            label: _AdamWGroup([p for n, p in self._trainable if self.labels[n] == label],
                               sched if label == "train" else heads_lr,
                               c.weight_decay, c.grad_clip,
                               [specs[n].dim is not None for n, _ in self._trainable
                                if self.labels[n] == label], tp_group)
            for label in ("train", "train_heads")}
        # under pipelining: the blocks' and the embedding's gradients, whole on
        # the stage that ran them, are summed over `pipe`
        self._pipe_summed = [self.pipelined and n.startswith("backbone.")
                             and not n.startswith("backbone.final_norm")
                             for n, _ in self._trainable]
        # MultiSteps' running mean of the micro-gradients
        self._acc: Optional[List[torch.Tensor]] = (
            [torch.zeros_like(p) for _, p in self._trainable]
            if max(1, c.accumulation_steps) > 1 else None)
        if self.graphs is not None:
            self.graphs.graphs.clear()

    @contextlib.contextmanager
    def _same_storage(self):
        """Parameters whose storage the body replaced (``unsharded``
        shards into new tensors) get their values copied back into the old
        storage, which the captured steps read."""
        held = [(p, p.data) for p in self.model.parameters()]
        yield
        with torch.no_grad():
            for p, data in held:
                if p.data.data_ptr() != data.data_ptr():
                    data.copy_(p.data)
                    p.data = data

    def reset_params(self, flat: Optional[Dict[str, np.ndarray]] = None):
        """Load the flat interchange ``flat`` (when given; whole parameters,
        sharded again on the mesh) and start the optimizer afresh, keeping
        every captured step (the parameters are loaded in place): sweep
        scripts train several checkpoints in one process."""
        if flat is not None:
            with self._same_storage(), unsharded(self.model):
                load_flat_params(self.model, flat)
        self._reset_optimizer()

    def _reduce(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Sum the gradients over the batch axes (and, under pipelining, the
        blocks' and embedding's over ``pipe``), one flat buffer a group."""
        m = self.mesh
        if not m.distributed or not grads:
            return grads
        sizes = [g.numel() for g in grads]
        flat = torch.cat([g.reshape(-1) for g in grads])
        axes = batch_axes(m)
        for axis in axes if isinstance(axes, tuple) else (axes,):
            comm.all_reduce_(flat, m.group(axis))
        out = [t.view_as(g) for t, g in zip(flat.split(sizes), grads)]
        if any(self._pipe_summed):
            idx = [i for i, s in enumerate(self._pipe_summed) if s]
            pipe = comm.all_reduce_(torch.cat([out[i].reshape(-1) for i in idx]),
                                    m.group(PL.PIPE_AXIS))
            for i, t in zip(idx, pipe.split([sizes[i] for i in idx])):
                out[i] = t.view_as(grads[i])
        return out

    def _apply(self, grads: List[torch.Tensor], scalars: torch.Tensor, update: bool):
        """MultiSteps: the running mean of k micro-gradients, divided by the
        device scalar ``scalars[_ACC_DIV]`` (mini-step + 1); on the k-th
        (``update``) the groups' updates from it, and the mean back to 0.
        With k = 1 every micro-step updates."""
        if self._acc is not None:
            torch._foreach_add_(self._acc, torch._foreach_div(
                torch._foreach_sub(grads, self._acc), scalars[_ACC_DIV]))
            if not update:
                return
            grads = self._acc
        reduced = self._reduce(grads)
        for j, (label, group) in enumerate(self._groups.items()):
            lr, bc1, bc2 = scalars[_GROUP0 + 3 * j:_GROUP0 + 3 * j + 3]
            group.update([g for (n, _), g in zip(self._trainable, reduced)
                          if self.labels[n] == label], lr, bc1, bc2)
        if self._acc is not None:
            torch._foreach_zero_(self._acc)

    # ------------------------------------------------------------ step ----
    def loss(self, model, batch: Dict[str, Any], generator, curiosity_on, kl_w,
             guide: Optional[torch.Generator] = None):
        """(total loss, logs): the JAX trainer's loss on ``model``'s training
        forward. batch holds device tensors (``device_batch``) of the global
        batch; on a mesh the forward runs this rank's rows and the loss the
        gathered global batch's. ``generator``: a torch.Generator or the
        ``Streams`` folded out of one (None: no dropout, noise 0);
        ``curiosity_on``: a bool or a 0-d bool tensor; ``kl_w``: a float or
        a 0-d tensor; ``guide``: the guided-training draw's generator (by
        default folded out of ``generator``, or seeded from the config's
        seed and the step)."""
        cfg = self.cfg
        guidance = batch.get("guidance")
        B = batch["images"].shape[0]
        if guidance is None and cfg.guided_training:
            g = guide
            if g is None:
                g = fold_in(generator, GUIDE_STREAM) if generator is not None else \
                    torch.Generator(self.device).manual_seed(self._guide_seed())
            guidance = torch.randint(0, len(G.INSTRUCTIONS), (B,), generator=g,
                                     device=self.device)
        m, axes = self.mesh, batch_axes(self.mesh)
        lo, hi = batch_rows(m, B)
        exif = batch.get("exif")
        if exif is not None:
            exif = {k: v[lo:hi] for k, v in exif.items()}
        pipe = dict(pipeline_mesh=m, pipeline_n_micro=cfg.pipeline_n_micro) \
            if self.pipelined else {}
        shard = comm.batch_shard(m, lo, hi, B, axes) if m.distributed else contextlib.nullcontext()
        with shard:
            out = model(batch["images"][lo:hi], exif,
                        guidance=None if guidance is None else guidance[lo:hi],
                        generator=generator, train=True, curiosity_kl_weight=kl_w, **pipe)
        pred = comm.gather_batch(out.depth[:, 0], m, axes)
        curiosity = comm.gather_batch(out.curiosity, m, axes)
        target = scalar_depth_target(batch["depths"])
        depth_loss = LS.scale_invariant_loss(pred, target, cfg.loss_lambda)
        cur_loss = LS.curiosity_loss(curiosity, (pred - target).abs())
        if not torch.is_tensor(curiosity_on):
            curiosity_on = torch.full((), bool(curiosity_on), device=cur_loss.device)
        cur_loss = torch.where(curiosity_on, cur_loss, torch.zeros_like(cur_loss))
        total = depth_loss + cfg.curiosity_weight * cur_loss
        if cfg.attention_entropy_weight > 0 and "attention_entropy" in out.aux:
            entropy = out.aux["attention_entropy"]
            if m.distributed:  # the mean of the ranks' batch means
                entropy = comm.gather_batch(entropy[None], m, axes).mean()
            total = total + cfg.attention_entropy_weight * entropy
        return total, {"loss": total, "depth_loss": depth_loss, "curiosity_loss": cur_loss}

    def _guide_seed(self) -> int:
        """The guided-training draw's seed in a step without a generator."""
        return fold_seed(self.cfg.seed, self._global_step)

    def step_inputs(self):
        """(curiosity_on, KL weight) of the current epoch."""
        c = self.cfg
        curiosity_on = bool(self.epoch >= c.curiosity_warmup_epochs
                            and self.model.arch.use_curiosity)
        kl_w = float(np.float32(beta_schedule(c.beta_schedule, c.beta_start, c.beta_end,
                                              c.epochs)(self.epoch)))
        return curiosity_on, kl_w

    def _step_body(self, model, inputs: Dict[str, torch.Tensor],
                   generators: Dict[int, torch.Generator], update: bool) -> Dict:
        """One micro-step on device tensors, the function both the eager
        step and the captured one run: the loss, its gradients, the
        MultiSteps mean and (``update``) the groups' updates, all in place.
        ``inputs``: the flat batch (``_step_inputs``) and the device scalars;
        ``generators``: stream -> generator (``NOISE_STREAMS``,
        ``GUIDE_STREAM``). Returns the loss logs, 0-d device tensors."""
        batch = _nest({k: v for k, v in inputs.items() if k != "scalars"})
        scalars = inputs["scalars"]
        noise = Streams({i: generators[i] for i in NOISE_STREAMS}) \
            if NOISE_STREAMS[0] in generators else None
        with PL.grad_anchors() as anchors:  # the pipelined backward's sends
            total, logs = self.loss(model, batch, noise, scalars[_CUR] > 0.5, scalars[_KL],
                                    guide=generators.get(GUIDE_STREAM))
        params = [p for _, p in self._trainable]
        got = torch.autograd.grad(total, params + anchors, allow_unused=True)[:len(params)]
        self._apply([torch.zeros_like(p) if g is None else g
                     for (_, p), g in zip(self._trainable, got)], scalars, update)
        return {k: v.detach() for k, v in logs.items()}

    def _step_inputs(self, batch: Dict[str, Any], update: bool) -> Dict[str, torch.Tensor]:
        """The batch as flat tensors where they are (host arrays as host
        tensors; ``exif/<name>``) and this step's scalars as one host f32
        vector (pinned for the card): curiosity on, the KL weight, the
        MultiSteps divisor, each group's learning rate and bias
        corrections."""
        out = _batch_tensors(batch)
        curiosity_on, kl_w = self.step_inputs()
        vals = [float(curiosity_on), kl_w, self._mini_step + 1]
        for group in self._groups.values():
            vals += group.scalars() if update else [0.0, 1.0, 1.0]
        out["scalars"] = torch.tensor(vals, dtype=torch.float32)
        if self.device.type == "cuda":  # copied without blocking the host
            out["scalars"] = out["scalars"].pin_memory()
        return out

    def _streams(self, batch, generator: Optional[torch.Generator]) -> Dict[int, int]:
        """Stream -> seed of this step: the model's noise streams folded out
        of ``generator`` (none without one) and the guided-training draw's."""
        seeds = {}
        if generator is not None:
            seeds = {i: fold_seed(generator.initial_seed(), i) for i in NOISE_STREAMS}
        if "guidance" not in batch and self.cfg.guided_training:
            seeds[GUIDE_STREAM] = fold_seed(generator.initial_seed(), GUIDE_STREAM) \
                if generator is not None else self._guide_seed()
        return seeds

    def train_step(self, batch: Dict[str, Any], generator: Optional[torch.Generator] = None,
                   fetch_logs: bool = True, alt: Optional[bool] = None,
                   eager: bool = False) -> Dict:
        """One micro-step: gradients of the loss, and an optimizer update
        every ``accumulation_steps``-th call. ``fetch_logs=False`` keeps the
        loss scalars on the device (no host sync). ``alt`` picks the model of
        this step: None runs ``alt_model`` on every odd step, True runs it,
        False the main model (a loop with its own schedule, such as one
        filtered step in N, passes it).

        On the card each kind of micro-step (main or alternate model,
        accumulating or updating, with or without noise and a guided draw)
        is one CUDA graph, run eagerly and captured at its first call and
        replayed after (``graphs``); ``eager=True`` runs the same step
        eagerly (the reference the graphs are held to). On the CPU and
        under pipelining the step runs eagerly."""
        model = self.model
        if alt is None:
            alt = self.alt_model is not None and self._global_step % 2 == 1
        if alt and self.alt_model is None:
            raise ValueError("train_step(alt=True) needs an alt_model")
        if alt:
            model = self.alt_model
        k = max(1, self.cfg.accumulation_steps)
        update = self._mini_step == k - 1
        inputs = self._step_inputs(batch, update)
        seeds = self._streams(batch, generator)
        if self.graphs is None or eager:
            dev = self.device
            gens = {s: torch.Generator(dev).manual_seed(v) for s, v in seeds.items()}
            with torch.enable_grad():
                logs = self._step_body(model, {n: v.to(dev, non_blocking=True)
                                               for n, v in inputs.items()}, gens, update)
        else:
            key = StepKey(bool(alt), update, NOISE_STREAMS[0] in seeds, GUIDE_STREAM in seeds)
            logs = self.graphs.run(key, inputs, functools.partial(
                self._step_body, model, update=update), seeds, stateful=True, grad=True,
                what="the training step")
        self._mini_step = (self._mini_step + 1) % k
        if update:
            for group in self._groups.values():
                group.updates += 1
        self._global_step += 1
        if fetch_logs:
            return {k: float(v) for k, v in logs.items()}
        return logs

    def device_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        return _nest({k: v.to(self.device) for k, v in _batch_tensors(batch).items()})

    # ----------------------------------------------------------- loops ----
    def train_epoch(self, loader, generator: Optional[torch.Generator]) -> Dict[str, float]:
        device_logs = []
        for i, batch in enumerate(loader):
            logs = self.train_step(batch, fold_in(generator, i), fetch_logs=False)
            device_logs.append(logs)
            if self.writer and i % self.cfg.log_interval == 0:
                gs = self.epoch * len(loader) + i
                self.writer.add_scalar("Train/BatchLoss", float(logs["loss"]), gs)
                self.writer.add_scalar("Train/DepthLoss", float(logs["depth_loss"]), gs)
                self.writer.add_scalar("Train/CuriosityLoss", float(logs["curiosity_loss"]), gs)
        if not device_logs:
            return {}
        return {k: float(torch.stack([d[k] for d in device_logs]).mean())
                for k in device_logs[0]}

    @torch.no_grad()
    def eval_forward(self, images: torch.Tensor, exif=None, eager: bool = False):
        """The validation forward: no dropout, the noise of
        ``cfg.eval_noise_mode`` from a generator seeded 0. On the card one
        CUDA graph a batch shape (a last partial batch gets its own, as a
        retrace of the JAX trainer's jitted eval would); ``eager=True`` runs
        it eagerly."""
        if self.graphs is None or eager:
            return self._eval_body(images, exif, torch.Generator(self.device).manual_seed(0))
        inputs = {"images": images, **{f"exif/{k}": v for k, v in (exif or {}).items()}}
        return self.graphs.run(("eval", self.cfg.eval_noise_mode), inputs, self._eval_fn,
                               {"eval": 0}, what="the eval forward")

    def _eval_fn(self, inputs: Dict[str, torch.Tensor], generators):
        exif = {k[len("exif/"):]: v for k, v in inputs.items() if k.startswith("exif/")}
        return self._eval_body(inputs["images"], exif or None, generators["eval"])

    def _eval_body(self, images, exif, generator):
        return self.model(images, exif, generator=generator,
                          noise_mode=NoiseMode(self.cfg.eval_noise_mode))

    def validate(self, loader) -> Dict[str, float]:
        total, n = 0.0, 0
        preds, targets, curiosities = [], [], []
        self._last_val_visuals = None
        for batch in loader:
            db = self.device_batch(batch)
            out = self.eval_forward(db["images"], db.get("exif"))
            if self.cfg.rich_logging:
                curiosities.append(out.curiosity.cpu().numpy())
                if self._last_val_visuals is None:
                    self._last_val_visuals = {"attention": out.attention.cpu().numpy(),
                                              "curiosity": out.curiosity.cpu().numpy()}
            pred = out.depth[:, 0]
            target = scalar_depth_target(db["depths"])
            total += float(LS.scale_invariant_loss(pred, target, self.cfg.loss_lambda))
            preds.append(pred.cpu().numpy())
            targets.append(target.cpu().numpy())
            n += 1
        metrics = {}
        if preds:
            metrics = calculate_depth_metrics(np.concatenate(preds), np.concatenate(targets))
        metrics["val_loss"] = total / max(n, 1)
        if self.cfg.rich_logging and curiosities:
            allc = np.concatenate(curiosities)
            metrics["curiosity_mean"] = float(allc.mean())
            metrics["curiosity_std"] = float(allc.std())
        return metrics

    def _log_rich(self, epoch: int):
        """Attention heatmaps, curiosity statistics and the exploration
        record to the writer (the configs' logging.curiosity block)."""
        vis = getattr(self, "_last_val_visuals", None)
        if not (self.writer and vis):
            return
        attn = vis["attention"]  # [B, N]
        g = int(attn.shape[1] ** 0.5)
        for i in range(min(self.cfg.num_save_images, attn.shape[0])):
            hm = attn[i, : g * g].reshape(g, g)
            lo, hi = float(hm.min()), float(hm.max())
            hm = (hm - lo) / (hi - lo + 1e-12)
            self.writer.add_image(f"Val/AttentionHeatmap/{i}", hm[None].astype(np.float32),
                                  epoch)
        if hasattr(self.model, "exploration_history"):
            self.model.record_exploration(vis["curiosity"])
            for k, v in self.model.get_exploration_stats().items():
                if isinstance(v, (int, float)):
                    self.writer.add_scalar(f"Exploration/{k}", v, epoch)

    def fit(self, train_loader, val_loader, epochs: Optional[int] = None):
        epochs = epochs or self.cfg.epochs
        gen = torch.Generator(self.device).manual_seed(self.cfg.seed)
        history = []
        for epoch in range(self.epoch, epochs):
            self.epoch = epoch
            train_logs = self.train_epoch(train_loader, fold_in(gen, epoch))
            val = self.validate(val_loader)
            if self.writer:
                if "loss" in train_logs:
                    self.writer.add_scalar("Train/EpochLoss", train_logs["loss"], epoch)
                    self.writer.add_scalar("Train/DepthLoss", train_logs["depth_loss"], epoch)
                self.writer.add_scalar("Val/Loss", val["val_loss"], epoch)
                for k in ("rmse", "mae", "abs_rel", "delta1", "curiosity_mean",
                          "curiosity_std"):
                    if k in val:
                        self.writer.add_scalar(f"Val/{k}", val[k], epoch)
                if self.cfg.rich_logging:
                    self._log_rich(epoch)
            is_best = val["val_loss"] < self.best_val_loss
            if is_best:
                self.best_val_loss = val["val_loss"]
            if epoch % self.cfg.save_interval == 0 or is_best:
                self.save_checkpoint(is_best)
            history.append({"epoch": epoch, **train_logs, **val})
        return history

    # ----------------------------------------------------- checkpoints ----
    def _dcp_state(self) -> Dict[str, Any]:
        """Parameter name -> this rank's piece as ``torch.distributed.checkpoint``
        reads and writes it: a DTensor on the mesh's DeviceMesh (Shard on the
        ``model`` axis for a split parameter, Replicate elsewhere) viewing the
        parameter's storage, or the plain tensor on the mesh without a process
        group. The fused qkv is stored as [3, D, ...] (split on its second dim
        under tensor parallelism), with or without it, so the layout is the
        same on every mesh."""
        specs = param_shardings(self.mesh, self.model, self.cfg.tensor_parallel)
        dm = self.mesh.device_mesh
        state = {}
        for name, p in self.model.named_parameters():
            spec, t = specs[name], p.data
            rule = spec_for(name, tensor_parallel=True)  # the layout, split or not
            dim = rule.dim
            if rule.parts > 1:
                t = t.view(*t.shape[:dim], rule.parts, -1, *t.shape[dim + 1:])
                dim += 1
            if dm is not None:
                from torch.distributed.tensor import DTensor, Replicate, Shard

                place = [Shard(dim) if spec.dim is not None and a in spec.axes else Replicate()
                         for a in self.mesh.axis_names]
                t = DTensor.from_local(t, dm, place, run_check=False)
            state[name] = t
        return state

    def save_checkpoint_orbax(self, path: str):
        """Sharding-aware checkpoint of the parameters, in the
        ``torch.distributed.checkpoint`` (DCP) format, not orbax: every rank
        writes only its own pieces, a replicated tensor once."""
        import torch.distributed.checkpoint as dcp

        dcp.save(self._dcp_state(), checkpoint_id=os.path.abspath(path),
                 no_dist=not self.mesh.distributed)

    def load_checkpoint_orbax(self, path: str):
        """Sharding-aware restore from ``save_checkpoint_orbax``'s DCP
        directory, written on a mesh of any shape: every rank reads only the
        pieces it holds, into the parameters in place. The optimizer
        restarts."""
        import torch.distributed.checkpoint as dcp

        dcp.load(self._dcp_state(), checkpoint_id=os.path.abspath(path),
                 no_dist=not self.mesh.distributed)
        self._reset_optimizer()

    def save_checkpoint(self, is_best: bool, filename: str = "checkpoint.npz"):
        """latest + best copy + per-epoch file, the JAX trainer's npz, of
        the whole parameters (gathered on a tensor-parallel mesh), written by
        rank 0."""
        path = os.path.join(self.output_dir, filename)
        with self._same_storage(), unsharded(self.model):
            flat = flat_params(self.model)
        if self.mesh.rank != 0:
            return
        state = {
            **{f"params/{k}": v for k, v in flat.items()},
            "meta/epoch": np.asarray(self.epoch),
            "meta/best_val_loss": np.asarray(self.best_val_loss),
        }
        # provenance: weights trained WITH an active token filter, and the
        # adapters' rank, alpha and targets, which a filtered engine needs to
        # fold them (the JAX trainer stamps neither adapter field)
        arch = getattr(self.model, "arch", None)
        if arch is not None and getattr(arch, "token_filter_train", False):
            spec = token_filter_spec(arch)
            if spec:
                state["__meta__/train_filter"] = np.asarray(spec)
        if arch is not None and arch.use_lora:
            state["__meta__/adapter_rank"] = np.asarray(str(arch.lora_rank))
            state["__meta__/adapter_alpha"] = np.asarray(str(arch.lora_alpha))
            state["__meta__/adapter_targets"] = np.asarray(",".join(arch.lora_targets))
        np.savez(path, **state)
        if is_best:
            shutil.copyfile(path, os.path.join(self.output_dir, "model_best.npz"))
        shutil.copyfile(path, os.path.join(self.output_dir,
                                           f"checkpoint_epoch_{self.epoch}.npz"))

    def load_checkpoint(self, path: str):
        """An npz of either trainer (parameters, epoch + 1, best loss), or a
        reference ``.pth`` (the model's parameters only). The optimizer
        restarts."""
        if path.endswith((".pth", ".pt")):
            from cognitive_aim_tpu_torch.io import checkpoint_torch as ct

            sd = ct.load_torch_file(path)
            incoming: Dict[str, np.ndarray] = {}

            def take(prefix, fn):
                try:
                    incoming.update({f"{prefix}{k}": v for k, v in fn().items()})
                except KeyError:
                    pass

            take("backbone/", lambda: ct.convert_backbone(sd, "backbone."))
            take("ambient_stream/", lambda: ct.convert_ambient(sd))
            take("focal_stream/", lambda: ct.convert_iterative_focal(sd))
            take("exif_prior/", lambda: ct.convert_exif_prior(sd))
            take("curiosity_module/", lambda: ct.convert_curiosity(sd))
            take("", lambda: ct.convert_heads(sd))
            # sharded again on the mesh after the merge, into the same storage
            with self._same_storage(), unsharded(self.model):
                merged, loaded, skipped = ct.filter_and_merge(flat_params(self.model),
                                                              incoming)
                load_flat_params(self.model, merged)
            self._reset_optimizer()
            print(f"Resumed model params from torch ckpt {path}: "
                  f"{loaded} tensors ({skipped} skipped); optimizer reset")
            return
        with np.load(path) as data:
            flat = {k[len("params/"):]: data[k] for k in data.files if k.startswith("params/")}
            epoch = int(data["meta/epoch"])
            best = float(data["meta/best_val_loss"])
        with self._same_storage(), unsharded(self.model):
            load_flat_params(self.model, flat)
        self._reset_optimizer()
        self.epoch = epoch + 1
        self.best_val_loss = best
