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

Checkpoints are the JAX trainer's npz layout: ``params/<flat name>``
(``convert.flat_params``), ``meta/epoch``, ``meta/best_val_loss`` and
``__meta__/train_filter`` when the token filter trains, plus the adapters'
``__meta__/adapter_rank`` / ``_alpha`` / ``_targets`` stamps, which the JAX
trainer does not write and its loader skips; a ``.pth`` resumes
the model's parameters through ``io/checkpoint_torch.py``. A checkpoint of
either trainer loads in the other and in both engines.

Not in this package: ``tensor_parallel``, ``pipeline_stages`` and the orbax
checkpoints (sharding-aware; they belong with the parallel modules). The
trainer raises ``NotImplementedError`` where they are asked for.
"""

from __future__ import annotations

import dataclasses
import math
import os
import shutil
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from cognitive_aim_tpu_torch.convert import flat_params, load_flat_params
from cognitive_aim_tpu_torch.core.rng import NoiseMode, fold_in
from cognitive_aim_tpu_torch.models import guidance as G
from cognitive_aim_tpu_torch.models.config import token_filter_spec
from cognitive_aim_tpu_torch.train import losses as LS
from cognitive_aim_tpu_torch.train.metrics import calculate_depth_metrics
from cognitive_aim_tpu_torch.train.schedules import beta_schedule


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
    tensor_parallel: bool = False  # not in this package: raises
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
    pipeline_stages: int = 0  # not in this package: > 1 raises
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
    group of parameters (updated in place)."""

    def __init__(self, params: List[torch.nn.Parameter], lr: Callable[[int], float],
                 weight_decay: float, clip: float):
        self.params = params
        self.lr, self.wd, self.clip = lr, weight_decay, clip
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.count = 0

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]):
        if not self.params:
            return
        b1, b2, eps = 0.9, 0.999, 1e-8
        gn = torch.sqrt(torch.stack([(g.float() ** 2).sum() for g in grads]).sum())
        keep = gn < self.clip  # a device scalar: no host sync
        grads = [torch.where(keep, g, (g / gn) * self.clip) for g in grads]
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                        1 - b2))
        lr = self.lr(self.count)
        self.count += 1
        bc1, bc2 = 1 - b1 ** self.count, 1 - b2 ** self.count
        den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(self.nu, bc2)), eps)
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc1), den)
        if self.wd:
            torch._foreach_add_(upd, torch._foreach_mul(self.params, self.wd))
        torch._foreach_add_(self.params, torch._foreach_mul(upd, -lr))


class Trainer:
    def __init__(self, model, cfg: TrainConfig, output_dir: str = "./outputs",
                 writer=None, alt_model=None):
        """``model``: a CognitiveAimModel with float32 parameters, trained in
        place. ``alt_model``: a second variant with the same parameter names
        (the token filter toggled off, say), run on the main model's
        parameters at every other step, so the weights stay native to both
        paths."""
        if cfg.tensor_parallel or cfg.pipeline_stages > 1:
            raise NotImplementedError(
                "tensor_parallel and pipeline_stages are not ported: they are "
                "sharding-aware and belong with the parallel modules")
        self.model = model
        self.alt_model = alt_model
        self.cfg = cfg
        self.device = next(model.parameters()).device
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.writer = writer
        self.epoch = 0
        self.best_val_loss = float("inf")
        self._reset_optimizer()

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
        """Fresh optimizer state (groups, moments, counts, accumulator)."""
        c = self.cfg
        if self.alt_model is not None:
            self._share_parameters()
        named = list(self.model.named_parameters())
        self.labels = {n: self._label(n) for n, _ in named}
        for n, p in named:
            p.requires_grad_(self.labels[n] != "freeze")
        self._trainable = [(n, p) for n, p in named if self.labels[n] != "freeze"]
        sched = lr_schedule(c)
        heads_lr = sched
        if c.sandwich_heads and c.heads_lr > 0.0:
            heads_lr = lambda count: c.heads_lr  # noqa: E731
        self._groups = {
            label: _AdamWGroup([p for n, p in self._trainable if self.labels[n] == label],
                               sched if label == "train" else heads_lr,
                               c.weight_decay, c.grad_clip)
            for label in ("train", "train_heads")}
        self._acc: Optional[List[torch.Tensor]] = None
        self._mini_step = 0
        self._global_step = 0

    def reset_params(self, flat: Optional[Dict[str, np.ndarray]] = None):
        """Load the flat interchange ``flat`` (when given) and start the
        optimizer afresh: sweep drivers train several checkpoints in one
        process."""
        if flat is not None:
            load_flat_params(self.model, flat)
        self._reset_optimizer()

    def _apply(self, grads: List[torch.Tensor]):
        """MultiSteps: average k micro-gradients, update on the k-th."""
        k = max(1, self.cfg.accumulation_steps)
        if k > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            n = self._mini_step
            torch._foreach_add_(self._acc, torch._foreach_div(
                torch._foreach_sub(grads, self._acc), n + 1))
            self._mini_step = (n + 1) % k
            if self._mini_step != 0:
                return
            grads, self._acc = self._acc, None
        for label, group in self._groups.items():
            group.update([g for (n, _), g in zip(self._trainable, grads)
                          if self.labels[n] == label])

    # ------------------------------------------------------------ step ----
    def loss(self, model, batch: Dict[str, Any], generator: Optional[torch.Generator],
             curiosity_on: bool, kl_w: float):
        """(total loss, logs): the JAX trainer's loss on ``model``'s training
        forward. batch holds device tensors (``device_batch``)."""
        cfg = self.cfg
        guidance = batch.get("guidance")
        if guidance is None and cfg.guided_training:
            B = batch["images"].shape[0]
            g = fold_in(generator, 1 << 20) if generator is not None else \
                torch.Generator(self.device).manual_seed(
                    int(np.random.SeedSequence([cfg.seed, self._global_step])
                        .generate_state(1, np.uint64)[0]) >> 1)
            guidance = torch.randint(0, len(G.INSTRUCTIONS), (B,), generator=g,
                                     device=self.device)
        out = model(batch["images"], batch.get("exif"), guidance=guidance,
                    generator=generator, train=True, curiosity_kl_weight=kl_w)
        pred = out.depth[:, 0]
        target = scalar_depth_target(batch["depths"])
        depth_loss = LS.scale_invariant_loss(pred, target, cfg.loss_lambda)
        cur_loss = LS.curiosity_loss(out.curiosity, (pred - target).abs())
        if not curiosity_on:
            cur_loss = torch.zeros_like(cur_loss)
        total = depth_loss + cfg.curiosity_weight * cur_loss
        if cfg.attention_entropy_weight > 0 and "attention_entropy" in out.aux:
            total = total + cfg.attention_entropy_weight * out.aux["attention_entropy"]
        return total, {"loss": total, "depth_loss": depth_loss, "curiosity_loss": cur_loss}

    def step_inputs(self):
        """(curiosity_on, KL weight) of the current epoch."""
        c = self.cfg
        curiosity_on = bool(self.epoch >= c.curiosity_warmup_epochs
                            and self.model.arch.use_curiosity)
        kl_w = float(np.float32(beta_schedule(c.beta_schedule, c.beta_start, c.beta_end,
                                              c.epochs)(self.epoch)))
        return curiosity_on, kl_w

    def train_step(self, batch: Dict[str, Any], generator: Optional[torch.Generator] = None,
                   fetch_logs: bool = True, alt: Optional[bool] = None) -> Dict:
        """One micro-step: gradients of the loss, and an optimizer update
        every ``accumulation_steps``-th call. ``fetch_logs=False`` keeps the
        loss scalars on the device (no host sync). ``alt`` picks the model of
        this step: None runs ``alt_model`` on every odd step, True runs it,
        False the main model (a loop with its own schedule, such as one
        filtered step in N, passes it)."""
        batch = self.device_batch(batch)
        model = self.model
        if alt is None:
            alt = self.alt_model is not None and self._global_step % 2 == 1
        if alt and self.alt_model is None:
            raise ValueError("train_step(alt=True) needs an alt_model")
        if alt:
            model = self.alt_model
        total, logs = self.loss(model, batch, generator, *self.step_inputs())
        got = torch.autograd.grad(total, [p for _, p in self._trainable], allow_unused=True)
        self._apply([torch.zeros_like(p) if g is None else g
                     for (_, p), g in zip(self._trainable, got)])
        self._global_step += 1
        logs = {k: v.detach() for k, v in logs.items()}
        if fetch_logs:
            return {k: float(v) for k, v in logs.items()}
        return logs

    def device_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        dev = self.device

        def t(v, dtype=None):
            return torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                                   dtype=dtype).to(dev)

        out = {"images": t(batch["images"], torch.float32),
               "depths": t(batch["depths"], torch.float32)}
        if "guidance" in batch:
            out["guidance"] = t(batch["guidance"], torch.long)
        if "exif" in batch:
            out["exif"] = {k: t(v) for k, v in batch["exif"].items()}
        return out

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
    def eval_forward(self, images: torch.Tensor, exif=None):
        """The validation forward: no dropout, the noise of
        ``cfg.eval_noise_mode`` from a generator seeded 0."""
        return self.model(images, exif, generator=torch.Generator(self.device).manual_seed(0),
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
    def save_checkpoint_orbax(self, path: str):
        raise NotImplementedError("orbax checkpoints are not ported (sharding-aware)")

    def load_checkpoint_orbax(self, path: str):
        raise NotImplementedError("orbax checkpoints are not ported (sharding-aware)")

    def save_checkpoint(self, is_best: bool, filename: str = "checkpoint.npz"):
        """latest + best copy + per-epoch file, the JAX trainer's npz."""
        path = os.path.join(self.output_dir, filename)
        state = {
            **{f"params/{k}": v for k, v in flat_params(self.model).items()},
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
            merged, loaded, skipped = ct.filter_and_merge(flat_params(self.model), incoming)
            load_flat_params(self.model, merged)
            self._reset_optimizer()
            print(f"Resumed model params from torch ckpt {path}: "
                  f"{loaded} tensors ({skipped} skipped); optimizer reset")
            return
        with np.load(path) as data:
            flat = {k[len("params/"):]: data[k] for k in data.files if k.startswith("params/")}
            epoch = int(data["meta/epoch"])
            best = float(data["meta/best_val_loss"])
        load_flat_params(self.model, flat)
        self._reset_optimizer()
        self.epoch = epoch + 1
        self.best_val_loss = best
