"""The port's training path against the JAX trainer, on tests/test_train.py's
tiny configuration (2 layers, D 64, image 28, ``STRICT_F32``).

Weights come from the JAX package's init, carried across with
``convert.load_flat_params``; batches from a numpy seed. Dropout is off and
every noise draw is 0 on both sides: the JAX loss and trainer get no key
(``rng=None``), the port's no generator. JAX runs its XLA path on the CPU;
the port's kernel wrappers get CPU tensors and run their plain versions,
with the recompute backward of kernels/_grad.py.

Tolerances, with their reasons:
  * loss and per-parameter gradients: atol 1e-5 (float32 on both sides;
    they differ by summation order, ~3e-8 here);
  * parameters after a trainer step: Adam's first step is g / (|g| + 1e-8),
    a sign where |g| is large and a magnifier of rounding where |g| is near
    1e-8. Gradients that are analytically zero (a key bias under softmax's
    shift invariance) are rounding noise on both sides, and there the two
    steps may differ by up to a step's length. So: elements whose JAX
    gradient exceeds 1e-5 agree to atol 1e-6 / rtol 1e-5, every element to
    within two steps' reach (2 lr (1 + wd |p|) per step).
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from cognitive_aim_tpu.api import flatten_tree
from cognitive_aim_tpu.core.precision import STRICT_F32 as J_F32
from cognitive_aim_tpu.core.rng import NoiseMode as JNoise
from cognitive_aim_tpu.models import curiosity as JC
from cognitive_aim_tpu.models.cognitive_aim import CognitiveAimModel as JModel
from cognitive_aim_tpu.models.config import ModelArchConfig
from cognitive_aim_tpu.nn.dinov2 import DinoV2Config as JVit
from cognitive_aim_tpu.train import losses as JLS
from cognitive_aim_tpu.train import schedules as JSch
from cognitive_aim_tpu.train.metrics import calculate_depth_metrics as j_metrics
from cognitive_aim_tpu.train.trainer import TrainConfig as JTrainConfig
from cognitive_aim_tpu.train.trainer import Trainer as JTrainer
from cognitive_aim_tpu.train.trainer import scalar_depth_target as j_target
from cognitive_aim_tpu_torch.convert import flat_params, load_flat_params
from cognitive_aim_tpu_torch.core import precision as TP
from cognitive_aim_tpu_torch.core.rng import NoiseMode
from cognitive_aim_tpu_torch.kernels import flash_attention as TFA
from cognitive_aim_tpu_torch.kernels import focal_attention as TFO
from cognitive_aim_tpu_torch.models import config as TCfg
from cognitive_aim_tpu_torch.models import curiosity as TC
from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel as TModel
from cognitive_aim_tpu_torch.nn import layers as TL
from cognitive_aim_tpu_torch.nn.dinov2 import DinoV2Config as TVit
from cognitive_aim_tpu_torch.train import losses as TLS
from cognitive_aim_tpu_torch.train import schedules as TSch
from cognitive_aim_tpu_torch.train.metrics import calculate_depth_metrics as t_metrics
from cognitive_aim_tpu_torch.train.trainer import TrainConfig, Trainer, lr_schedule

torch.backends.cuda.matmul.allow_tf32 = False

VIT = dict(hidden_size=64, num_layers=2, num_heads=4, patch_size=14, pretrain_image_size=28)
ARCH = dict(num_iterations=2, focus_strength=0.1, num_cameras=4, image_size=28,
            freeze_backbone=False)
FILTER = dict(token_filter_layer=1, token_filter_keep=0.5, token_filter_train=True)
LORA = dict(use_lora=True, lora_rank=4, lora_targets=("attn_out", "fc1"))
BASE = dict(learning_rate=3e-3, epochs=1, batch_size=8, steps_per_epoch=30,
            freeze_backbone=False, weight_decay=0.015, attention_entropy_weight=0.01,
            beta_schedule="cosine", beta_start=0.05, beta_end=1.5)
GRAD_TOL = dict(atol=1e-5, rtol=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: torch's default thread pool next to XLA's costs more
    than it gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_init(arch_items):
    arch = ModelArchConfig(**dict(arch_items))
    jm = JModel(arch, policy=J_F32, vit_cfg=JVit(**VIT))
    params = jm.init(jax.random.PRNGKey(0))
    return jm, params, flatten_tree(params)


def tiny_pair(policy=TP.STRICT_F32, **arch_kw):
    """(JAX model, its params, port model loaded with the same weights)."""
    items = tuple(sorted({**ARCH, **arch_kw}.items()))
    jm, params, flat = _jax_init(items)
    tm = TModel(TCfg.ModelArchConfig(**dict(items)), policy=policy, vit_cfg=TVit(**VIT),
                device="cpu", attn_impl="pallas_packed")
    load_flat_params(tm, flat)
    return jm, jax.tree.map(jnp.array, params), tm


def synth_batch(B=8, size=28, seed=0, guidance=False):
    rng = np.random.RandomState(seed)
    b = {
        "images": rng.randn(B, size, size, 3).astype(np.float32) * 0.5,
        "depths": np.abs(rng.randn(B).astype(np.float32)) + 0.5,
        "exif": {"camera_idx": np.zeros(B, np.int32),
                 "focal_length": np.full(B, 0.25, np.float32),
                 "aperture": np.full(B, 0.127, np.float32),
                 "iso": np.full(B, 0.016, np.float32)},
    }
    if guidance:
        b["guidance"] = np.arange(B, dtype=np.int32) % 9
    return b


def _jax_loss_and_grads(jm, params, batch, cfg, kl_w):
    """The JAX trainer's loss formula (trainer.py loss_fn) on
    ``model.apply(train=True)`` with no key, and its gradients."""
    images = jnp.asarray(batch["images"])
    exif = {k: jnp.asarray(v) for k, v in batch["exif"].items()}
    guidance = jnp.asarray(batch["guidance"]) if "guidance" in batch else None

    def loss(p):
        out = jm.apply(p, images, exif, guidance=guidance, rng=None, train=True,
                       curiosity_kl_weight=jnp.float32(kl_w))
        pred = out.depth[:, 0]
        target = j_target(jnp.asarray(batch["depths"]))
        total = JLS.scale_invariant_loss(pred, target, cfg.loss_lambda)
        total = total + cfg.curiosity_weight * JLS.curiosity_loss(
            out.curiosity, jnp.abs(pred - target))
        if cfg.attention_entropy_weight > 0:
            total = total + cfg.attention_entropy_weight * out.aux["attention_entropy"]
        return total

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(value), flatten_tree(grads)


def _torch_grads_flat(tm, grads):
    """Gradients keyed as the flat interchange (None -> zeros)."""
    twin = TModel(tm.arch, policy=tm.policy, vit_cfg=tm.vit_cfg, device="cpu")
    with torch.no_grad():
        for (n, p), g in zip(twin.named_parameters(), grads):
            p.copy_(torch.zeros_like(p) if g is None else g)
    return flat_params(twin)


@pytest.mark.parametrize("variant", ["unfiltered", "filter_drop", "filter_prop_attn"])
def test_loss_and_gradients_match_jax(variant, tmp_path):
    arch_kw = {"unfiltered": {}, "filter_drop": FILTER,
               "filter_prop_attn": dict(FILTER, token_filter_prop_attn=True)}[variant]
    jm, params, tm = tiny_pair(**arch_kw)
    cfg = TrainConfig(**BASE)
    batch = synth_batch(guidance=True)
    want_loss, want = _jax_loss_and_grads(jm, params, batch, JTrainConfig(**BASE), 0.05)
    tr = Trainer(tm, cfg, output_dir=str(tmp_path))
    total, logs = tr.loss(tm, tr.device_batch(batch), None, True, 0.05)
    got = torch.autograd.grad(total, list(tm.parameters()), allow_unused=True)
    np.testing.assert_allclose(float(total.detach()), want_loss, **GRAD_TOL)
    flat = _torch_grads_flat(tm, got)
    assert set(flat) == set(want)
    for k in want:
        np.testing.assert_allclose(flat[k], np.asarray(want[k]), err_msg=k, **GRAD_TOL)
    if variant == "filter_prop_attn":  # the filtered blocks went through K7's backward
        assert np.abs(want["backbone/layers/k/w"][1]).max() > 0


def _assert_step_equal(jflat, tflat, jgrad, reach):
    for k in jflat:
        a, b = np.asarray(jflat[k]), tflat[k]
        well = np.abs(np.asarray(jgrad[k])) > 1e-5
        np.testing.assert_allclose(b[well], a[well], atol=1e-6, rtol=1e-5, err_msg=k)
        bound = reach * (1.0 + BASE["weight_decay"] * np.abs(a))
        assert (np.abs(b - a) <= bound).all(), (k, np.abs(b - a).max())


STEP_CASES = {
    # name: (TrainConfig overrides, arch overrides, steps)
    "cosine": (dict(scheduler="cosine"), {}, 1),
    # warm-up of one update: lr 0 at update 0, then the cosine's peak
    "warmup_cosine": (dict(scheduler="warmup_cosine", warmup_epochs=1, steps_per_epoch=1,
                           epochs=3), {}, 2),
    "step": (dict(scheduler="step", steps_per_epoch=1), {}, 1),
    # MultiSteps: nothing moves at the first micro-step, the mean moves at the second
    "accumulation_steps_2": (dict(accumulation_steps=2), {}, 2),
    "freeze_backbone": (dict(freeze_backbone=True), LORA, 1),
    "train_only_lora": (dict(train_only_lora=True), LORA, 1),
    "sandwich_heads_lr": (dict(train_only_lora=True, sandwich_heads=True, heads_lr=1e-3),
                          LORA, 1),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_jax_trainer(case, tmp_path):
    over, arch_kw, steps = STEP_CASES[case]
    kw = dict(BASE, **over)
    jm, params, tm = tiny_pair(**arch_kw)
    batch = synth_batch()
    _, jgrad = _jax_loss_and_grads(jm, params, batch, JTrainConfig(**kw), 0.05)
    jt = JTrainer(jm, params, JTrainConfig(**kw), output_dir=str(tmp_path / "j"))
    tt = Trainer(tm, TrainConfig(**kw), output_dir=str(tmp_path / "t"))
    before = flat_params(tm)
    for i in range(steps):
        lj = jt.train_step(batch, None)
        lt = tt.train_step(batch, None)
        np.testing.assert_allclose(lt["loss"], lj["loss"], **GRAD_TOL)
        if case == "accumulation_steps_2" and i == 0:
            for k, v in flat_params(tm).items():
                np.testing.assert_array_equal(v, before[k])
    reach = 2.0 * steps * max(kw["learning_rate"], kw.get("heads_lr", 0.0))
    after = flat_params(tm)
    _assert_step_equal(flatten_tree(jt.params), after, jgrad, reach)
    moved = {k for k in after if np.abs(after[k] - before[k]).max() > 0}
    if case in ("freeze_backbone", "train_only_lora", "sandwich_heads_lr"):
        assert "backbone/layers/lora_B" in moved
        assert not any(k.startswith("backbone/") and "lora" not in k for k in moved)
    if case == "freeze_backbone":
        # the JAX labels train only parts named exactly lora_A / lora_B: an
        # adapter on another target is frozen, in both packages
        assert "backbone/layers/lora_fc1_B" not in moved
        assert "fusion/fc0/w" in moved
    if case == "train_only_lora":
        assert "backbone/layers/lora_fc1_B" in moved and "fusion/fc0/w" not in moved
    if case == "sandwich_heads_lr":
        assert "fusion/fc0/w" in moved


def test_remat_launches_each_attention_twice_and_keeps_gradients(monkeypatch, tmp_path):
    """Per-block recompute runs K1's forward again in the backward (2 calls a
    block a step, one without it); K6 is outside the recompute. The
    gradients do not change."""
    calls = {"k1": 0, "k6": 0}
    k1, k6 = TFA._k1_op, TFO._k6_op

    def count(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(TFA, "_k1_op", count("k1", k1))
    monkeypatch.setattr(TFO, "_k6_op", count("k6", k6))
    grads = {}
    for remat in ("1", "0"):
        monkeypatch.setenv("CAIM_TRAIN_REMAT", remat)
        _, _, tm = tiny_pair()
        tr = Trainer(tm, TrainConfig(**BASE), output_dir=str(tmp_path))
        calls.update(k1=0, k6=0)
        total, _ = tr.loss(tm, tr.device_batch(synth_batch()), None, True, 0.05)
        grads[remat] = torch.autograd.grad(total, list(tm.parameters()), allow_unused=True)
        n_layers = VIT["num_layers"]
        assert calls == {"k1": n_layers * (2 if remat == "1" else 1), "k6": 2}, (remat, calls)
    for a, b in zip(grads["1"], grads["0"]):
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def test_master_weights_stay_float32_under_the_bf16_policy(tmp_path):
    """The trainer never casts in place: the default policy's bf16 forward
    reads float32 parameters, cast at each call."""
    _, _, tm = tiny_pair(policy=TP.DEFAULT_POLICY)
    tr = Trainer(tm, TrainConfig(**BASE), output_dir=str(tmp_path))
    logs = tr.train_step(synth_batch(), torch.Generator().manual_seed(0))
    assert np.isfinite(logs["loss"])
    assert all(p.dtype == torch.float32 for p in tm.parameters())


def test_int8_policy_does_not_train():
    """The int8 kernels have no backward, in either package."""
    _, _, tm = tiny_pair(policy=TP.INT8_BACKBONE)
    tm.vit_cfg = dataclasses.replace(tm.vit_cfg, gelu_approx=True)
    for blk in tm.backbone.layers:
        blk.cfg = tm.vit_cfg
    tm.prepare_params()
    with pytest.raises(RuntimeError, match="no backward"):
        tm(torch.zeros(2, 28, 28, 3), train=True)
    with torch.no_grad():
        assert torch.isfinite(tm(torch.zeros(2, 28, 28, 3)).depth).all()


# ---------------------------------------------- tests/test_train.py, restated ---
@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    _, _, tm = tiny_pair()
    cfg = TrainConfig(learning_rate=3e-3, epochs=1, batch_size=8, steps_per_epoch=30,
                      freeze_backbone=False, weight_decay=0.0)
    trainer = Trainer(tm, cfg, output_dir=str(tmp_path_factory.mktemp("trained")))
    batch = synth_batch()
    losses = [trainer.train_step(batch, torch.Generator().manual_seed(i))["loss"]
              for i in range(25)]
    return trainer, losses


def test_loss_decreases(trained):
    _, losses = trained
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.8, losses[:3] + losses[-3:]


def test_checkpoint_roundtrip(trained, tmp_path):
    trainer, _ = trained
    trainer.save_checkpoint(is_best=True)
    _, _, tm = tiny_pair()
    t2 = Trainer(tm, TrainConfig(epochs=1, steps_per_epoch=30, freeze_backbone=False),
                 output_dir=str(tmp_path))
    t2.load_checkpoint(os.path.join(trainer.output_dir, "model_best.npz"))
    a, b = flat_params(trainer.model), flat_params(t2.model)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert t2.epoch == trainer.epoch + 1
    for f in ("checkpoint.npz", "checkpoint_epoch_0.npz"):
        assert os.path.exists(os.path.join(trainer.output_dir, f))


def test_frozen_backbone_keeps_backbone_params(tmp_path):
    _, _, tm = tiny_pair()
    cfg = TrainConfig(learning_rate=1e-2, epochs=1, steps_per_epoch=5, freeze_backbone=True,
                      weight_decay=0.0)
    trainer = Trainer(tm, cfg, output_dir=str(tmp_path))
    before = tm.backbone.layers[0].qkv.weight.detach().clone()
    before_head = tm.fusion.fc0.weight.detach().clone()
    trainer.train_step(synth_batch(), torch.Generator().manual_seed(0))
    torch.testing.assert_close(tm.backbone.layers[0].qkv.weight.detach(), before,
                               rtol=0, atol=0)
    assert (tm.fusion.fc0.weight.detach() - before_head).abs().max() > 0


def test_explicit_batch_guidance_wins_over_sampling(tmp_path):
    """An explicit batch['guidance'] drives the forward and skips
    guided_training's sampling: with the same generator, a guided_training
    step and a plain step given the same vector give one loss."""
    kw = dict(learning_rate=3e-3, epochs=1, batch_size=8, steps_per_epoch=5,
              freeze_backbone=False, weight_decay=0.0, curiosity_weight=0.0,
              curiosity_warmup_epochs=10)
    batch = synth_batch(guidance=True)

    def loss_of(cfg_kw, b, name):
        _, _, tm = tiny_pair()
        tr = Trainer(tm, TrainConfig(**kw, **cfg_kw), output_dir=str(tmp_path / name))
        return tr.train_step(b, torch.Generator().manual_seed(0))["loss"]

    la = loss_of(dict(guided_training=True), batch, "a")
    lb = loss_of(dict(guided_training=False), batch, "b")
    assert np.isfinite(la) and np.isfinite(lb)
    np.testing.assert_allclose(la, lb, rtol=1e-6)
    b2 = dict(batch, guidance=(np.arange(8, dtype=np.int32) + 4) % 9)
    assert abs(loss_of(dict(guided_training=True), b2, "c") - la) > 1e-9
    nb = {k: v for k, v in batch.items() if k != "guidance"}
    assert abs(loss_of(dict(guided_training=True), nb, "d") - la) > 1e-9


def test_alternating_filter_training_step(tmp_path):
    """alt_model: the filtered and the exact variant train on alternating
    steps, on the main model's parameters."""
    _, _, f_model = tiny_pair(**FILTER)
    _, _, e_model = tiny_pair()
    seen = []
    e_model.register_forward_hook(lambda *a: seen.append("alt"))
    f_model.register_forward_hook(lambda *a: seen.append("main"))
    cfg = TrainConfig(learning_rate=3e-3, epochs=1, batch_size=8, steps_per_epoch=6,
                      freeze_backbone=False, weight_decay=0.0, guided_training=True)
    trainer = Trainer(f_model, cfg, output_dir=str(tmp_path), alt_model=e_model)
    before = f_model.fusion.fc0.weight.detach().clone()
    losses = [trainer.train_step(synth_batch(), torch.Generator().manual_seed(i))["loss"]
              for i in range(4)]
    assert all(np.isfinite(l) for l in losses), losses
    assert seen == ["main", "alt", "main", "alt"]
    assert (f_model.fusion.fc0.weight.detach() - before).abs().max() > 0


def test_from_raw_rich_logging_and_noise():
    raw = {"logging": {"curiosity": {"log_curiosity_stats": True}, "num_save_images": 3},
           "validation": {"noise_mode": "zeros"}}
    cfg = TrainConfig.from_raw(raw)
    assert cfg.rich_logging and cfg.num_save_images == 3
    assert cfg.eval_noise_mode == "zeros"
    cfg2 = TrainConfig.from_raw({})
    assert not cfg2.rich_logging and cfg2.eval_noise_mode == "sample"
    assert not cfg2.guided_training
    assert TrainConfig.from_raw({"training": {"guided_training": True}}).guided_training
    with open("configs/experiment_B.yaml") as f:
        exp = yaml.safe_load(f)
    assert (dataclasses.asdict(TrainConfig.from_raw(exp, 7))
            == dataclasses.asdict(JTrainConfig.from_raw(exp, 7)))


def test_rich_logging_surface(tmp_path):
    class FakeWriter:
        def __init__(self):
            self.scalars, self.images = {}, {}

        def add_scalar(self, tag, value, step):
            self.scalars[tag] = value

        def add_image(self, tag, img, step):
            self.images[tag] = img

    _, _, tm = tiny_pair()
    cfg = TrainConfig(epochs=1, batch_size=8, steps_per_epoch=2, freeze_backbone=False,
                      rich_logging=True, num_save_images=2, eval_noise_mode="zeros")
    writer = FakeWriter()
    trainer = Trainer(tm, cfg, output_dir=str(tmp_path), writer=writer)
    loader = [synth_batch(B=8)]
    hist = trainer.fit(loader, loader, epochs=1)
    assert np.isfinite(hist[0]["loss"]) and np.isfinite(hist[0]["val_loss"])
    assert "Val/curiosity_mean" in writer.scalars and "Val/AttentionHeatmap/1" in writer.images
    img = writer.images["Val/AttentionHeatmap/0"]
    assert img.ndim == 3 and img.shape[0] == 1 and 0.0 <= img.min() <= img.max() <= 1.0
    assert writer.scalars["Exploration/samples"] >= 8


def test_unported_options_raise(tmp_path):
    """The parallel options are ported (tests/test_torch_parallel.py); what
    still raises is what raises in the JAX trainer: pipelining with tensor
    parallelism, and a pipeline whose stages do not divide the world. At
    world 1 tensor_parallel trains what the trainer without it trains, and
    the DCP pair (the orbax names) round-trips the parameters."""
    _, _, tm = tiny_pair()
    with pytest.raises(ValueError, match="mutually exclusive"):
        Trainer(tm, TrainConfig(pipeline_stages=2, tensor_parallel=True),
                output_dir=str(tmp_path))
    with pytest.raises(ValueError, match="does not divide"):
        Trainer(tm, TrainConfig(pipeline_stages=2), output_dir=str(tmp_path))
    batch = synth_batch()
    steps = []
    for tp in (False, True):
        _, _, tm = tiny_pair()
        tr = Trainer(tm, TrainConfig(**BASE, tensor_parallel=tp), output_dir=str(tmp_path))
        steps.append((tr.train_step(batch, None)["loss"], flat_params(tm)))
    assert steps[0][0] == steps[1][0]
    for k, v in steps[0][1].items():
        np.testing.assert_array_equal(steps[1][1][k], v)
    tr.save_checkpoint_orbax(str(tmp_path / "o"))
    _, _, fresh = tiny_pair()
    with torch.no_grad():  # other weights than the saved ones
        for p in fresh.parameters():
            p.add_(1.0)
    back = Trainer(fresh, TrainConfig(**BASE), output_dir=str(tmp_path))
    back.load_checkpoint_orbax(str(tmp_path / "o"))
    for k, v in flat_params(fresh).items():
        np.testing.assert_array_equal(v, steps[1][1][k], err_msg=k)


# ------------------------------------------------------------- cross-load ---
def test_checkpoints_cross_load_between_trainers(tmp_path):
    """A port checkpoint restores in the JAX trainer, a JAX one in the port's,
    with equal leaves, epoch and best loss."""
    jm, params, tm = tiny_pair(**LORA, **FILTER)
    tt = Trainer(tm, TrainConfig(**BASE), output_dir=str(tmp_path / "t"))
    tt.train_step(synth_batch(), torch.Generator().manual_seed(0))
    tt.epoch, tt.best_val_loss = 3, 0.25
    tt.save_checkpoint(is_best=True)
    with np.load(str(tmp_path / "t" / "model_best.npz")) as z:
        assert str(z["__meta__/train_filter"]) == "1:0.5"
        assert (str(z["__meta__/adapter_rank"]), str(z["__meta__/adapter_alpha"]),
                str(z["__meta__/adapter_targets"])) == ("4", "16", "attn_out,fc1")
    jt = JTrainer(jm, params, JTrainConfig(**BASE), output_dir=str(tmp_path / "j"))
    jt.load_checkpoint(str(tmp_path / "t" / "model_best.npz"))
    want = flat_params(tm)
    got = flatten_tree(jt.params)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)
    assert jt.epoch == 4 and jt.best_val_loss == 0.25

    jt.train_step(synth_batch(seed=1), jax.random.PRNGKey(0))
    jt.save_checkpoint(is_best=False, filename="from_jax.npz")
    _, _, tm2 = tiny_pair(**LORA, **FILTER)
    t2 = Trainer(tm2, TrainConfig(**BASE), output_dir=str(tmp_path / "t2"))
    t2.load_checkpoint(str(tmp_path / "j" / "from_jax.npz"))
    got2 = flat_params(tm2)
    for k, v in flatten_tree(jt.params).items():
        np.testing.assert_array_equal(got2[k], np.asarray(v), err_msg=k)
    assert t2.epoch == jt.epoch + 1


# ---------------------------------------------- losses, metrics, schedules ---
def test_losses_match_jax():
    rng = np.random.RandomState(0)
    pred, target = (np.abs(rng.randn(16)).astype(np.float32) + 0.1 for _ in range(2))
    t = torch.from_numpy
    np.testing.assert_allclose(float(TLS.scale_invariant_loss(t(pred), t(target), 0.5)),
                               float(JLS.scale_invariant_loss(pred, target, 0.5)), rtol=1e-6)
    np.testing.assert_allclose(float(TLS.huber_loss(t(pred), t(target), 0.5)),
                               float(JLS.huber_loss(pred, target, 0.5)), rtol=1e-6)
    err = rng.rand(4).astype(np.float32)
    for cur in (rng.rand(4, 6).astype(np.float32), rng.rand(4).astype(np.float32)):
        np.testing.assert_allclose(float(TLS.curiosity_loss(t(cur), t(err))),
                                   float(JLS.curiosity_loss(cur, err)), rtol=1e-6)
    grads = [rng.randn(3, 4).astype(np.float32) for _ in range(3)]
    tg, tn = TLS.global_norm_clip([t(g) for g in grads], 1.0)
    jg, jn = JLS.global_norm_clip([jnp.asarray(g) for g in grads], 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    # the curiosity target is detached, as jax.lax.stop_gradient leaves it
    e = t(err).requires_grad_(True)
    scores = t(rng.rand(4).astype(np.float32)).requires_grad_(True)
    TLS.curiosity_loss(scores, e).backward()
    assert e.grad is None and scores.grad is not None


def test_metrics_and_schedules_match_jax():
    rng = np.random.RandomState(1)
    pred = np.abs(rng.randn(100)) + 0.05
    target = np.abs(rng.randn(100)) + 0.05
    assert t_metrics(pred, target) == j_metrics(pred, target)
    for name in ("constant", "linear", "cosine"):
        for e in range(6):
            assert TSch.beta_schedule(name, 0.05, 1.5, 5)(e) == \
                JSch.beta_schedule(name, 0.05, 1.5, 5)(e)
    for over in (dict(scheduler="cosine"), dict(scheduler="warmup_cosine", warmup_epochs=2),
                 dict(scheduler="warmup_cosine", warmup_epochs=0), dict(scheduler="step"),
                 dict(scheduler="cosine", accumulation_steps=4)):
        kw = dict(learning_rate=2e-5, epochs=10, steps_per_epoch=7, **over)

        class Stub:  # JAX Trainer._schedule reads self.cfg only
            cfg = JTrainConfig(**kw)

        want = JTrainer._schedule(Stub())
        got = lr_schedule(TrainConfig(**kw))
        for count in (0, 1, 3, 6, 13, 17, 40, 69, 70, 400):
            np.testing.assert_allclose(got(count), float(want(count)), rtol=2e-6,
                                       atol=1e-12, err_msg=f"{over} {count}")


@pytest.mark.parametrize("loss_type", ["simple", "robust", "huber"])
def test_curiosity_loss_types_match_jax(loss_type):
    from cognitive_aim_tpu_torch.core.rng import NoiseMode as TN

    D = 64
    jp = JC.curiosity_init(jax.random.PRNGKey(3), D, 32, True)
    mod = TC.Curiosity(D, 32, True, device="cpu")
    load_flat_params(mod, flatten_tree(jp))
    feats = np.random.RandomState(2).randn(5, D).astype(np.float32)
    want, wunc, _ = JC.curiosity_apply(jp, jnp.asarray(feats), loss_type=loss_type,
                                       kl_weight=0.3, noise_mode=JNoise.ZEROS)
    with torch.no_grad():
        got, unc, _ = TC.curiosity_apply(mod, torch.from_numpy(feats), loss_type=loss_type,
                                         kl_weight=0.3, noise_mode=TN.ZEROS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=1e-5)
    np.testing.assert_allclose(unc.numpy(), np.asarray(wunc), atol=2e-6, rtol=1e-5)


def test_dropout_is_inverted_and_seeded():
    x = torch.ones(200, 500)
    a = TL.dropout(x, 0.1, torch.Generator().manual_seed(0))
    b = TL.dropout(x, 0.1, torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    kept = (a != 0).float().mean().item()
    assert abs(kept - 0.9) < 0.01
    torch.testing.assert_close(a[a != 0], torch.full_like(a[a != 0], 1 / 0.9))


# ------------------------------------------------------------------ dataset ---
@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("ds")
    (root / "images").mkdir()
    (root / "depths").mkdir()
    rng = np.random.RandomState(0)
    for i in range(4):
        Image.fromarray((rng.rand(60, 80, 3) * 255).astype(np.uint8)).save(
            root / "images" / f"im{i}.jpg")
        np.save(root / "depths" / f"im{i}_depth.npy", rng.rand(30, 40).astype(np.float32) * 4 + 1)
    return str(root)


def test_dataset_scan_and_item(data_dir):
    from cognitive_aim_tpu.io.dataset import DepthDataset as JDS
    from cognitive_aim_tpu_torch.io.dataset import DepthDataset

    ds = DepthDataset(data_dir, "train", (56, 56), use_exif=True, augment=False)
    assert len(ds) == 4
    s = ds[0]
    assert s["image"].shape == (56, 56, 3) and s["depth"].shape == (56, 56)
    assert 0.0 <= s["depth"].min() and abs(s["depth"].max() - 1.0) < 1e-5
    assert "exif" in s and "camera_idx" in s["exif"]
    w = JDS(data_dir, "train", (56, 56), use_exif=True, augment=False)[0]
    np.testing.assert_array_equal(s["image"], w["image"])
    np.testing.assert_array_equal(s["depth"], w["depth"])


def test_dataset_annotations_json(data_dir):
    from cognitive_aim_tpu_torch.io.dataset import DepthDataset

    anns = [{"image_path": os.path.join(data_dir, "images", "im0.jpg"), "image_id": 7}]
    with open(os.path.join(data_dir, "val_annotations.json"), "w") as f:
        json.dump(anns, f)
    ds = DepthDataset(data_dir, "val", (32, 32), use_exif=False)
    assert len(ds) == 1
    s = ds[0]
    assert s["image_id"] == 7 and np.all(s["depth"] == 0)


def test_loader_batching(data_dir):
    from cognitive_aim_tpu.io.dataset import DataLoader as JDL
    from cognitive_aim_tpu.io.dataset import DepthDataset as JDS
    from cognitive_aim_tpu_torch.io.dataset import DataLoader, DepthDataset

    ds = DepthDataset(data_dir, "train", (32, 32), use_exif=True, augment=True, seed=3)
    batches = list(DataLoader(ds, batch_size=3, shuffle=True, drop_last=True, seed=1))
    assert len(batches) == 1
    b = batches[0]
    assert b["images"].shape == (3, 32, 32, 3) and b["depths"].shape == (3, 32, 32)
    assert b["exif"]["camera_idx"].shape == (3,)
    # the same numpy seeds give the JAX loader's batch, augmentation included
    jb = list(JDL(JDS(data_dir, "train", (32, 32), use_exif=True, augment=True, seed=3),
                  batch_size=3, shuffle=True, drop_last=True, seed=1))[0]
    np.testing.assert_array_equal(b["images"], jb["images"])
    np.testing.assert_array_equal(b["image_ids"], jb["image_ids"])


def test_prefetch_loader(data_dir):
    from cognitive_aim_tpu_torch.io.dataset import DataLoader, DepthDataset, PrefetchLoader

    ds = DepthDataset(data_dir, "train", (32, 32), use_exif=False)
    base = DataLoader(ds, batch_size=2)
    pf = PrefetchLoader(base)
    assert len(pf) == len(base)
    assert sum(b["images"].shape[0] for b in pf) == len(ds)


# -------------------------------------------------------------- the CLI ---
def test_train_torch_cli_end_to_end_on_cpu(data_dir, tmp_path):
    """train_torch.py on experiment_B.yaml's model (ViT-B) at 28x28 on the
    CPU, in strict f32: two micro-steps make one update (accumulation 2),
    the checkpoints land, and a second run auto-resumes the next epoch."""
    import train_torch

    with open("configs/experiment_B.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["dataset"]["image_size"] = 28
    cfg["training"].update(batch_size=2, accumulation_steps=2)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    out = str(tmp_path / "out")
    args = ["--config", str(path), "--data_dir", data_dir, "--output_dir", out,
            "--policy", "f32", "--device", "cpu"]
    tr = train_torch.main(args + ["--epochs", "1"])
    assert tr.history[0]["epoch"] == 0 and np.isfinite(tr.history[0]["loss"])
    assert tr._groups["train"].count == 1
    for f in ("checkpoint.npz", "model_best.npz", "checkpoint_epoch_0.npz",
              "training_summary.md", "config.yaml"):
        assert os.path.exists(os.path.join(out, f)), f
    tr2 = train_torch.main(args + ["--epochs", "2"])
    assert [h["epoch"] for h in tr2.history] == [1]
    assert os.path.exists(os.path.join(out, "checkpoint_epoch_1.npz"))


def test_port_engine_serves_trainer_checkpoints(tmp_path):
    """The port's engine loads a checkpoint of either trainer (the
    ``params/`` layout) with every tensor, and answers as the trainer's own
    eval forward with noise 0."""
    from cognitive_aim_tpu_torch.api import CognitiveAimInference

    cfg = {"dataset": {"image_size": 28}, "exif_config": {"num_cameras": 4},
           "focal_config": {"num_iterations": 2, "focus_strength": 0.1}}
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    engine = CognitiveAimInference(path, None, device="cpu", policy="f32", save_images=False,
                                   noise_mode="zeros", vit_cfg=TVit(**VIT))
    arch = dataclasses.asdict(engine.arch)
    jm = JModel(ModelArchConfig(**arch), policy=J_F32, vit_cfg=JVit(**VIT))
    params = jm.init(jax.random.PRNGKey(1))
    tm = TModel(engine.arch, policy=TP.STRICT_F32, vit_cfg=TVit(**VIT), device="cpu")
    load_flat_params(tm, flatten_tree(params))
    tt = Trainer(tm, TrainConfig(**BASE, eval_noise_mode="zeros"), output_dir=str(tmp_path / "t"))
    tt.train_step(synth_batch(), None)
    tt.save_checkpoint(is_best=True)
    jt = JTrainer(jm, params, JTrainConfig(**BASE), output_dir=str(tmp_path / "j"))
    jt.save_checkpoint(is_best=False, filename="jax.npz")
    batch = tt.device_batch(synth_batch(seed=4))
    for ckpt, want in ((tmp_path / "t" / "model_best.npz", flat_params(tm)),
                       (tmp_path / "j" / "jax.npz", flatten_tree(jt.params))):
        engine.load_checkpoint(str(ckpt))
        assert set(engine.params) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(engine.params[k], np.asarray(v), err_msg=k)
    load_flat_params(tm, engine.params)
    got = engine._forward(batch["images"], batch["exif"])
    ref = tt.eval_forward(batch["images"], batch["exif"])
    torch.testing.assert_close(got.depth, ref.depth, rtol=0, atol=1e-6)


def test_precomputed_stream_and_curiosity_loss_match_jax():
    """``precomputed_hs`` replaces the backbone's output, and
    ``compute_curiosity_loss`` (exif on, the configs' loss types) is the JAX
    method's, on the same weights."""
    jm, params, tm = tiny_pair()
    b = synth_batch(B=4)
    x = torch.from_numpy(b["images"])
    exif = {k: torch.from_numpy(v) for k, v in b["exif"].items()}
    with torch.no_grad():
        hs = tm.backbone(x, **tm.backbone_kwargs(x)).float()
        full = tm(x, exif, noise_mode=NoiseMode.ZEROS)
        seam = tm(x, exif, noise_mode=NoiseMode.ZEROS, precomputed_hs=hs.numpy())
        torch.testing.assert_close(seam.depth, full.depth, rtol=0, atol=0)
        feats = hs[:, 0]
        for loss_type in ("robust", "huber"):
            got, _ = tm.compute_curiosity_loss(feats, exif, loss_type=loss_type,
                                               kl_weight=0.4, noise_mode=NoiseMode.ZEROS)
            want, _ = jm.compute_curiosity_loss(
                params, jnp.asarray(feats.numpy()),
                {k: jnp.asarray(v) for k, v in b["exif"].items()}, loss_type=loss_type,
                kl_weight=0.4, noise_mode=JNoise.ZEROS)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=1e-5)
