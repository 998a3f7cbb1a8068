"""Train the full model (backbone unfrozen) on synthetic structured scenes
with a deterministic depth law and save a flat float32 npz (counterpart of
scripts/train_synth_ckpt.py): trained weights for ``policy_delta
--checkpoint`` and the cells of ``delta_sweep``.

Depth laws, learnable from pixels alone: "center" d = 0.5 + 2 mean_luma(the
centre third) + 0.5 vertical gradient; "ring" puts the signal off-centre
(border ring and horizontal gradient), adversarial to a centre-biased token
selection.

    python -m cognitive_aim_tpu_torch.certify.synth_train --out build/certify/synth_ft.npz \\
        [--steps 400] [--batch 32] [--image-size 224] [--lr 1e-4] [--law center]
"""

import argparse
import os
import time

import numpy as np
import torch

from cognitive_aim_tpu_torch.certify.common import BUILD, arch, exif_numpy, save_flat
from cognitive_aim_tpu_torch.certify.policy_delta import synth_images
from cognitive_aim_tpu_torch.convert import flat_params
from cognitive_aim_tpu_torch.core.device import resolve_device
from cognitive_aim_tpu_torch.io.preprocess import normalize_np
from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel
from cognitive_aim_tpu_torch.train.trainer import TrainConfig, Trainer


def depth_law(imgs_01: np.ndarray) -> np.ndarray:
    """[N, S, S, 3] in [0,1] -> scalar depth per image (center-dominant)."""
    s = imgs_01.shape[1]
    lo, hi = s // 3, 2 * s // 3
    luma = imgs_01.mean(-1)
    center = luma[:, lo:hi, lo:hi].mean((1, 2))
    tilt = luma[:, hi:, :].mean((1, 2)) - luma[:, :lo, :].mean((1, 2))
    return (0.5 + 2.0 * center + 0.5 * tilt).astype(np.float32)


def depth_law_ring(imgs_01: np.ndarray) -> np.ndarray:
    """Depth signal lives OFF-center (border ring + horizontal gradient) —
    adversarial to any center-biased token selection, so the filter must
    keep peripheral tokens to fit it."""
    s = imgs_01.shape[1]
    lo, hi = s // 3, 2 * s // 3
    luma = imgs_01.mean(-1)
    total = luma.sum((1, 2))
    center = luma[:, lo:hi, lo:hi].sum((1, 2))
    ring = (total - center) / (s * s - (hi - lo) ** 2)
    hgrad = luma[:, :, hi:].mean((1, 2)) - luma[:, :, :lo].mean((1, 2))
    return (0.5 + 2.0 * ring + 0.5 * hgrad).astype(np.float32)


LAWS = {"center": depth_law, "ring": depth_law_ring}


def stage_batches(tr, norm, depths, batch, n_stage_max=12):
    """Up to ``n_stage_max`` batches staged on the trainer's device once."""
    n = norm.shape[0]
    staged = []
    for i in range(max(1, min(n // batch, n_stage_max))):
        sl = slice(i * batch, (i + 1) * batch)
        staged.append(tr.device_batch({"images": norm[sl], "depths": depths[sl],
                                       "exif": exif_numpy(batch)}))
    return staged


def check_step_inputs(tr):
    """The scripts' loops pass curiosity on and KL weight 0.1 to every step;
    the trainer's own epoch-0 inputs must be those values."""
    want = (True, float(np.float32(0.1)))
    if tr.step_inputs() != want:
        raise ValueError(f"trainer step inputs {tr.step_inputs()} != {want}: the "
                         f"certification recipe trains with curiosity on, KL weight 0.1")


def run_training(tr, staged, steps, log_every=50):
    """Train ``tr.model`` in place over the staged batches; returns the
    losses (host floats, one per step). With an ``alt_model`` the odd steps
    run it (the sandwich alternation), chosen here as the script chose its
    compiled step; the step's noise comes from a generator seeded by the
    step index."""
    check_step_inputs(tr)
    losses = []
    t0 = time.perf_counter()
    for step in range(steps):
        g = torch.Generator(tr.device).manual_seed(step)
        logs = tr.train_step(staged[step % len(staged)], g, fetch_logs=False,
                             alt=tr.alt_model is not None and step % 2 == 1)
        losses.append(logs["loss"])
        if step == 0 or step == steps - 1 or step % log_every == 0:
            print(f"step {step}: loss={float(logs['loss']):.4f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    losses = [float(v) for v in torch.stack(losses).cpu()]
    first, last = losses[0], losses[-1]
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'DECREASED' if last < first else 'did NOT decrease'})")
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=str, default=os.path.join(BUILD, "synth_ft.npz"))
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--n-images", type=int, default=512)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--law", type=str, default="center", choices=sorted(LAWS))
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    # the architecture policy_delta's engines resolve from their config, so
    # the checkpoint loads into them whole
    model = CognitiveAimModel(arch(args.image_size), attn_impl="pallas_packed", device=dev)
    model.init(torch.Generator(dev).manual_seed(args.seed))
    cfg = TrainConfig(epochs=1, batch_size=args.batch, steps_per_epoch=args.steps,
                      learning_rate=args.lr, freeze_backbone=False)
    tr = Trainer(model, cfg, output_dir=os.path.dirname(os.path.abspath(args.out)))

    imgs01 = synth_images(args.n_images, args.image_size, args.seed)
    depths = LAWS[args.law](imgs01)
    staged = stage_batches(tr, normalize_np(imgs01), depths, args.batch)
    run_training(tr, staged, args.steps)
    flat = flat_params(tr.model)
    save_flat(args.out, flat)
    print(f"wrote {args.out} ({len(flat)} tensors)")
    return flat


if __name__ == "__main__":
    main()
