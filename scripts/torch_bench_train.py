"""Training-step throughput of the PyTorch + CUDA port (counterpart of
scripts/bench_train.py): the trainer's compiled micro-step, one CUDA graph
replay a step, beside the same step run eagerly.

    TB_B=32 TB_S=224 TB_FROZEN=1 TB_FILTER= python scripts/torch_bench_train.py
        [--steps 20] [--device-steps 30] [--device auto|cpu]

The model and knobs are the JAX script's: ``num_iterations=3``, image size
``TB_S``, batch ``TB_B``, ``TB_FROZEN=1`` freezes the backbone and trains
rank-16 adapters on ``attn_out`` (else everything trains), ``TB_FILTER`` a
token-filter spec active in training (``2:0.25``, ``1:0.5,3:0.35,5:0.25``);
the default policy, ``attn_impl="pallas_packed"``, weights from a seeded
``torch.Generator``; one numpy batch of the JAX script's schema and seed.
``CAIM_TRAIN_REMAT`` (default 1) is read when each micro-step kind is
captured.

Prints the card's name and power limit, then two lines, each with the eager
step's time beside it:

  * ``train step B=.. S=.. frozen=..: X ms/step (Y img/s) loss=..``: ``--steps``
    chained steps from the host batch (its copy to the card inside each
    step), a generator each, by the host clock to a fetch of a parameter;
  * ``device-only train step: X ms/step (Y img/s)``: ``--device-steps``
    steps on a batch staged on the card beforehand.

The first steps of each kind run eagerly and capture; they are not timed.
With ``--device cpu`` (the tests) both runs are the eager step on the CPU.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device-steps", type=int, default=30)
    ap.add_argument("--device", type=str, default="auto",
                    help="auto (the CUDA device; raises without one) or cpu")
    return ap.parse_args(argv)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def main(argv=None, vit_cfg=None, env=None):
    """Run the benchmark; returns its numbers. ``vit_cfg`` overrides the
    backbone size (the tests' tiny width); ``env`` the knobs' source
    (default ``os.environ``)."""
    args = parse_args(argv)
    env = os.environ if env is None else env
    import torch

    from cognitive_aim_tpu_torch.core.device import resolve_device
    from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel
    from cognitive_aim_tpu_torch.models.config import ModelArchConfig, parse_token_filter
    from cognitive_aim_tpu_torch.train.trainer import TrainConfig, Trainer

    dev = resolve_device(None if args.device == "auto" else args.device)
    B, S = int(env.get("TB_B", 32)), int(env.get("TB_S", 224))
    frozen = env.get("TB_FROZEN", "1") == "1"
    spec = env.get("TB_FILTER", "")
    card = card_line() if dev.type == "cuda" else "cpu"
    print(card, flush=True)
    arch = ModelArchConfig(num_iterations=3, image_size=S, freeze_backbone=frozen,
                           use_lora=frozen, **parse_token_filter(spec))
    model = CognitiveAimModel(arch, attn_impl="pallas_packed", vit_cfg=vit_cfg, device=dev)
    model.init(torch.Generator(dev).manual_seed(0))
    cfg = TrainConfig(epochs=1, batch_size=B, steps_per_epoch=100, freeze_backbone=frozen)
    tr = Trainer(model, cfg, output_dir=os.path.join(ROOT, "build", "bench_train"))
    rng = np.random.RandomState(0)
    batch = {
        "images": rng.randn(B, S, S, 3).astype(np.float32) * 0.5,
        "depths": np.abs(rng.randn(B).astype(np.float32)) + 0.5,
        "exif": {"camera_idx": np.zeros(B, np.int32),
                 "focal_length": np.full(B, 0.25, np.float32),
                 "aperture": np.full(B, 0.127, np.float32),
                 "iso": np.full(B, 0.016, np.float32)},
    }
    staged = tr.device_batch(batch)
    k = max(1, cfg.accumulation_steps)
    leaf = next(p for p in model.parameters() if p.requires_grad)

    def chain(b, n, eager):
        """n chained steps, a generator each, to a fetch of a parameter:
        (seconds, the last loss)."""
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for i in range(n):
            logs = tr.train_step(b, torch.Generator(dev).manual_seed(i), fetch_logs=False,
                                 eager=eager)
        float(leaf.detach().reshape(-1)[0])
        return time.perf_counter() - t0, float(logs["loss"])

    out = {"card": card, "device": dev.type, "batch": B, "size": S, "frozen": frozen,
           "token_filter": spec, "remat": env.get("CAIM_TRAIN_REMAT", "1")}
    for eager in (False, True):
        chain(batch, k + 1, eager)  # every kind run once (captured on the card)
        tag = "eager" if eager else "step"
        dt, loss = chain(batch, args.steps, eager)
        dt2, _ = chain(staged, args.device_steps, eager)
        out[f"{tag}_ms"], out[f"{tag}_img_s"] = dt / args.steps * 1e3, B * args.steps / dt
        out[f"device_only_{tag}_ms"] = dt2 / args.device_steps * 1e3
        out[f"device_only_{tag}_img_s"] = B * args.device_steps / dt2
        out[f"{tag}_loss"] = loss
    if tr.graphs is not None:
        held = tr.graphs.describe()
        out["graphs"] = held["graphs"]
        out["pool_mib"] = held["pool_bytes"] / 2 ** 20
        out["capture_s"] = [e["capture_s"] for e in held["each"]]
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"train step B={B} S={S} frozen={frozen}: {out['step_ms']:.1f} ms/step "
          f"({out['step_img_s']:.0f} img/s) loss={out['step_loss']:.4f}; eager "
          f"{out['eager_ms']:.1f} ms/step ({out['eager_img_s']:.0f} img/s) ({card})", flush=True)
    print(f"device-only train step: {out['device_only_step_ms']:.1f} ms/step "
          f"({out['device_only_step_img_s']:.0f} img/s); eager "
          f"{out['device_only_eager_ms']:.1f} ms/step ({out['device_only_eager_img_s']:.0f} "
          f"img/s) ({card})", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
