"""Evaluation / ablation-sweep CLI of the PyTorch + CUDA port (counterpart of
evaluate.py).

Runs the validation metric suite (rmse, mae, abs_rel, sq_rel, log10,
delta1/2/3, threshold_acc; a config's validation.metrics selects) over a
validation set, for one config or every config of a sweep directory, unguided
or under guidance instructions, through the port's engine
(cognitive_aim_tpu_torch.api) with noise 0. Reads the same dataset layout as
train_torch.py.

Usage:
  python evaluate_torch.py --config eval_configs/full_cognitive_config.yaml \\
      --data_dir dataset [--checkpoint ckpt.npz] [--device cpu]
  python evaluate_torch.py --sweep eval_configs/ --data_dir dataset
"""

import argparse
import json
import os
from pathlib import Path

import numpy as np
import yaml


def evaluate_config(config_path, data_dir, checkpoint, batch_size, lookup,
                    instructions=(None,), vit_cfg=None, device=None, policy="default"):
    """Metrics of one config under each instruction of ``instructions``
    (None: unguided), from one engine."""
    import torch

    from cognitive_aim_tpu_torch.api import CognitiveAimInference
    from cognitive_aim_tpu_torch.io.dataset import DataLoader, DepthDataset
    from cognitive_aim_tpu_torch.models import guidance as G
    from cognitive_aim_tpu_torch.train.metrics import calculate_depth_metrics

    engine = CognitiveAimInference(config_path, checkpoint, device=device or "auto",
                                   lookup=lookup, policy=policy, save_images=False,
                                   noise_mode="zeros", vit_cfg=vit_cfg)
    with open(config_path) as f:
        raw = yaml.safe_load(f)
    size = engine.image_size
    ds = DepthDataset(data_dir, "val", (size, size), use_exif=engine.arch.use_exif,
                      augment=False)
    if len(ds) == 0:
        return {i: {"error": f"no val data in {data_dir}", "n": 0} for i in instructions}
    wanted = raw.get("validation", {}).get("metrics")
    results = {}
    for instruction in instructions:
        preds, targets, confs = [], [], []
        for batch in DataLoader(ds, batch_size):
            images = torch.from_numpy(batch["images"]).to(engine.device)
            exif = None
            if "exif" in batch:
                exif = engine._to_device({k: np.asarray(v) for k, v in batch["exif"].items()})
            gidx = None
            if instruction is not None:
                gidx = torch.full((images.shape[0],), G.instruction_index(instruction),
                                  dtype=torch.long, device=engine.device)
            out = engine._forward(images, exif, gidx)
            preds.append(out.depth[:, 0].float().cpu().numpy())
            confs.append(out.confidence[:, 0].float().cpu().numpy())
            d = batch["depths"]
            targets.append(d.reshape(d.shape[0], -1).mean(axis=1) if d.ndim > 1 else d)
        metrics = calculate_depth_metrics(np.concatenate(preds), np.concatenate(targets))
        metrics["mean_confidence"] = float(np.concatenate(confs).mean())
        metrics["n"] = int(sum(p.size for p in preds))
        if wanted:
            metrics = {k: v for k, v in metrics.items()
                       if k in wanted or k in ("n", "mean_confidence")}
        results[instruction] = metrics
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=str)
    ap.add_argument("--sweep", type=str, help="directory of eval configs")
    ap.add_argument("--data_dir", type=str, required=True)
    ap.add_argument("--checkpoint", type=str, default=None)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--lookup", type=str, default="reference", choices=["reference", "nested"])
    ap.add_argument("--instruction", type=str, default=None,
                    help="evaluate under one guidance instruction, or 'all' for the "
                         "per-instruction sweep")
    ap.add_argument("--policy", type=str, default="default")
    ap.add_argument("--device", type=str, default=None,
                    help="'cpu' to evaluate on the CPU (default: the CUDA device)")
    ap.add_argument("--output", type=str, default="eval_results.json")
    args = ap.parse_args(argv)
    if not args.config and not args.sweep:
        raise SystemExit("need --config or --sweep")

    from cognitive_aim_tpu_torch.models.guidance import INSTRUCTIONS

    configs = (sorted(str(p) for p in Path(args.sweep).glob("*.yaml"))
               if args.sweep else [args.config])
    instructions = list(INSTRUCTIONS) if args.instruction == "all" else [args.instruction]
    results = {}
    for cfg in configs:
        name = os.path.basename(cfg)
        print(f"=== {name} ===")
        try:
            per_instr = evaluate_config(cfg, args.data_dir, args.checkpoint, args.batch_size,
                                        args.lookup, tuple(instructions), device=args.device,
                                        policy=args.policy)
        except Exception as e:
            per_instr = {i: {"error": f"{type(e).__name__}: {e}"} for i in instructions}
        for instr, m in per_instr.items():
            results[name if instr is None else f"{name}[{instr}]"] = m
            print(f"  -- {instr or 'unguided'}")
            for k, v in m.items():
                print(f"     {k}: {v}")
    with open(args.output, "w") as f:
        json.dump(results, f, indent=2)
    print(f"\nResults written to {args.output}")
    return results


if __name__ == "__main__":
    main()
