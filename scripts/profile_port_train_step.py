#!/usr/bin/env python3
"""Where a training micro-step of the PyTorch + CUDA port spends the card's time.

    python3 scripts/profile_port_train_step.py [--config configs/experiment_B.yaml]
        [--batch N] [--remat 1|0]

Builds the config's model on the card (seeded weights, the default policy,
attn_impl="pallas_packed"), runs ``Trainer.train_step`` on a seeded device batch
(dropout on) through one accumulation cycle and one more step, which captures
the trainer's CUDA graph of each micro-step kind, then profiles, eager
(``train_step(eager=True)``) and replayed, one micro-step that makes no
optimizer update and one that does, under ``torch.profiler``: device time by
kernel (top 20), grouped (K1's and K6's forward kernels, the plain recompute of
their backward, GEMMs, everything else), the device's busy time against the
step's wall time (the idle share), and the host time of the call (the eager
step's enqueue; a replay's copies in, seeding, launch and copies out). A
replay runs no Python, so the recompute's ``recompute_vjp`` ranges show for
the eager step only. Prints the card's name and power limit and, last, one
JSON line.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=os.path.join(ROOT, "configs", "experiment_B.yaml"))
    ap.add_argument("--batch", type=int, default=0, help="micro-batch (default: the config's)")
    ap.add_argument("--remat", default="1", help="CAIM_TRAIN_REMAT for the run")
    args = ap.parse_args()

    import torch
    import yaml
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, ROOT)
    from cognitive_aim_tpu_torch.core.precision import DEFAULT_POLICY
    from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel
    from cognitive_aim_tpu_torch.models.config import resolve_model_config
    from cognitive_aim_tpu_torch.train.trainer import TrainConfig, Trainer

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    os.environ["CAIM_TRAIN_REMAT"] = args.remat
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    with open(args.config) as f:
        raw = yaml.safe_load(f)
    arch = resolve_model_config(raw, lookup="nested")
    B = args.batch or int(raw["training"]["batch_size"])
    g = torch.Generator(device="cuda").manual_seed(0)
    model = CognitiveAimModel(arch, DEFAULT_POLICY, "pallas_packed").init(g)
    S = arch.image_size
    batch = {"images": torch.randn(B, S, S, 3, generator=g, device="cuda"),
             "depths": torch.rand(B, S, S, generator=g, device="cuda"),
             "exif": {"camera_idx": torch.zeros(B, dtype=torch.int32, device="cuda"),
                      "focal_length": torch.full((B,), 0.25, device="cuda"),
                      "aperture": torch.full((B,), 0.127, device="cuda"),
                      "iso": torch.full((B,), 0.016, device="cuda")}}
    tr = Trainer(model, TrainConfig.from_raw(raw, steps_per_epoch=4),
                 output_dir=os.path.join(ROOT, "build", "profile_train_step"))
    k = max(1, tr.cfg.accumulation_steps)
    for _ in range(k + 1):  # captures each micro-step kind; the next is mid-cycle
        tr.train_step(batch, g, fetch_logs=False)
    torch.cuda.synchronize()

    result = {"card": smi, "config": os.path.relpath(args.config, ROOT), "batch": B,
              "remat": args.remat}
    for mode, name in ((m, n) for m in ("eager", "replayed")
                       for n in ("micro_step", "update_step")):
        eager = mode == "eager"
        while (tr._mini_step == k - 1) != (name == "update_step") and k > 1:
            tr.train_step(batch, g, fetch_logs=False, eager=eager)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.train_step(batch, g, fetch_logs=False, eager=eager)
            host_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # device kernels only: the profiler also lays each record_function range
        # (``recompute_vjp ...``) on the device's timeline, over the kernels inside it
        ev = [(e.name, (e.time_range.end - e.time_range.start) / 1e3,
               e.time_range.start, e.time_range.end)
              for e in prof.events() if e.device_type == DeviceType.CUDA
              and not e.name.startswith("recompute_vjp")]
        busy = sum(t for _, t, _, _ in ev)
        span = (max(e for *_, e in ev) - min(s for _, _, s, _ in ev)) / 1e3 if ev else 0.0
        by_name = collections.Counter()
        calls = collections.Counter()
        for n, t, _, _ in ev:
            by_name[n] += t
            calls[n] += 1

        def group(n):
            if "flash_wgmma_kernel" in n:
                return "K1 forward (flash_wgmma_kernel)"
            if "focal_" in n:
                return "K6 forward (focal kernels)"
            if any(s in n for s in ("gemm", "Gemm", "sm90_xmma", "cutlass", "nvjet", "ampere")):
                return "GEMMs (cuBLAS)"
            if "softmax" in n.lower():
                return "softmax"
            return "other (elementwise, reductions, copies)"

        groups = collections.Counter()
        for n, t in by_name.items():
            groups[group(n)] += t
        ranges = {}
        for e in prof.key_averages():
            if e.key.startswith("recompute_vjp"):
                ranges[e.key] = (getattr(e, "device_time_total", 0) or
                                 getattr(e, "cuda_time_total", 0)) / 1e3
        top = [{"kernel": n[:110], "ms": t, "calls": calls[n]}
               for n, t in by_name.most_common(20)]
        result[f"{mode}_{name}"] = {
            "device_busy_ms": busy, "device_span_ms": span, "wall_ms": wall_ms,
            "host_enqueue_ms": host_ms,
            "idle_share": max(0.0, 1.0 - busy / wall_ms) if wall_ms else None,
            "groups_ms": dict(groups.most_common()), "recompute_ranges_ms": ranges,
            "device_kernels": len(ev), "top_kernels": top}
        print(f"{mode} {name}: device busy {busy:.1f} ms, wall {wall_ms:.1f} ms, idle "
              f"{result[f'{mode}_{name}']['idle_share'] * 100:.1f}%, host a call "
              f"{host_ms:.2f} ms, {len(ev)} device operations ({smi})")
        for gname, t in groups.most_common():
            print(f"  {gname}: {t:.1f} ms")
        for r, t in ranges.items():
            print(f"  range {r}: {t:.1f} ms of device time")
        for row in top[:12]:
            print(f"    {row['ms']:8.2f} ms {row['calls']:5d}x {row['kernel']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
