"""Training-throughput table of the PyTorch + CUDA port (counterpart of
scripts/bench_train_table.py): the JAX script's five rows, each through
scripts/torch_bench_train.py in a fresh subprocess, since the ``TB_*`` knobs
and ``CAIM_TRAIN_REMAT`` are read when the trainer's micro-steps are
captured. The rows cover the two workloads the repository trains (224^2
frozen backbone with adapters; 518^2 everything trainable, the delta_sweep /
pretrain workload) and the recompute axis.

    python scripts/torch_bench_train_table.py [--out build/train_table.json]
        [--rows 224_full_B32,518_full_B8_remat]

Each row holds the replayed step's ms/step and img/s with host copies and on
a staged batch ("device-only"), the eager step's beside them, the graphs'
pool and peak memory, and the card's name and power limit.
"""

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ROWS = [
    # label, env
    ("224_frozen_lora_B32", {"TB_S": "224", "TB_B": "32", "TB_FROZEN": "1"}),
    ("224_full_B32", {"TB_S": "224", "TB_B": "32", "TB_FROZEN": "0"}),
    ("518_full_B8_remat", {"TB_S": "518", "TB_B": "8", "TB_FROZEN": "0",
                           "CAIM_TRAIN_REMAT": "1"}),
    ("518_full_B8_noremat", {"TB_S": "518", "TB_B": "8", "TB_FROZEN": "0",
                             "CAIM_TRAIN_REMAT": "0"}),
    ("518_frozen_lora_B8", {"TB_S": "518", "TB_B": "8", "TB_FROZEN": "1"}),
]

STEP = re.compile(r"train step .*: ([\d.]+) ms/step \((\d+) img/s\)")
DEV = re.compile(r"device-only train step: ([\d.]+) ms/step \((\d+) img/s\)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=str, default=os.path.join(ROOT, "build", "train_table.json"))
    ap.add_argument("--rows", type=str, default="",
                    help="comma list of row labels (default all)")
    ap.add_argument("--timeout", type=float, default=1800)
    args = ap.parse_args(argv)

    rows = list(ROWS)
    if args.rows:
        sel = set(args.rows.split(","))
        rows = [r for r in rows if r[0] in sel]

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    results = {}
    for label, env_over in rows:
        env = dict(os.environ, **env_over)
        p = subprocess.run(
            [sys.executable, os.path.join(ROOT, "scripts", "torch_bench_train.py")],
            env=env, capture_output=True, text=True, timeout=args.timeout, cwd=ROOT)
        text = p.stdout + p.stderr
        m, md = STEP.search(text), DEV.search(text)
        last = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
        if p.returncode != 0 or not m or not last.startswith("{"):
            tail = "\n".join(text.strip().splitlines()[-8:])
            print(f"{label}: FAILED (rc {p.returncode})\n{tail}", flush=True)
            results[label] = None
        else:
            row = json.loads(last)
            results[label] = {
                "ms_per_step": float(m.group(1)), "img_per_s": int(m.group(2)),
                "device_ms_per_step": float(md.group(1)) if md else None,
                "device_img_per_s": int(md.group(2)) if md else None,
                "eager_ms_per_step": row["eager_ms"],
                "eager_device_ms_per_step": row["device_only_eager_ms"],
                "graphs": row.get("graphs"), "pool_mib": row.get("pool_mib"),
                "peak_gib": row.get("peak_gib"), "card": row["card"]}
            r = results[label]
            print(f"{label}: {r['ms_per_step']} ms/step ({r['img_per_s']} img/s), eager "
                  f"{r['eager_ms_per_step']:.1f}; device-only {r['device_ms_per_step']} ms "
                  f"({r['device_img_per_s']} img/s), eager {r['eager_device_ms_per_step']:.1f}"
                  f" ({r['card']})", flush=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
