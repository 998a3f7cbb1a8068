"""The token filter's certification table from delta_sweep outputs
(counterpart of scripts/certify_filter.py; its printed JSON is byte for byte
the script's on the same inputs).

Inputs: delta_sweep JSONs with the ground-truth metric (``absrel_gt`` per
cell). Two comparisons per (seed, law) cell:

  - prediction parity (strict): worst-instruction mean |d_fast - d_exact| /
    |d_exact| on the SAME weights, each run's "table";
  - metric parity (deployment): |AbsRel_gt(fast path, its weights) -
    AbsRel_gt(f32 exact, BASELINE weights)| per instruction. With
    --baseline a standard-training sweep and --candidate a filter-aware
    finetune sweep, this asks whether a user who finetunes WITH the filter
    sees the accuracy the exact model delivers.

Reports the MAX over cells (seeds x laws) per spec. Pure Python: it reads
JSON and computes no tensor, so it takes no ``--device``.

    python -m cognitive_aim_tpu_torch.certify.certify_filter \\
        --baseline build/certify/delta_sweep.json \\
        --candidate build/certify/delta_sweep_tf.json [--budget 0.01] [--out t.json]
"""

import argparse
import json


def load_runs(path):
    with open(path) as f:
        return json.load(f)["runs"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", required=True,
                    help="delta_sweep JSON whose f32 absrel_gt is the "
                         "exact-model accuracy baseline per (seed, law)")
    ap.add_argument("--candidate", required=True,
                    help="delta_sweep JSON with the fast-path cells "
                         "(e.g. a --train-filter run)")
    ap.add_argument("--budget", type=float, default=0.01)
    ap.add_argument("--out", type=str, default="",
                    help="also write the printed JSON to this file")
    args = ap.parse_args(argv)

    base = {(r["seed"], r["law"]): r["absrel_gt"]["f32"]
            for r in load_runs(args.baseline) if r.get("absrel_gt")}
    cand = load_runs(args.candidate)

    specs = sorted({s for r in cand for s in r["table"]})
    print(f"{'spec':>24s} {'worst metric gap':>18s} "
          f"{'worst pred-parity':>18s}  verdict (max over cells)")
    results = {}
    for spec in specs:
        worst_gap, worst_pred, worst_cell = 0.0, 0.0, None
        for r in cand:
            key = (r["seed"], r["law"])
            if key not in base or spec not in r["table"]:
                continue
            gt_fast = r["absrel_gt"][spec]
            gap = max(abs(gt_fast[g] - base[key][g]) for g in gt_fast)
            pred = max(r["table"][spec].values())
            if gap > worst_gap:
                worst_gap, worst_cell = gap, key
            worst_pred = max(worst_pred, pred)
        verdict = "WITHIN" if worst_gap <= args.budget else "EXCEEDS"
        print(f"{spec:>24s} {worst_gap * 100:>17.3f}% "
              f"{worst_pred * 100:>17.3f}%  {verdict} "
              f"{args.budget * 100:.0f}% budget (worst cell {worst_cell})")
        results[spec] = {"worst_metric_gap": worst_gap,
                         "worst_pred_parity": worst_pred,
                         "worst_cell": list(worst_cell) if worst_cell
                         else None}
    out = {"budget": args.budget, "specs": results,
           "baseline": args.baseline, "candidate": args.candidate}
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(out) + "\n")
    return out


if __name__ == "__main__":
    main()
