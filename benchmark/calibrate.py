"""The readings behind the limits of ``correct``, for one cell, in one
process on the card:

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 --seed0 <n> \
        --seconds 3 --control-seeds 3 [--out build/calib.jsonl]

For each of ``--seeds`` seeds from ``--seed0``: one run of the cell with a
short window (``harness.execute``: the timed path at the cell's own batch
and load), whose numbers are the program's readings; for the first
``--control-seeds`` of them, the control on the same compared inputs: the
reference at int4 in the program's place, held against the reference at
int8 (``compare.against_reference`` with ``control_bits=4``), judged by the
cell's limits as a run is (``harness.verdict``). One JSON line a seed; the
largest program reading and the smallest control reading of each number at
the end. Exits with 1 where a control seed comes out correct. The
benchmark's own runs never run the control.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import env  # noqa: E402

env.prepare(ROOT)

from benchmark import compare, harness  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--seed0", type=int, required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    rows, program, ctrl, passed = [], {}, {}, []
    for i in range(a.seeds):
        seed = a.seed0 + 7919 * i
        rc, line, res = harness.execute(a.workload, seed, a.seconds, False)
        if rc != 0:
            return rc
        row = {"seed": seed, "correct": line["correct"], "program": res.numbers,
               "metrics": {k: v["value"] for k, v in line["metrics"].items()}}
        for k, v in res.numbers.items():
            program[k] = max(program.get(k, 0.0), v)
        if i < a.control_seeds:
            ctx = harness.context(a.workload, seed, a.seconds, False)
            c = compare.against_reference(ctx, res.flat, res.cases, control_bits=4)
            row["control"] = c
            row["control_correct"] = harness.verdict(c, ctx.traffic["limits"], 0)
            if row["control_correct"]:
                passed.append(seed)
            for k, v in c.items():
                ctrl[k] = min(ctrl.get(k, float("inf")), v)
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": a.workload, "program_max": program, "control_min": ctrl,
               "separation": {k: ctrl[k] / program[k] for k in ctrl if program.get(k)},
               "control_correct_on": passed}
    print(json.dumps(summary), flush=True)
    if a.out:
        with open(a.out, "a") as f:
            for r in rows + [summary]:
                f.write(json.dumps(r) + "\n")
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
