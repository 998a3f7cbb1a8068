"""The knee of a served cell: offered rate against completed rate and
latency, in one process on the card, for the rate its traffic file fixes:

    python3 benchmark/sweep.py --workload <cell> --seed <n> --rates 150,200,250 --seconds 8

Each rate runs the cell's own open loop (drivers/served.py) on one engine
and server. A rate is sustained where the completions keep up with the
arrivals and the latency does not grow over the window (the last third of
the requests, by due time, against the first). One JSON line a rate.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import env  # noqa: E402

env.prepare(ROOT)

import numpy as np  # noqa: E402

from benchmark import harness, inputs, spec, system  # noqa: E402
from benchmark.reference.model import normalize_u8  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    a = p.parse_args(argv)
    from cognitive_aim_tpu_torch.serve import BatchingServer

    ctx = harness.context(a.workload, a.seed, a.seconds, False)
    served = spec.driver(ROOT, "served")
    t = ctx.traffic
    eng, _ = system.build(ctx, t.get("token_filter", ""))
    server = BatchingServer(eng, max_batch=int(t["max_batch"]),
                            max_delay_ms=float(t["max_delay_ms"]))
    pool = list(normalize_u8(inputs.images_u8(served.POOL_IMAGES, ctx.dims.image, a.seed,
                                              "served.images", ctx.device)).cpu().numpy())
    clients = served.client_pool(int(t["clients"]))
    for rate in [float(r) for r in a.rates.split(",")]:
        due = served.arrivals(rate, a.seconds, a.seed, f"sweep.{rate}")
        req = served.Requests(ctx, pool, len(due), f"sweep.{rate}")
        k0 = len(server.batches)
        t0 = time.perf_counter()
        lat, answers, late, failed = served.open_loop(server, req, due, clients, a.seconds)
        wall = time.perf_counter() - t0
        b = list(server.batches)[k0:]
        third = len(due) // 3
        ok = np.isfinite(lat)
        row = {"rate": rate, "requests": len(due), "failed": int(failed),
               "completed_per_s": float(ok.sum() / wall), "wall_s": wall,
               "p50_ms": float(np.median(lat) * 1e3),
               "p95_ms": float(np.sort(lat)[int(np.ceil(0.95 * len(lat))) - 1] * 1e3),
               "first_third_mean_ms": float(np.mean(lat[:third]) * 1e3),
               "last_third_mean_ms": float(np.mean(lat[-third:]) * 1e3),
               "batch_fill": float(np.mean([x["n"] for x in b]) / int(t["max_batch"])),
               "dispatch_ms": float(np.mean([x["dispatch_ms"] for x in b])),
               "drain_ms": float(np.mean([x["drain_ms"] for x in b])),
               "late_p99_ms": float(np.percentile(late, 99) * 1e3)}
        print(json.dumps(row), flush=True)
    clients.shutdown()
    server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
