#!/usr/bin/env python3
"""Host time of one call of the port's attention wrappers, without a synchronise.

    python3 scripts/time_attention_host.py [--root DIR] [--calls 1000]

Times K1 ``flash_attention_packed``, K7 ``flash_attention_packed_bias``, K8
``flash_attention``, and K10 ``flash_attention_packed_i8qk`` and K10b
``flash_attention_packed_i8qk_bias`` with their quantisation of q and k, on
the host's clock around ``--calls`` back-to-back
calls that nothing synchronises: what the wrapper, its checks, the ctypes
call and the C entry (among it the bf16 program's tensor-map encoding) cost
the host a launch. Two shapes: B 1, N 64, H 12, whose kernel takes less time
than its launch, so the host's rate is what is read; and the token filter's
B 8, N 481, H 12. ``--root`` imports ``cognitive_aim_tpu_torch`` from
another checkout (e.g. the parent commit unpacked by ``git archive``), so
two trees compare by running this script once on each, in turns, on the
same card. Prints the card's name and power limit, one line per case, and a
JSON object as the last line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--calls", type=int, default=1000)
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("time_attention_host: no CUDA device", file=sys.stderr)
        return 2
    from cognitive_aim_tpu_torch.kernels import flash_attention as FA

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi: n/a")
    print(f"package: {os.path.dirname(FA.__file__)}")
    g = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    for B, N in ((1, 64), (8, 481)):
        H, D = 12, 768
        q, k, v = (torch.randn(B, N, D, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        bias = torch.randn(B, N, generator=g, device="cuda")
        q4, k4, v4 = (t.view(B, N, H, 64) for t in (q, k, v))
        cases = {"K1": lambda: FA.flash_attention_packed(q, k, v, 0.125, H),
                 "K7": lambda: FA.flash_attention_packed_bias(q, k, v, bias, 0.125, H),
                 "K8": lambda: FA.flash_attention(q4, k4, v4, 0.125),
                 "K10": lambda: FA.flash_attention_packed_i8qk(q, k, v, 0.125, H),
                 "K10b": lambda: FA.flash_attention_packed_i8qk_bias(q, k, v, bias, 0.125, H)}
        for name, fn in cases.items():
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            us = []
            for _ in range(args.rounds):
                t0 = time.perf_counter()
                for _ in range(args.calls):
                    fn()
                us.append((time.perf_counter() - t0) / args.calls * 1e6)
                torch.cuda.synchronize()
            key = f"{name} B{B} N{N} H{H}"
            result[key] = us
            print(f"{key}: host us a call, {args.rounds} rounds of {args.calls}: "
                  + " ".join(f"{u:.2f}" for u in us) + f" (min {min(us):.2f})")
    print(json.dumps({"host_us_per_call": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
