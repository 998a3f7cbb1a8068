#!/usr/bin/env python3
"""Device time of the port's int8-QK^T attention (K10, K10b) beside K1 and K7.

    python3 scripts/time_i8qk_attention.py [--root DIR] [--lib PATH] [--reps 20] [--bits]

At B 8, H 12 (D 768) on seeded bf16 inputs, by CUDA graphs (``--reps`` calls
captured, the graph replayed: device time without the host's launch rate),
each case timed twice in the order yardstick, kernel, wrapper, wrapper,
kernel, yardstick:

  * K10 at N 1370 and 481 beside K1 ``flash_attention_packed`` on the same
    q, k, v;
  * K10b at N 481 and 1370 (bias: log token counts on the 4 trailing keys)
    beside K7 ``flash_attention_packed_bias``;

"kernel" is the attention kernel alone on q and k quantised beforehand
(``caim_flash_attention_i8qk``, whose C signature every tree of the port
shares), "wrapper" the wrapper with its quantising launches. Also prints a
SHA-256 of the bits of K1, K7, K8, K9, K10, K10b (and K1 in float32)
outputs on seeded inputs, so that two trees' runs show whether those
kernels' outputs are the same; ``--bits`` prints those alone.

``--root`` imports ``cognitive_aim_tpu_torch`` from another checkout (the
parent commit unpacked by ``git archive``), so two trees compare by running
this script on each in turns on one card. ``--lib`` loads a kernel library
built elsewhere (a development variant of a source) in place of building
``csrc/``. Prints the card's name and power
limit, one line per case and a JSON object as the last line. Needs a CUDA
device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys


def events_ms(fn, iters=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, reps=20, replays=5):
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return events_ms(graph.replay, iters=replays, warmup=1) / reps


def digest(t) -> str:
    import torch

    torch.cuda.synchronize()
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--lib", default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--bits", action="store_true", help="the outputs' digests only, no times")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("time_i8qk_attention: no CUDA device", file=sys.stderr)
        return 2
    from cognitive_aim_tpu_torch.kernels import _build
    from cognitive_aim_tpu_torch.kernels import flash_attention as FA
    from cognitive_aim_tpu_torch.kernels._launch import ptr, stream_of

    if args.lib:
        import ctypes

        _build._lib = _build._declare(ctypes.CDLL(os.path.abspath(args.lib)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi: n/a")
    print(f"package: {os.path.dirname(FA.__file__)}"
          + (f", library {args.lib}" if args.lib else ""))
    lib = _build.library()
    g = torch.Generator(device="cuda").manual_seed(0)
    B, H, D = 8, 12, 768
    result = {"device": smi.stdout.strip(), "shape": f"B{B} H{H}", "cases": {}, "sha256": {}}

    for N in (1370, 481):
        q, k, v = ((torch.randn(B, N, D, generator=g, device="cuda")).bfloat16()
                   for _ in range(3))
        bias = torch.zeros(B, N, device="cuda")
        bias[:, -4:] = torch.randint(1, 891, (B, 4), generator=g, device="cuda").float().log()
        q8, sq = FA.quantize_rows_plain(q)
        k8, sk = FA.quantize_rows_plain(k)

        def alone(row):
            out = torch.empty_like(v)
            err = lib.caim_flash_attention_i8qk(
                ptr(q8), ptr(sq), ptr(k8), ptr(sk), ptr(v),
                ptr(row) if row is not None else None, ptr(out), B, N, H, 64, 0.125,
                stream_of(q))
            _build.check(err)
            return out

        cases = {
            "K10": (("K1", lambda: FA.flash_attention_packed(q, k, v, 0.125, H)),
                    lambda: alone(None),
                    lambda: FA.flash_attention_packed_i8qk(q, k, v, 0.125, H)),
            "K10b": (("K7", lambda: FA.flash_attention_packed_bias(q, k, v, bias, 0.125, H)),
                     lambda: alone(bias),
                     lambda: FA.flash_attention_packed_i8qk_bias(q, k, v, bias, 0.125, H)),
        }
        for name, ((yname, yard), kernel, wrapper) in cases.items() if not args.bits else ():
            runs = [(yname, yard), ("kernel", kernel), ("wrapper", wrapper)]
            ms = {n: [] for n, _ in runs}
            for n, fn in runs + runs[::-1]:
                ms[n].append(graph_ms(fn, args.reps))
            result["cases"][f"{name} N{N}"] = ms
            print(f"{name} B{B} N{N} H{H} by CUDA graphs (order {yname}, kernel, wrapper, "
                  f"wrapper, kernel, {yname}): {yname} {ms[yname][0]:.4f}/{ms[yname][1]:.4f} ms, "
                  f"kernel {ms['kernel'][0]:.4f}/{ms['kernel'][1]:.4f} ms, wrapper "
                  f"{ms['wrapper'][0]:.4f}/{ms['wrapper'][1]:.4f} ms; kernel / {yname} "
                  f"{sum(ms['kernel']) / sum(ms[yname]):.3f}", flush=True)
        hashes = {
            "K1": digest(FA.flash_attention_packed(q, k, v, 0.125, H)),
            "K7": digest(FA.flash_attention_packed_bias(q, k, v, bias, 0.125, H)),
            "K8": digest(FA.flash_attention(*(t.view(B, N, H, 64) for t in (q, k, v)), 0.125)),
            "K9": digest(FA.flash_attention_packed_int8(q, k, v, 0.125, H)),
            "K10": digest(FA.flash_attention_packed_i8qk(q, k, v, 0.125, H)),
            "K10b": digest(FA.flash_attention_packed_i8qk_bias(q, k, v, bias, 0.125, H)),
            "K1 f32": digest(FA.flash_attention_packed(q.float(), k.float(), v.float(), 0.125,
                                                       H)),
        }
        result["sha256"][f"N{N}"] = hashes
        print(f"output bits N{N}: " + ", ".join(f"{n} {h}" for n, h in hashes.items()))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
