#!/usr/bin/env python3
"""Device time of the port's int8 GEMM wrappers at the ViT-B slice's shapes.

    python3 scripts/time_int8_gemm.py [--root DIR] [--lib PATH] [--reps 20]

Times K2 ``int8_qkv_proj_ln``, K5 ``int8_qkv_proj``, K3 ``int8_out_residual``,
K4b ``int8_out_residual_prequant``, K13 ``int8_proj`` (attn_out, fc1 and fc2
shapes), K15 ``int8_gemm_fused`` and K12 ``int8_attnout_mlp_ln`` at B 8, N 1370
(K5: 1369), D 768, F 3072 on seeded inputs: by CUDA events around 20 calls, by
CUDA graphs (20 calls captured, the graph replayed: device time without the
host's launch rate), and by the profiler (each device kernel of one call, so
that the GEMM is read apart from its quantising prologue). Beside each GEMM,
``torch._int_mm`` at the same [M, K] x [K, N] by CUDA graphs: a yardstick of
the product alone, which writes int32 and has no prologue or epilogue.

``--root`` imports ``cognitive_aim_tpu_torch`` from another checkout (the
parent commit unpacked by ``git archive``), so two trees compare by running
this script on each in turns on one card. ``--lib`` loads a kernel library
built elsewhere in place of building ``csrc/``. Prints the card's name and
power limit, one line per case and a JSON object as the last line. Needs a
CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
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


def kernels_us(fn):
    """(name, microseconds) of each device kernel of one call of fn."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.end - e.time_range.start) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--lib", default=None)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("time_int8_gemm: no CUDA device", file=sys.stderr)
        return 2
    from cognitive_aim_tpu_torch.kernels import _build
    from cognitive_aim_tpu_torch.kernels import int8_block as IB
    from cognitive_aim_tpu_torch.kernels import int8_gemm as IG
    from cognitive_aim_tpu_torch.kernels.int8_ops import quantize_weight

    if args.lib:
        import ctypes

        _build._lib = _build._declare(ctypes.CDLL(os.path.abspath(args.lib)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi: n/a")
    print(f"package: {os.path.dirname(IB.__file__)}" + (f", library {args.lib}" if args.lib
                                                         else ""))
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)

    def vec(n, scale, shift=0.0):
        return (rand(n, scale=scale) + shift).bfloat16().float()

    def weight(n, k):
        w = quantize_weight(rand(n, k, scale=0.05))
        return w["q"], w["s"], vec(n, 0.01)

    B, N, D, F = 8, 1370, 768, 3072
    M = B * N
    x, ctx = rand(B, N, D, dtype=torch.bfloat16), rand(B, N, D, dtype=torch.bfloat16)
    x5 = rand(B, N - 1, D, dtype=torch.bfloat16)
    ga, be, ls, ls2 = vec(D, 0.1, 1.0), vec(D, 0.05), vec(D, 0.1, 0.9), vec(D, 0.1, 0.8)
    wqkv, wo, w1, w2 = weight(3 * D, D), weight(D, D), weight(F, D), weight(D, F)
    h8, sh = IB.int8_fc1_gelu_ln_plain(x, ga, be, *w1)
    rows = {K: rand(M, K, dtype=torch.bfloat16) for K in (D, F)}
    cases = {
        # name: (call, [M, K, N] of its GEMM)
        "K2": (lambda: IB.int8_qkv_proj_ln(x, ga, be, *wqkv), (M, D, 3 * D)),
        "K5": (lambda: IB.int8_qkv_proj(x5, *wqkv), (B * (N - 1), D, 3 * D)),
        "K3": (lambda: IB.int8_out_residual(ctx, *wo, ls, x), (M, D, D)),
        "K4b": (lambda: IB.int8_out_residual_prequant(h8, sh, *w2, ls, x), (M, F, D)),
        "K13 768->3072": (lambda: IB.int8_proj(rows[D].view(B, N, D), *w1), (M, D, F)),
        "K13 768->768": (lambda: IB.int8_proj(rows[D].view(B, N, D), *wo), (M, D, D)),
        "K13 3072->768": (lambda: IB.int8_proj(rows[F].view(B, N, F), *w2), (M, F, D)),
        "K15": (lambda: IG.int8_gemm_fused(rows[D], *wqkv), (M, D, 3 * D)),
        "K12": (lambda: IB.int8_attnout_mlp_ln(ctx, *wo, ls, x, ga, be, *w1, *w2, ls2), None),
    }
    result = {"device": smi.stdout.strip(), "shape": f"B{B} N{N} D{D} F{F}"}
    for name, (fn, gemm) in cases.items():
        t = {"events_ms": events_ms(fn, iters=args.reps), "graph_ms": graph_ms(fn, args.reps)}
        ks = kernels_us(fn)
        t["kernels_us"] = [[n[:60], us] for n, us in ks]
        line = (f"{name}: events {t['events_ms']:.4f} ms, graphs {t['graph_ms']:.4f} ms; "
                f"kernels " + ", ".join(f"{n[:40]} {us:.1f} us" for n, us in ks))
        if gemm is not None:
            Mg, K, Ng = gemm
            a8 = torch.randint(-127, 128, (Mg, K), generator=g, device="cuda",
                               dtype=torch.int8)
            b8 = torch.randint(-127, 128, (Ng, K), generator=g, device="cuda",
                               dtype=torch.int8)
            t["int_mm_graph_ms"] = graph_ms(lambda: torch._int_mm(a8, b8.t()), args.reps)
            t["gemm_tops"] = 2 * Mg * K * Ng / (t["graph_ms"] * 1e9)
            line += (f"; torch._int_mm yardstick {t['int_mm_graph_ms']:.4f} ms; "
                     f"{t['gemm_tops']:.0f} TOP/s by graphs")
        print(line, flush=True)
        result[name] = t
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
