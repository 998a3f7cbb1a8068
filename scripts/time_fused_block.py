#!/usr/bin/env python3
"""Device time of the port's K12 (the post-attention half of the int8 block)
beside K3 -> K4, of K9 beside K10, and of K11 beside K1 + K3, by CUDA graphs.

    python3 scripts/time_fused_block.py [--root DIR] [--lib PATH] [--only K11] [--reps 20]

At B 8, D 768 (H 12), F 3072 on seeded inputs, by CUDA graphs (``--reps``
calls captured, the graph replayed: device time without the host's launch
rate), each case timed twice, there and back:

  * K12 ``int8_attnout_mlp_ln`` beside K3 ``int8_out_residual`` followed by K4
    ``int8_mlp_ln`` (the block's route without ``CAIM_FUSE_AOMLP``) at N 1370
    and 481;
  * K9 ``flash_attention_packed_int8`` beside K10
    ``flash_attention_packed_i8qk`` (both wrappers, with their quantising
    launches) and K10's attention kernel alone on q and k quantised
    beforehand (``caim_flash_attention_i8qk``, whose C signature every tree
    of the port shares), at N 1370 and 481; K9's kernel alone where the tree
    has it (``quantize_heads``, then the int8 program on (row, head) scales);
  * K11 ``flash_attention_packed_out_res`` beside K1 ``flash_attention_packed``
    followed by K3 ``int8_out_residual`` (what it fuses) at N 1370, 481 and
    257, with K11's clusters resident at once where the tree has the query.

``--only K11`` (or K12, K9) times that case alone; ``--lib`` loads a kernel
library built elsewhere (a development variant of a source) in place of
building ``csrc/``.

Before the times it prints the registers and spill bytes ptxas reported for
the kernels of K12, K9 and K10 in the tree's build (``ptxas.log`` beside the
library), and the card's name and power limit.

``--root`` imports ``cognitive_aim_tpu_torch`` from another checkout (the
parent commit unpacked by ``git archive``), which builds its own kernels; so
two trees compare by running this script on each in turns on one card
(parent, this tree, this tree, parent). The last line is a JSON object.
Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import re
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


def ptxas_lines(lib_path: str):
    """(kernel, registers, spill stores, spill loads) of the kernels of K12,
    K9 and K10 in the build's ptxas log."""
    log = os.path.join(os.path.dirname(lib_path), "ptxas.log")
    if not os.path.exists(log):
        return []
    text = open(log).read()
    out = []
    for m in re.finditer(r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, "
                         r"(\d+) bytes spill loads.*?Used (\d+) registers", text, re.S):
        name = m.group(1)
        k12 = re.search(r"AoTileILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", name)
        flash = re.search(r"flash_wgmma_kernelILb(\d)ELb1E", name)
        out_res = re.search(r"flash_wgmma_kernelILb0ELb0ELb1E", name)
        if k12:
            name = "attnout_mlp_kernel<cluster %s, KC %s, NWC %s, sweeps %s>" % k12.groups()
        elif out_res:
            name = "flash_wgmma_kernel<out_res> (K11)"
        elif flash:
            name = f"flash_wgmma_kernel<{'bias' if flash.group(1) == '1' else 'no bias'}, i8qk>"
        elif any(k in name for k in ("quant_heads", "flash_int8dots", "quant_rows_pair",
                                     "fc1_gelu_quant", "int8_gemm_tma_kernelILi",
                                     "flash_out_res_kernel")):
            name = re.sub(r"^_ZN4caim\d+", "", name)[:60]
        else:
            continue
        out.append((name, int(m.group(4)), int(m.group(2)), int(m.group(3))))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--lib", default=None)
    ap.add_argument("--only", choices=("K12", "K9", "K11"), default=None)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("time_fused_block: no CUDA device", file=sys.stderr)
        return 2
    from cognitive_aim_tpu_torch.kernels import _build

    if args.lib:
        import ctypes

        _build._lib = _build._declare(ctypes.CDLL(os.path.abspath(args.lib)))
    from cognitive_aim_tpu_torch.kernels import flash_attention as FA
    from cognitive_aim_tpu_torch.kernels import int8_block as IB
    from cognitive_aim_tpu_torch.kernels._launch import ptr, stream_of
    from cognitive_aim_tpu_torch.kernels.int8_ops import quantize_weight

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    device = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi: n/a"
    print(device)
    print(f"package: {os.path.dirname(FA.__file__)}"
          + (f", library {args.lib}" if args.lib else ""))
    lib = _build.library()
    regs = ptxas_lines(lib._name)
    for name, n, st, ld in regs:
        print(f"  {name}: {n} registers, spills {st}/{ld} bytes")
    g = torch.Generator(device="cuda").manual_seed(0)
    B, H, D, F = 8, 12, 768, 3072
    result = {"device": device, "root": os.path.abspath(args.root), "lib": args.lib,
              "ptxas": regs, "cases": {}}
    if hasattr(lib, "caim_out_res_active_clusters"):
        result["K11 clusters"] = {H: lib.caim_out_res_active_clusters(H) for H in (12, 16)}
        print("K11 clusters resident at once: " + ", ".join(
            f"H {H}: {n}" for H, n in result["K11 clusters"].items()))

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    def vec(n, scale, shift=0.0):  # f32 at bf16-rounded values, as prepare_params leaves them
        return (rnd(n, scale=scale) + shift).bfloat16().float()

    def turns(name, runs):
        ms = {n: [] for n, _ in runs}
        for n, fn in runs + runs[::-1]:
            ms[n].append(graph_ms(fn, args.reps))
        result["cases"][name] = ms
        print(f"{name} by CUDA graphs, there and back: " + ", ".join(
            f"{n} {v[0]:.4f}/{v[1]:.4f} ms" for n, v in ms.items()), flush=True)

    for N in (1370, 481) if args.only in (None, "K12", "K9") else ():
        x, ctx = rnd(B, N, D).bfloat16(), rnd(B, N, D).bfloat16()
        ga, be, ls, ls2 = vec(D, 0.1, 1.0), vec(D, 0.05), vec(D, 0.1, 0.9), vec(D, 0.1, 0.8)
        w = {}
        for name, n, k in (("out", D, D), ("fc1", F, D), ("fc2", D, F)):
            q = quantize_weight(rnd(n, k, scale=0.05))
            w[name] = (q["q"], q["s"], vec(n, 0.01))

        def k12():
            return IB.int8_attnout_mlp_ln(ctx, *w["out"], ls, x, ga, be, *w["fc1"], *w["fc2"], ls2)

        def k3_k4():
            h = IB.int8_out_residual(ctx, *w["out"], ls, x)
            return IB.int8_mlp_ln(h, ga, be, *w["fc1"], *w["fc2"], ls2)

        if args.only != "K9":
            turns(f"K12 B{B} N{N} D{D} F{F}", [("K12", k12), ("K3 -> K4", k3_k4)])
        if args.only == "K12":
            continue

        q, k, v = (rnd(B, N, D).bfloat16() for _ in range(3))
        q8, sq = FA.quantize_rows_plain(q)
        k8, sk = FA.quantize_rows_plain(k)

        def k10_kernel():
            out = torch.empty_like(v)
            _build.check(lib.caim_flash_attention_i8qk(
                ptr(q8), ptr(sq), ptr(k8), ptr(sk), ptr(v), None, ptr(out), B, N, H, 64, 0.125,
                stream_of(q)))
            return out

        runs = [("K10 kernel", k10_kernel),
                ("K9", lambda: FA.flash_attention_packed_int8(q, k, v, 0.125, H)),
                ("K10", lambda: FA.flash_attention_packed_i8qk(q, k, v, 0.125, H))]
        if hasattr(FA, "quantize_heads"):  # K9 on the int8 program: its kernel alone too
            q8h, sqh, k8h, skh = FA.quantize_heads_plain(q, H, k)
            runs.insert(1, ("K9 kernel", lambda: FA._launch_i8qk_kernel(
                q8h, sqh, k8h, skh, v, None, 0.125, H, head_scales=True)))
        turns(f"K9 B{B} N{N} H{H}", runs)
    for N in (1370, 481, 257) if args.only in (None, "K11") else ():
        q, k, v, res = (rnd(B, N, D).bfloat16() for _ in range(4))
        wo = quantize_weight(rnd(D, D, scale=0.05))
        b, ls = vec(D, 0.01), vec(D, 0.1, 0.9)
        turns(f"K11 B{B} N{N} H{H}", [
            ("K11", lambda: FA.flash_attention_packed_out_res(q, k, v, wo["q"], wo["s"], b, ls,
                                                              res, 0.125, H)),
            ("K1 + K3", lambda: IB.int8_out_residual(FA.flash_attention_packed(q, k, v, 0.125, H),
                                                     wo["q"], wo["s"], b, ls, res))])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
