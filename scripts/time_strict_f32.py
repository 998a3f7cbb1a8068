#!/usr/bin/env python3
"""Device time of the port's strict-policy float32 attention kernels, by CUDA
graphs, beside their bound on the card's f32 FMA pipes and the library call.

    python3 scripts/time_strict_f32.py [--reps 10] [--root DIR]

The strict-f32 policy runs K1, K7 and K8 through ``flash_f32_kernel`` /
``flash_bnhd_f32_kernel`` (csrc/flash_attention_packed.cu,
csrc/flash_attention.cu, program csrc/flash_f32.cuh) and K6 through
``focal_f32_scores_kernel`` / ``focal_f32_attend_kernel``
(csrc/focal_attention.cu): exact f32 FMAs on register tiles, so that the
policy's products are f32 (TF32 off). Times, on seeded float32 inputs, at
the strict slice's shape (224x224: B 2, N 257 tokens, 256 focal patches) and
at 518x518 (B 8, N 1370, 1369 patches), D 768 (H 12):

  * each kernel's wrapper by CUDA graphs (``--reps`` calls captured, the
    graph replayed), twice, there and back, and its plain PyTorch version
    (the same f32 arithmetic, TF32 off) once, with the largest difference
    between the two (K6: of attended, and of its three f32 views);
  * the bound: the larger of the bytes moved once over 3.35 TB/s and the
    products' operations (4 B N^2 D) over 67 TFLOP/s, the H100 SXM's float32
    rate outside the tensor cores (TF32 is off, as the policy demands);
  * the library call: ``scaled_dot_product_attention`` in float32 with TF32
    off for K1 and K8 (K7: with the bias as an additive mask); none for K6;
  * the launches of each kernel in one strict forward at 224x224 (ViT-B, 2
    focal iterations, seeded weights), and the device time of one strict
    forward at 224x224 (B 2) and at 518x518 (B 8): its kernels' durations
    summed by torch.profiler, and CUDA events around the call;
  * the registers and spills ptxas reported for the f32 kernels.

``--root DIR`` imports ``cognitive_aim_tpu_torch`` from another checkout (a
``git archive`` of the parent commit unpacked under ``build/``), which
builds its own kernels: run the parent, this tree, this tree and the parent
in one call to compare them on one card.

Prints the card's name and power limit, one line per case and a JSON object
as the last line. Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12  # H100 SXM, float32 FMA pipes (NVIDIA data sheet)


def events_ms(fn, iters, warmup=1):
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


def graph_ms(fn, reps, replays=3):
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
    return events_ms(graph.replay, iters=replays) / reps


def ptxas_lines(lib_path):
    """(kernel, registers, spill stores, spill loads) of the f32 kernels."""
    import re

    log = os.path.join(os.path.dirname(lib_path), "ptxas.log")
    if not os.path.exists(log):
        return []
    out = []
    for m in re.finditer(r"Compiling entry function '(\w+)'.*?(\d+) bytes spill stores, "
                         r"(\d+) bytes spill loads.*?Used (\d+) registers", open(log).read(),
                         re.S):
        if "f32" in m.group(1):
            out.append((m.group(1), int(m.group(4)), int(m.group(2)), int(m.group(3))))
    return out


def device_kernels(fn):
    """(name, ms) of each device kernel of one call of fn (torch.profiler),
    after a call outside the trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, (e.time_range.end - e.time_range.start) / 1e3) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def device_busy_ms(fn):
    """The durations of the device kernels of one call of fn, summed."""
    busy = sum(ms for _, ms in device_kernels(fn))
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return busy


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_strict_f32: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from cognitive_aim_tpu_torch.core.precision import STRICT_F32
    from cognitive_aim_tpu_torch.kernels import _build
    from cognitive_aim_tpu_torch.kernels import flash_attention as FA
    from cognitive_aim_tpu_torch.kernels import focal_attention as FO
    from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel
    from cognitive_aim_tpu_torch.models.config import ModelArchConfig

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    device = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi: n/a"
    print(device, flush=True)
    lib = _build.library()
    print(f"package: {os.path.dirname(FA.__file__)}; library {lib._name}", flush=True)
    regs = ptxas_lines(lib._name)
    for name, n, st, ld in regs:
        print(f"  {name[:70]}: {n} registers, spills {st}/{ld} bytes", flush=True)
    result = {"device": device, "root": os.path.abspath(args.root), "cases": {},
              "registers": regs, "launches_per_strict_forward": {}, "forward_ms": {}}
    g = torch.Generator(device="cuda").manual_seed(0)
    H, Dh = 12, 64
    D = H * Dh

    def bound(n_bytes, n_ops):
        t_b, t_o = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_F32 * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    def err(got, want):
        if isinstance(got, tuple):
            return [float((a.float() - b.float()).abs().max()) for a, b in zip(got, want)]
        return float((got.float() - want.float()).abs().max())

    def case(name, shape, kernel, plain, n_bytes, n_ops, library=None):
        max_abs_err = err(kernel(), plain())
        ms = [graph_ms(kernel, args.reps)]
        plain_ms = graph_ms(plain, args.reps)
        lib_ms = [graph_ms(library, args.reps)] if library else []
        if library:
            lib_ms.append(graph_ms(library, args.reps))
        ms.append(graph_ms(kernel, args.reps))
        b_ms, b_by = bound(n_bytes, n_ops)
        result["cases"][f"{name} {shape}"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                                              "bound_by": b_by, "library_ms": lib_ms or None,
                                              "max_abs_err": max_abs_err}
        print(f"{name} {shape} f32 by CUDA graphs, there and back: {ms[0]:.4f}/{ms[1]:.4f} ms; "
              f"plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by})"
              + (f"; library {lib_ms[0]:.4f}/{lib_ms[1]:.4f} ms" if library else "")
              + f"; max |kernel - plain| {max_abs_err}", flush=True)

    for B, N in ((2, 257), (8, 1370)):
        shape = f"B{B} N{N} H{H}"
        q, k, v = (torch.randn(B, N, D, generator=g, device="cuda") for _ in range(3))
        bias = torch.randn(B, N, generator=g, device="cuda")
        ops = 4 * B * N * N * D

        def heads(t):
            return t.view(B, N, H, Dh).transpose(1, 2)

        def sdpa(mask=None):
            return F.scaled_dot_product_attention(heads(q), heads(k), heads(v), attn_mask=mask,
                                                  scale=0.125)

        case("K1", shape, lambda: FA.flash_attention_packed(q, k, v, 0.125, H),
             lambda: FA.flash_attention_packed_plain(q, k, v, 0.125, H),
             4 * B * N * D * 4, ops, sdpa)
        mask = bias[:, None, None, :]
        case("K7", shape, lambda: FA.flash_attention_packed_bias(q, k, v, bias, 0.125, H),
             lambda: FA.flash_attention_packed_bias_plain(q, k, v, bias, 0.125, H),
             4 * B * N * D * 4 + B * N * 4, ops, lambda: sdpa(mask))
        q4, k4, v4 = (t.view(B, N, H, Dh) for t in (q, k, v))
        case("K8", shape, lambda: FA.flash_attention(q4, k4, v4, 0.125),
             lambda: FA.attention_reference(q4, k4, v4, 0.125), 4 * B * N * D * 4, ops, sdpa)
        Nf = N - 1  # the focal stream's patches
        q6, k6, v6 = (t[:, 1:].contiguous() for t in (q, k, v))
        case("K6", f"B{B} N{Nf} D{D}",
             lambda: FO.focal_attention_fused(q6, k6, v6, (D // 8) ** 0.5),
             lambda: FO.focal_attention_plain(q6, k6, v6, (D // 8) ** 0.5),
             4 * B * Nf * D * 4 + 3 * B * Nf * 4, 4 * B * Nf * Nf * D)
        # the three kernels of a K6 call, each by the profiler
        parts = device_kernels(lambda: FO.focal_attention_fused(q6, k6, v6, (D // 8) ** 0.5))
        result["cases"][f"K6 B{B} N{Nf} D{D}"]["kernels_ms"] = parts
        print(f"K6 B{B} N{Nf} D{D} f32, its kernels (profiler): " + ", ".join(
            f"{n.split('(')[0][:48]} {ms:.4f} ms" for n, ms in parts), flush=True)

    # the launches of one strict forward at 224x224
    model = CognitiveAimModel(ModelArchConfig(num_iterations=2, image_size=224), STRICT_F32,
                              "pallas_packed")
    model.init(torch.Generator(device="cuda").manual_seed(3)).prepare_params()
    x = torch.randn(2, 224, 224, 3, generator=g, device="cuda")
    wrappers = {"K1": FA.flash_attention_packed, "K7": FA.flash_attention_packed_bias,
                "K8": FA.flash_attention, "K6": FO.focal_attention_fused}
    for w in wrappers.values():
        w.launches = 0
    with torch.no_grad():  # inference: no autograd graph
        model(x, guidance=torch.tensor([0, 5], device="cuda"))
    torch.cuda.synchronize()
    result["launches_per_strict_forward"] = {n: w.launches for n, w in wrappers.items()}
    print("launches in one strict forward at 224x224: " + ", ".join(
        f"{n} {c}" for n, c in result["launches_per_strict_forward"].items()), flush=True)
    del model
    for size, B in ((224, 2), (518, 8)):  # one strict forward's device time
        model = CognitiveAimModel(ModelArchConfig(num_iterations=2, image_size=size),
                                  STRICT_F32, "pallas_packed")
        model.init(torch.Generator(device="cuda").manual_seed(3)).prepare_params()
        x = torch.randn(B, size, size, 3, generator=g, device="cuda")
        gidx = torch.arange(B, device="cuda") % 9

        def forward():
            with torch.no_grad():
                return model(x, guidance=gidx)

        busy = device_busy_ms(forward)
        events = [events_ms(forward, iters=3) for _ in range(2)]
        result["forward_ms"][f"{size}x{size} B{B}"] = {"device_busy_ms": busy,
                                                     "events_ms": events}
        print(f"strict forward {size}x{size} B{B}: device busy {busy:.3f} ms (profiler), "
              f"CUDA events {events[0]:.3f}/{events[1]:.3f} ms", flush=True)
        del model
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
