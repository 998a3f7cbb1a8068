#!/usr/bin/env python3
"""Device time of the port's strict-policy float32 attention kernels, by CUDA
graphs, beside their bound on the card's f32 FMA pipes and the library call.

    python3 scripts/time_strict_f32.py [--reps 10]

The strict-f32 policy runs K1, K7 and K8 through ``flash_f32_kernel`` /
``flash_bnhd_f32_kernel`` (csrc/flash_attention_packed.cu,
csrc/flash_attention.cu, body csrc/flash_body.cuh) and K6 through
``focal_f32_stats_kernel`` / ``focal_f32_attend_kernel``
(csrc/focal_attention.cu): plain f32 FMAs over 64-row tiles in shared
memory, so that the policy's products are exact f32 (TF32 off). Times, on
seeded float32 inputs, at the strict slice's shape (224x224: B 2, N 257
tokens, 256 focal patches) and at 518x518 (B 8, N 1370, 1369 patches), D 768
(H 12):

  * each kernel's wrapper by CUDA graphs (``--reps`` calls captured, the
    graph replayed), twice, there and back, and its plain PyTorch version
    (the same f32 arithmetic, TF32 off) once;
  * the bound: the larger of the bytes moved once over 3.35 TB/s and the
    products' operations (4 B N^2 D) over 67 TFLOP/s, the H100 SXM's float32
    rate outside the tensor cores (TF32 is off, as the policy demands);
  * the library call: ``scaled_dot_product_attention`` in float32 with TF32
    off for K1 and K8 (K7: with the bias as an additive mask); none for K6;
  * the launches of each kernel in one strict forward at 224x224 (ViT-B, 2
    focal iterations, seeded weights).

Prints the card's name and power limit, one line per case and a JSON object
as the last line. Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_strict_f32: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from cognitive_aim_tpu_torch.core.precision import STRICT_F32
    from cognitive_aim_tpu_torch.kernels import flash_attention as FA
    from cognitive_aim_tpu_torch.kernels import focal_attention as FO
    from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel
    from cognitive_aim_tpu_torch.models.config import ModelArchConfig

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    device = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi: n/a"
    print(device, flush=True)
    result = {"device": device, "cases": {}, "launches_per_strict_forward": {}}
    g = torch.Generator(device="cuda").manual_seed(0)
    H, Dh = 12, 64
    D = H * Dh

    def bound(n_bytes, n_ops):
        t_b, t_o = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_F32 * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    def case(name, shape, kernel, plain, n_bytes, n_ops, library=None):
        ms = [graph_ms(kernel, args.reps)]
        plain_ms = graph_ms(plain, args.reps)
        lib_ms = [graph_ms(library, args.reps)] if library else []
        if library:
            lib_ms.append(graph_ms(library, args.reps))
        ms.append(graph_ms(kernel, args.reps))
        b_ms, b_by = bound(n_bytes, n_ops)
        result["cases"][f"{name} {shape}"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                                              "bound_by": b_by, "library_ms": lib_ms or None}
        print(f"{name} {shape} f32 by CUDA graphs, there and back: {ms[0]:.4f}/{ms[1]:.4f} ms; "
              f"plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by})"
              + (f"; library {lib_ms[0]:.4f}/{lib_ms[1]:.4f} ms" if library else ""),
              flush=True)

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
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
