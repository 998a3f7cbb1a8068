#!/usr/bin/env python3
"""Build variants of the bf16 attention program (K1, K7, K8) and time them in turns.

    python3 scripts/time_flash_variants.py

Each variant is ``cognitive_aim_tpu_torch/csrc/flash_wgmma.cu`` with one
constant or launch bound changed by text substitution, compiled with nvcc
into its own library under ``build/flash_variants/`` (outside ``csrc/``, so
the package's own build never links it). For each variant the script prints
ptxas's registers, spills and wgmma serialisation warnings and the blocks an
SM from the occupancy query; checks it against the plain PyTorch version at
N 1..1370 with ViT-B and ViT-L heads, unbiased and with a log-count bias row
(atol 1e-2), that a zero bias row gives the unbiased bits, and the one-hot-V
permutation probe; then times K1 and K7 of every variant by CUDA graphs at
B 8, N 1370 and 481, H 12, beside ``scaled_dot_product_attention`` (with and
without the bias as an additive mask): three turns, the list in order, then
reversed, then in order again. Prints the card's name and power
limit first. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "cognitive_aim_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "flash_variants")

ENTRY = '''
extern "C" int variant_flash(const void* q, const void* k, const void* v, const void* bias,
                             void* out, int B, int N, int H, float scale, void* stream) {
  const caim::HeadStrides s{(long long)N * H * 64, (long long)H * 64, 64};
  return (int)caim::launch_flash_bf16(q, s, k, s, v, s, static_cast<const float*>(bias), out,
                                      B, N, H, scale, static_cast<cudaStream_t>(stream));
}
extern "C" int variant_blocks_per_sm() {
  if (caim::configure_once<false>() != cudaSuccess) return -1;
  int n = -1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, caim::flash_wgmma_kernel<false>,
                                                caim::THREADS, caim::FlashTile<false>::SMEM);
  return n;
}
'''
# S = Q K^T for 128-key tiles: wgmma m64n128k16, A (Q) from registers
QK128 = r'''
__device__ __forceinline__ void wgmma_bf16_64x128_rs(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, {%64,%65,%66,%67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}
__device__ __forceinline__ void qk_step(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                        int acc) {
  wgmma_bf16_64x128_rs(d, a, b, acc);
}
__device__ __forceinline__ void qk_step(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                        int acc) {
  wgmma_bf16_64x64_rs<false>(d, a, b, acc);
}
'''
QK_LOOP = ("  for (int kk = 0; kk < 4; ++kk) wgmma_bf16_64x64_rs<false>(s, qf[kk], dk + 2 * kk, "
           "kk);\n")
# name -> (keys a tile, ring stages, minimum blocks an SM in the launch bound)
VARIANTS = {"as built": (64, 4, 2), "128 keys, 3 stages": (128, 3, 2),
            "128 keys, 2 stages": (128, 2, 2), "3 stages, 3 blocks": (64, 3, 3),
            "2 stages, 3 blocks": (64, 2, 3), "2 stages, 4 blocks": (64, 2, 4)}


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"flash_wgmma.cu no longer holds {old!r}: update this script")
    return text.replace(old, new)


def variant_source(src: str, keys: int, stages: int, blocks: int) -> str:
    s = _sub(src, "constexpr int KT = 64;", f"constexpr int KT = {keys};")
    s = re.sub(r"constexpr int STAGES = 4;[^\n]*", f"constexpr int STAGES = {stages};", s)
    s = _sub(s, "__launch_bounds__(THREADS, 2)", f"__launch_bounds__(THREADS, {blocks})")
    s = _sub(s, QK_LOOP, "  for (int kk = 0; kk < 4; ++kk) qk_step(s, qf[kk], dk + 2 * kk, kk);\n")
    return _sub(s, "namespace {\n", "namespace {\n" + QK128) + ENTRY


def build(src: str):
    from cognitive_aim_tpu_torch.kernels._build import _nvcc

    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for i, (name, cfg) in enumerate(VARIANTS.items()):
        path = os.path.join(OUT, f"v{i}.cu")
        with open(path, "w") as f:
            f.write(variant_source(src, *cfg))
        procs[name] = (path[:-3] + ".so", subprocess.Popen(
            [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-I", CSRC, "-Xptxas", "-v", "-Xcompiler", "-fPIC",
             "-shared", "-o", path[:-3] + ".so", path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    P, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            print(f"{name}: BUILD FAILED\n{log[-2000:]}")
            continue
        regs = sorted(set(re.findall(r"Used (\d+) registers", log)))
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", log)))
        warns = sorted(set(re.findall(r"\((C75\d\d)\)", log)))
        lib = ctypes.CDLL(so)
        lib.variant_flash.argtypes = [P, P, P, P, P, i32, i32, i32, f32, P]
        lib.variant_blocks_per_sm.restype = i32
        print(f"{name}: registers {'/'.join(regs)}, spill stores {'/'.join(spills)} bytes, "
              f"wgmma warnings {warns or 'none'}, blocks an SM {lib.variant_blocks_per_sm()}")
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("time_flash_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from cognitive_aim_tpu_torch.kernels import flash_attention as FA

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi: n/a")
    with open(os.path.join(CSRC, "flash_wgmma.cu")) as f:
        libs = build(f.read())

    def run(lib, q, k, v, bias, out, H, scale):
        B, N, _ = q.shape
        err = lib.variant_flash(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                None if bias is None else bias.data_ptr(), out.data_ptr(),
                                B, N, H, scale, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
        return out

    g = torch.Generator(device="cuda").manual_seed(0)
    failed = []
    for name, lib in libs.items():
        worst = 0.0
        for H in (12, 16):
            for N in (1, 63, 64, 65, 127, 128, 129, 257, 416, 481, 826, 1370):
                q, k, v = (torch.randn(2, N, H * 64, generator=g, device="cuda")
                           .to(torch.bfloat16) for _ in range(3))
                bias = torch.randint(1, 891, (2, N), generator=g, device="cuda").float().log()
                qf, kf, vf = q.float(), k.float(), v.float()
                got = run(lib, q, k, v, None, torch.empty_like(q), H, 0.125)
                gotb = run(lib, q, k, v, bias, torch.empty_like(q), H, 0.125)
                zero = run(lib, q, k, v, torch.zeros_like(bias), torch.empty_like(q), H, 0.125)
                errs = [float((got.float() - FA.flash_attention_packed_plain(
                            qf, kf, vf, 0.125, H)).abs().max()),
                        float((gotb.float() - FA.flash_attention_packed_bias_plain(
                            qf, kf, vf, bias, 0.125, H)).abs().max())]
                worst = max(worst, *errs)
                if max(errs) > 1e-2 or not torch.equal(zero, got):
                    failed.append((name, N, H, errs))
        B, H, N = 2, 4, 1370
        onehot = torch.zeros(B, N, H, 64, device="cuda")
        j = torch.arange(N, device="cuda")
        onehot[:, j, :, j % 64] = 1.0
        k = onehot.reshape(B, N, H * 64).to(torch.bfloat16)
        got = run(lib, (40.0 * k.float()).to(torch.bfloat16), k, k, None, torch.empty_like(k),
                  H, 1.0)
        if not torch.equal(got.view(B, N, H, 64).float().argmax(-1),
                           (j % 64)[None, :, None].expand(B, N, H)):
            failed.append((name, "permutation probe"))
        print(f"{name}: max_abs_err {worst:.3e} (tol 1e-2) at N 1..1370, H 12 and 16")
    if failed:
        print(f"FAILED: {failed}")
        return 1

    def graph_ms(fn, reps=20, replays=5):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / replays / reps

    for N in (1370, 481):
        B, H = 8, 12
        q, k, v = (torch.randn(B, N, H * 64, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        bias = torch.randint(1, 891, (B, N), generator=g, device="cuda").float().log()
        mask = bias[:, None, None, :].to(torch.bfloat16).expand(B, H, N, N)
        out = torch.empty_like(q)

        def hv(t):
            return t.view(B, N, H, 64).transpose(1, 2)

        fns = {"SDPA": lambda: F.scaled_dot_product_attention(hv(q), hv(k), hv(v), scale=0.125),
               "masked SDPA": lambda: F.scaled_dot_product_attention(
                   hv(q), hv(k), hv(v), attn_mask=mask, scale=0.125)}
        for name, lib in libs.items():
            fns[f"K1 {name}"] = lambda lib=lib: run(lib, q, k, v, None, out, H, 0.125)
            fns[f"K7 {name}"] = lambda lib=lib: run(lib, q, k, v, bias, out, H, 0.125)
        ms = {n: [] for n in fns}
        for n in list(fns) + list(fns)[::-1] + list(fns):
            ms[n].append(graph_ms(fns[n]))
        print(f"B{B} N{N} H{H}, ms by CUDA graphs, three turns:")
        for n, ts in ms.items():
            print(f"  {n}: " + " / ".join(f"{t:.4f}" for t in ts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
