"""Build the CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` source compiles in an ``nvcc`` process of its own, all
started together, and one more links the objects into one shared library
with a plain C interface (no PyTorch headers, so the build takes seconds).
The library goes to ``build/kernels/<hash>/`` at the root of the
checkout, keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is loaded as is. The directory is listed in
``.gitignore``.

Nothing here runs at import: ``library()`` builds on its first call, which
comes from the CUDA implementation of a ``caim`` custom op (``_library``):
each kernel reaches PyTorch as such an op, whose implementation checks the
CUDA tensors and calls the library's C entry through ctypes. An op's fake
(shapes only, for ``torch.export``'s tracing) never calls ``library()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the build in this process, None if loaded


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the kernels are "
                       "compiled from csrc/ at first use")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds) -> str:
    """Run the commands side by side; raise on the first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, proc, (stdout, stderr) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                               f"{stdout}\n{stderr}")
    return "".join(stderr for _, stderr in outs)


def _build(sources, out: Path) -> str:
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    objs = [out.parent / f"{s.stem}.{pid}.o" for s in sources]
    log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
                for s, o in zip(sources, objs)])
    tmp = out.with_suffix(f".{pid}.tmp")
    _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    os.replace(tmp, out)  # atomic: a concurrent build sees whole files only
    for o in objs:
        o.unlink()
    return log  # ptxas -v: registers, shared memory, spills


def _declare(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # q, k, v, bias (or null), out, B, N, H, head_dim, scale, dtype, stream
    lib.caim_flash_attention_packed.argtypes = [p, p, p, p, p, i, i, i, i, f, i, p]
    lib.caim_flash_attention_packed.restype = i
    # q8, sq, k8, sk, v, bias (or null), out, B, N, H, head_dim, scale, stream
    lib.caim_flash_attention_i8qk.argtypes = [p, p, p, p, p, p, p, i, i, i, i, f, p]
    lib.caim_flash_attention_i8qk.restype = i
    # q8, sq, k8, sk ([B, H, N] scales), v, out, B, N, H, head_dim, scale, stream
    lib.caim_flash_attention_i8qk_heads.argtypes = [p, p, p, p, p, p, i, i, i, i, f, p]
    lib.caim_flash_attention_i8qk_heads.restype = i
    # q, k, v, wq, ws, bias, ls, res, out, ctx8, sc (or null), B, N, H, head_dim,
    # scale, stream
    lib.caim_flash_attention_out_res.argtypes = [p] * 11 + [i, i, i, i, f, p]
    lib.caim_flash_attention_out_res.restype = i
    # H -> K11's CTAs a cluster (0: not taken); its clusters resident at once
    lib.caim_out_res_cluster_size.argtypes = [i]
    lib.caim_out_res_cluster_size.restype = i
    lib.caim_out_res_active_clusters.argtypes = [i]
    lib.caim_out_res_active_clusters.restype = i
    # bias, i8qk -> the attention program's blocks resident on an SM
    lib.caim_flash_blocks_per_sm.argtypes = [i, i]
    lib.caim_flash_blocks_per_sm.restype = i
    # x, y (or null), xq, yq, sx, sy, M, K, stream: per row
    lib.caim_quantize_rows.argtypes = [p, p, p, p, p, p, i, i, p]
    lib.caim_quantize_rows.restype = i
    # x, y (or null), xq, yq, sx, sy, B, N, K, stream: per (row, head)
    lib.caim_quantize_heads.argtypes = [p, p, p, p, p, p, i, i, i, p]
    lib.caim_quantize_heads.restype = i
    lib.caim_focal_attention.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, f, i, p]
    lib.caim_focal_attention.restype = i
    lib.caim_focal_q_tile.argtypes = [i, i]
    lib.caim_focal_q_tile.restype = i
    lib.caim_focal_scratch_floats.argtypes = [i, i, i]
    lib.caim_focal_scratch_floats.restype = ctypes.c_longlong
    # x, gamma, beta, eps, wq, ws, bias, qkv, xq, sx, M, D, stream
    lib.caim_int8_qkv.argtypes = [p, p, p, f, p, p, p, p, p, p, i, i, p]
    lib.caim_int8_qkv.restype = i
    # x, aq, sa, wq, ws, bias, ls, res, out, M, K, N, stream
    lib.caim_int8_out_residual.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, p]
    lib.caim_int8_out_residual.restype = i
    # x, gamma, beta, eps, wq, ws, bias, h8, sh, xq, sx, M, K, F, stream
    lib.caim_int8_fc1_gelu.argtypes = [p, p, p, f, p, p, p, p, p, p, p, i, i, i, p]
    lib.caim_int8_fc1_gelu.restype = i
    # x, wq, ws, bias, h8, sh, xq, sx, M, K, F, stream
    lib.caim_int8_fc1_gelu_rows.argtypes = [p, p, p, p, p, p, p, p, i, i, i, p]
    lib.caim_int8_fc1_gelu_rows.restype = i
    # F -> the fc1 GEMM's cluster size (0: no kernel takes F); its clusters
    # resident at once (cudaOccupancyMaxActiveClusters)
    for fn in (lib.caim_fc1_cluster_size, lib.caim_fc1_active_clusters):
        fn.argtypes = [i]
        fn.restype = i
    # M, N, parts, SMs -> the int8 GEMM's tile columns (0: no kernel takes N)
    lib.caim_gemm_tile_cols.argtypes = [i, i, i, i]
    lib.caim_gemm_tile_cols.restype = i
    # tile columns -> the GEMM's CTAs resident at once, the most a launch starts
    lib.caim_gemm_resident_ctas.argtypes = [i]
    lib.caim_gemm_resident_ctas.restype = i
    # ctx, wo, so, bo, ls1, res, gamma, beta, eps, w1, s1, b1, w2, s2, b2, ls2, out,
    # M, K, F, stream
    lib.caim_int8_attnout_mlp.argtypes = [p] * 8 + [f] + [p] * 8 + [i, i, i, p]
    lib.caim_int8_attnout_mlp.restype = i
    # K, F -> K12's cluster size (0: no kernel takes them); its clusters resident
    for fn in (lib.caim_attnout_mlp_cluster_size, lib.caim_attnout_mlp_active_clusters):
        fn.argtypes = [i, i]
        fn.restype = i
    # x, xq, sx, wq, ws, bias, out, M, K, N, stream
    for fn in (lib.caim_int8_proj, lib.caim_int8_gemm_fused):
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, p]
        fn.restype = i
    # q, k, v, out, q_strides, k_strides, v_strides (3 int64 each: batch, token,
    # head), B, N, H, head_dim, scale, dtype, stream
    lib.caim_flash_attention.argtypes = [p, p, p, p, p, p, p, i, i, i, i, f, i, p]
    lib.caim_flash_attention.restype = i
    lib.caim_error_string.argtypes = [i]
    lib.caim_error_string.restype = ctypes.c_char_p
    return lib


def library():
    """The loaded kernel library, built first if this source set has no
    library yet."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            sources = _sources()
            out = BUILD_ROOT / _digest(sources) / "libcaim_kernels.so"
            if not out.exists():
                t0 = time.perf_counter()
                log = _build(sources, out)
                build_seconds = time.perf_counter() - t0
                (out.parent / "ptxas.log").write_text(log)
            _lib = _declare(ctypes.CDLL(str(out)))
        return _lib


def check(err: int):
    if err != 0:
        msg = library().caim_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel launch failed: error {err} ({msg})")
