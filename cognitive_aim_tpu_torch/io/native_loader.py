"""ctypes bindings for the native C++ batch loader (counterpart of
cognitive_aim_tpu/io/native_loader.py).

Multi-threaded JPEG/PNG decode + torch-style bilinear resize (half-pixel,
no antialias) + optional ImageNet normalization into NHWC batches, off the
GIL. The source is the port's own copy, ``io/native/loader.cpp``; it is
built at first use with ``g++`` into ``build/native_loader/<hash>/`` at the
root of the checkout (listed in ``.gitignore``), keyed by the source, the
flags and the host, never into the source tree. Where no toolchain builds
it (no compiler, no libjpeg / libpng headers) every function falls back to
PIL (``io/preprocess.py``), as the JAX package does: that is host decode,
not a device path. ``decoder()`` says which one runs, and
``build_error`` why the native one does not.

The loader's resize is not PIL's antialiased one, which ``predict`` uses:
the two host paths differ by design, in both packages.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

_SOURCE = Path(__file__).resolve().parent / "native" / "loader.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native_loader"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
LIBS = ("-ljpeg", "-lpng", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
build_error: Optional[str] = None  # why the native loader is unavailable


def _library_path() -> Path:
    h = hashlib.sha256(_SOURCE.read_bytes())
    # -march=native code is for this host's CPU only
    h.update(" ".join(CXX_FLAGS + LIBS + (platform.node(), platform.machine())).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / "libcaim_loader.so"


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_paths, c_int = ctypes.POINTER(ctypes.c_char_p), ctypes.c_int
    u8p = ctypes.POINTER(ctypes.c_ubyte)
    lib.caim_decode_resize_batch.restype = c_int
    lib.caim_decode_resize_batch.argtypes = [
        c_paths, c_int, c_int, c_int, ctypes.POINTER(ctypes.c_float), u8p, c_int, c_int]
    lib.caim_decode_resize_batch_u8.restype = c_int
    lib.caim_decode_resize_batch_u8.argtypes = [
        c_paths, c_int, c_int, c_int, u8p, u8p, c_int]
    lib.caim_decode_resize_batch_u8_exif.restype = c_int
    lib.caim_decode_resize_batch_u8_exif.argtypes = [
        c_paths, c_int, c_int, c_int, u8p, u8p, u8p, ctypes.POINTER(c_int), c_int, c_int]
    return lib


def _ensure_built() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed, build_error
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        out = _library_path()
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(_SOURCE), *LIBS]
            try:
                subprocess.run(cmd, check=True, capture_output=True, text=True,
                               timeout=300)
                os.replace(tmp, out)  # atomic: processes building at once race safely
            except (OSError, subprocess.SubprocessError) as e:
                _build_failed = True
                detail = getattr(e, "stderr", "") or str(e)
                build_error = detail.strip().splitlines()[0] if detail.strip() else repr(e)
                import logging

                logging.getLogger(__name__).warning(
                    "native loader build failed (%s); falling back to PIL", build_error)
                return None
        _lib = _declare(ctypes.CDLL(str(out)))
        return _lib


def available() -> bool:
    return _ensure_built() is not None


def decoder() -> str:
    """'native' (the C++ loader) or 'pil' (the fallback)."""
    return "native" if available() else "pil"


def _c_paths(paths: List[str]):
    return (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])


def decode_resize_batch(
    paths: List[str],
    out_h: int,
    out_w: int,
    normalize: bool = True,
    n_threads: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (batch [N, H, W, 3] f32, ok [N] bool). Falls back to PIL when
    the native library is unavailable."""
    lib = _ensure_built()
    n = len(paths)
    out = np.empty((n, out_h, out_w, 3), np.float32)
    ok = np.zeros(n, np.uint8)
    if lib is None:
        from cognitive_aim_tpu_torch.io.preprocess import (
            load_image_uint8,
            normalize_np,
            pil_resize_host,
        )

        for i, p in enumerate(paths):
            try:
                img = pil_resize_host(load_image_uint8(p), out_h, out_w)
                out[i] = normalize_np(img) if normalize else img
                ok[i] = 1
            except Exception:
                out[i] = 0.0
        return out, ok.astype(bool)

    lib.caim_decode_resize_batch(
        _c_paths(paths), n, out_h, out_w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        n_threads, 1 if normalize else 0,
    )
    return out, ok.astype(bool)


def decode_resize_batch_u8(
    paths: List[str], out_h: int, out_w: int, n_threads: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """uint8 variant: (batch [N, H, W, 3] u8, ok [N] bool), 4x less
    host->device transfer; normalize on the device with
    ``preprocess.normalize_u8``."""
    lib = _ensure_built()
    n = len(paths)
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    ok = np.zeros(n, np.uint8)
    if lib is None:
        from cognitive_aim_tpu_torch.io.preprocess import load_image_uint8, pil_resize_host

        for i, p in enumerate(paths):
            try:
                img = pil_resize_host(load_image_uint8(p), out_h, out_w)
                out[i] = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
                ok[i] = 1
            except Exception:
                out[i] = 0
        return out, ok.astype(bool)
    lib.caim_decode_resize_batch_u8(
        _c_paths(paths), n, out_h, out_w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        n_threads,
    )
    return out, ok.astype(bool)


_EXIF_CAP = 1 << 16  # APP1 segments are <= 65533 bytes by format


def decode_resize_batch_u8_exif(
    paths: List[str], out_h: int, out_w: int, n_threads: int = 0
) -> tuple[np.ndarray, np.ndarray, List[Optional[bytes]]]:
    """uint8 decode+resize AND the raw EXIF APP1 payloads in ONE pass over
    each file (the native loader captures the marker during the JPEG header
    parse). Returns (batch u8, ok bool, [payload bytes | None] per image);
    parse payloads with ``io.exif.extract_exif_from_app1``. Falls back to
    PIL and a Python APP1 scan."""
    lib = _ensure_built()
    n = len(paths)
    if lib is None:
        from cognitive_aim_tpu_torch.io import exif as exif_io

        out, ok = decode_resize_batch_u8(paths, out_h, out_w, n_threads)
        return out, ok, [exif_io.read_exif_app1(p) for p in paths]
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    ok = np.zeros(n, np.uint8)
    exif_buf = np.zeros((n, _EXIF_CAP), np.uint8)
    exif_lens = np.zeros(n, np.int32)
    lib.caim_decode_resize_batch_u8_exif(
        _c_paths(paths), n, out_h, out_w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        exif_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        exif_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        _EXIF_CAP, n_threads,
    )
    payloads = [
        bytes(exif_buf[i, : exif_lens[i]]) if exif_lens[i] else None
        for i in range(n)
    ]
    return out, ok.astype(bool), payloads
