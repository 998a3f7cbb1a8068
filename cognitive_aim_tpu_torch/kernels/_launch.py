"""Argument checks and ctypes plumbing shared by the kernels' CUDA paths.

A kernel reaches PyTorch as a ``caim`` custom op (``_library``); its
implementation, given CUDA tensors, runs these checks and passes the
tensors' ``data_ptr()`` and the current stream to the library's C entry
(``_build``). An op's fake calls nothing here."""

from __future__ import annotations

import ctypes

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_cuda_inputs(name: str, tensors, shape) -> int:
    """Raise unless every tensor is a contiguous, 16-byte-aligned CUDA tensor
    of ``shape`` with one dtype the kernels take, all on one device. Returns
    the dtype code the C entry points expect."""
    t0 = tensors[0]
    if t0.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t0.dtype} not supported "
                        f"(float32 or bfloat16)")
    for t in tensors:
        if t.device != t0.device or t.dtype != t0.dtype:
            raise ValueError(f"{name}: inputs differ in device or dtype")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")
    return DTYPE_CODES[t0.dtype]


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require_device(name: str, t: torch.Tensor):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel or plain version for device "
                         f"{t.device}")
