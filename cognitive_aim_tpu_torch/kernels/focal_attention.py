"""K6: fused single-head focal attention.

Counterpart of ``focal_attention_fused`` in
cognitive_aim_tpu/kernels/focal_attention.py. The kernel is CUDA C++ in
``csrc/focal_attention.cu``; the plain PyTorch version beside it mirrors
the JAX package's ``focal_attention_reference``.

The wrapper calls the op ``caim::focal_attention_fused`` (``_library``),
whose implementation dispatches on the tensor's device: CPU tensors take the
plain version, CUDA tensors launch the kernel or raise.
``focal_attention_fused.launches`` counts kernel launches (one per call; the
call runs three CUDA kernels).

Differentiable in q, k, v as the JAX package's ``custom_vjp``: the backward
recomputes the plain version from the saved inputs and takes the gradients
of all four outputs (``_grad.recompute_vjp``; an output whose gradient is
None counts as zeros).
"""

from __future__ import annotations

from typing import Tuple

import torch

from cognitive_aim_tpu_torch.kernels import _build
from cognitive_aim_tpu_torch.kernels._grad import recompute_vjp
from cognitive_aim_tpu_torch.kernels._launch import (
    check_cuda_inputs,
    ptr,
    require_device,
    stream_of,
)
from cognitive_aim_tpu_torch.kernels._library import kernel_op


def focal_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float):
    """q, k, v [B, N, D] -> (attended [B, N, D] in q's dtype, colmean, diag,
    rowmax [B, N] f32). Scores in the input dtype divided by ``scale``, f32
    softmax, P cast to q's dtype before the PV product."""
    scores = torch.matmul(q, k.transpose(-1, -2)) / scale
    attn = torch.softmax(scores.float(), dim=-1)
    attended = torch.matmul(attn.to(q.dtype), v)
    colmean = attn.mean(dim=1)
    diag = torch.diagonal(attn, dim1=-2, dim2=-1)
    rowmax = attn.amax(dim=-1)
    return attended, colmean, diag, rowmax


def focal_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float):
    """Same outputs as ``focal_attention_plain``. CPU -> plain version;
    CUDA -> the K6 kernel. ``scale`` divides the scores."""
    return recompute_vjp(_k6_op, focal_attention_plain, 3, q, k, v, scale)


def _k6_fake(q, k, v, scale):
    B, N, _ = q.shape
    return (q.new_empty(q.shape), *(q.new_empty(B, N, dtype=torch.float32) for _ in range(3)))


@kernel_op("focal_attention_fused", _k6_fake)
def _k6_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    require_device("focal_attention_fused", q)
    if q.device.type == "cpu":
        attended, colmean, diag, rowmax = focal_attention_plain(q, k, v, scale)
        return attended, colmean, diag.contiguous(), rowmax  # diag: a view of the scores
    B, N, D = q.shape
    code = check_cuda_inputs("focal_attention_fused", (q, k, v), (B, N, D))
    lib = _build.library()
    q_tile = lib.caim_focal_q_tile(code, D)  # 0: no kernel takes this width
    if q_tile == 0:
        raise ValueError(f"focal_attention_fused: no {q.dtype} kernel takes D {D} "
                         f"(caim_focal_q_tile in csrc/focal_attention.cu)")
    f32 = dict(dtype=torch.float32, device=q.device)
    attended = torch.empty_like(q)
    colmean = torch.empty(B, N, **f32)
    diag = torch.empty(B, N, **f32)
    rowmax = torch.empty(B, N, **f32)
    # row statistics and, in float32, the scores the attend pass reads back
    scratch = torch.empty(lib.caim_focal_scratch_floats(code, B, N), **f32)
    partial = torch.empty(B, -(-N // q_tile), N, **f32)  # colsum per q tile
    with torch.cuda.device(q.device):
        err = lib.caim_focal_attention(
            ptr(q), ptr(k), ptr(v), ptr(attended), ptr(colmean), ptr(diag),
            ptr(rowmax), ptr(scratch), ptr(partial), B, N, D, 1.0 / float(scale),
            code, stream_of(q))
    _build.check(err)
    focal_attention_fused.launches += 1
    return attended, colmean, diag, rowmax


focal_attention_fused.launches = 0
