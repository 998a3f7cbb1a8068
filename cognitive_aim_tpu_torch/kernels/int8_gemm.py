"""K15: the fused int8 GEMM on flattened rows.

Counterpart of cognitive_aim_tpu/kernels/int8_gemm.py, with its names:

  ``int8_gemm_fused(x, wq, ws, b)``    x [M, K] -> [M, N]: dynamic per-row
      quantisation of x, int8 GEMM, ``acc * s_x * s_w + b``, one cast;
  ``int8_linear_fused(x, wq, b)``      the same for any leading dimensions,
      the weight as ``{"q": int8 [N, K], "s": f32 [N]}``, output in x's dtype.

The unchained int8 block (nn/dinov2.py) projects q, k and v through
``int8_linear_fused`` on the fused [3D, D] weight, as the JAX package's
``_mhsa`` does. The kernel is CUDA C++ in ``csrc/int8_block.cu``: the
quantising prologue and the GEMM program of K2, K3, K4b and K5 with an
epilogue that writes the rows unsplit. Its plain version repeats the TPU
kernel body's arithmetic (``s = max(max|x| / 127, 1e-12)``,
``q = clip(round_half_even(x / s))``, an exact integer product, the
dequantisation in f32).

The wrapper calls the op ``caim::int8_gemm_fused`` (``_library``), whose
implementation dispatches on the tensor's device: CPU tensors take the plain
version, CUDA tensors launch the kernel or raise (bfloat16 rows, contiguous,
K a multiple of 128, N a width ``int8_block.gemm_tile_cols`` takes).
``int8_gemm_fused.launches`` counts kernel launches and nothing else;
``int8_linear_fused`` launches through it. No backward, as in the JAX
package: it raises when grad is enabled and an input requires it.
"""

from __future__ import annotations

import torch

from cognitive_aim_tpu_torch.kernels._grad import forbid_grad
from cognitive_aim_tpu_torch.kernels._launch import require_device
from cognitive_aim_tpu_torch.kernels._library import kernel_op
from cognitive_aim_tpu_torch.kernels.int8_block import (
    check_bf16_out,
    int8_proj_plain,
    launch_int8_linear,
)


int8_gemm_fused_plain = int8_proj_plain  # one function: K13's rows, flattened


def int8_linear_fused_plain(x, wq: dict, b, out_dtype=None):
    bias = b if b is not None else torch.zeros_like(wq["s"])
    return int8_proj_plain(x, wq["q"], wq["s"], bias, out_dtype or x.dtype)


def int8_gemm_fused(x, wq, ws, b, out_dtype=torch.bfloat16):
    """K15. x [M, K] float -> [M, N] ``out_dtype``; wq int8 [N, K], ws f32
    [N] scales, b f32 [N] bias."""
    forbid_grad("int8_gemm_fused", x, wq, ws, b)
    return _k15_op(x, wq, ws, b, out_dtype)


@kernel_op("int8_gemm_fused", lambda x, wq, ws, b, out_dtype: x.new_empty(
    (x.shape[0], wq.shape[0]), dtype=out_dtype))
def _k15_op(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor, b: torch.Tensor,
            out_dtype: torch.dtype) -> torch.Tensor:
    require_device("int8_gemm_fused", x)
    if x.device.type == "cpu":
        return int8_gemm_fused_plain(x, wq, ws, b, out_dtype)
    check_bf16_out("int8_gemm_fused", out_dtype)
    out = launch_int8_linear("int8_gemm_fused", "caim_int8_gemm_fused", x, wq, ws, b)
    int8_gemm_fused.launches += 1
    return out


def int8_linear_fused(x, wq: dict, b, out_dtype=None):
    """[..., K] -> [..., N] over ``int8_gemm_fused`` (leading dimensions
    flattened; a missing bias is zeros); output in x's dtype unless given."""
    out_dtype = out_dtype or x.dtype
    bias = b if b is not None else torch.zeros_like(wq["s"])
    lead, K = x.shape[:-1], x.shape[-1]
    y = int8_gemm_fused(x.reshape(-1, K), wq["q"], wq["s"], bias.float(), out_dtype)
    return y.reshape(*lead, -1)


WRAPPERS = (int8_gemm_fused,)
int8_gemm_fused.launches = 0
