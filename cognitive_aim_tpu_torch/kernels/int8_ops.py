"""Int8 quantised matmul scheme of the ViT backbone (counterpart of
cognitive_aim_tpu/kernels/int8_ops.py), in plain PyTorch.

  * weights: static per-output-channel symmetric int8
    (scale = max|w_row| / 127), quantised once at load time from the float32
    weights;
  * activations: dynamic per-row symmetric int8 (scale = max|x_row| / 127),
    quantised right before each matmul;
  * accumulation in int32, dequantised to f32 with s_x * s_w, bias in f32.

Weights keep PyTorch's ``[out, in]`` layout: int8 ``[N, K]`` with K
contiguous, which is the K-major B operand Hopper's int8 ``mma`` reads, so
no transpose happens at load. The JAX package stores ``[K, N]`` and scales
per column; the values are the same.

The integer product is exact everywhere: an int32 matmul on the CPU,
``torch._int_mm`` on a CUDA device (a float64 product where its shape rules
do not hold). It is never a float32 or bfloat16 matmul of the int8 values,
whose sums (up to 127^2 * 4096) exceed 2^24.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def quantize_weight(w: torch.Tensor) -> dict:
    """[N, K] float -> {'q': int8 [N, K], 's': f32 [N]} per-out-channel."""
    w = w.float()
    s = (w.abs().amax(dim=1) / 127.0).clamp(min=1e-12)
    q = torch.clamp(torch.round(w / s[:, None]), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def quantize_activations(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., K] -> (int8 [..., K], f32 scale [..., 1]) per-row dynamic:
    a true division and round-half-even, in f32."""
    xf = x.float()
    # a tensor divisor: by a Python scalar PyTorch's CUDA division multiplies
    # by the rounded 1/127, which is not the true division of the kernels
    s = (xf.abs().amax(dim=-1, keepdim=True) / xf.new_full((1,), 127.0)).clamp(min=1e-12)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def int_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 [..., K] x int8 [N, K] -> exact int32 [..., N]."""
    lead, K = xq.shape[:-1], xq.shape[-1]
    N = wq.shape[0]
    x2 = xq.reshape(-1, K)
    if xq.device.type == "cuda":
        M = x2.shape[0]
        if M > 16 and M % 8 == 0 and K % 8 == 0 and N % 8 == 0:
            acc = torch._int_mm(x2.contiguous(), wq.t())
        else:  # float64 holds these sums (< 2^53) exactly
            acc = (x2.double() @ wq.double().t()).to(torch.int32)
    else:
        acc = x2.to(torch.int32) @ wq.to(torch.int32).t()
    return acc.reshape(*lead, N)


def int8_matmul_prequant(xq: torch.Tensor, sx: torch.Tensor, wq: dict,
                         b: Optional[torch.Tensor], out_dtype) -> torch.Tensor:
    """int8 GEMM on pre-quantised activations: acc * s_x * s_w + b."""
    y = int_matmul(xq, wq["q"]).float() * sx * wq["s"]
    if b is not None:
        y = y + b.float()
    return y.to(out_dtype)


def int8_linear(x: torch.Tensor, wq: dict, b: Optional[torch.Tensor],
                out_dtype=None) -> torch.Tensor:
    """y = dequant(quant(x) @ wq^T) + b with int32 accumulation."""
    xq, sx = quantize_activations(x)
    return int8_matmul_prequant(xq, sx, wq, b, out_dtype or x.dtype)


def quantize_backbone_layers(layers: dict, fuse_qkv: bool = True) -> dict:
    """Stacked layer tree {'q': {'w': [L, N, K], 'b': [L, N]}, ...} -> the
    same tree with each dense weight replaced by 'wq': {'q': int8 [L, N, K],
    's': f32 [L, N]}. Biases, norms and LayerScales stay float.

    ``fuse_qkv`` also emits 'qkv_i8': the q, k, v weights concatenated along
    the output axis ([L, 3D, D]; per-output-channel scales concatenate
    exactly) with the concatenated bias, which the chained block
    (kernels/int8_block.py) runs as one GEMM."""

    def quant_stacked(w):  # [L, N, K]
        per = [quantize_weight(wl) for wl in w]
        return {"q": torch.stack([p["q"] for p in per]),
                "s": torch.stack([p["s"] for p in per])}

    out = dict(layers)
    if fuse_qkv and all(n in out for n in ("q", "k", "v")):
        wcat = torch.cat([out[n]["w"] for n in ("q", "k", "v")], dim=1)
        bcat = torch.cat([out[n]["b"] for n in ("q", "k", "v")], dim=-1)
        out["qkv_i8"] = {"wq": quant_stacked(wcat), "b": bcat}
    for name in ("q", "k", "v", "attn_out", "fc1", "fc2"):
        if name in out:
            lin = dict(out[name])
            lin["wq"] = quant_stacked(lin.pop("w"))
            out[name] = lin
    return out
