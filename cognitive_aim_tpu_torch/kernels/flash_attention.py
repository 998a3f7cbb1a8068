"""K1, K7, K8, K9, K10, K10b, K11: multi-head attention for the ViT backbone.

Counterparts, in cognitive_aim_tpu/kernels/flash_attention.py, of

  K1   ``flash_attention_packed``            softmax(q k^T * scale) v per head
  K7   ``flash_attention_packed_bias``       K1 with a per-key logit bias row
  K10  ``flash_attention_packed_i8qk``       the first product in int8, on q
                                             and k quantised per row
  K10b ``flash_attention_packed_i8qk_bias``  K10 with the bias row of K7
  K9   ``flash_attention_packed(..., int8_dots=True)``: an int8 first product
       on q and k quantised per (row, head), over the head's 64 values (inside
       the TPU kernel; here by ``quantize_heads``, one launch, before the
       attention kernel); also under its own name,
       ``flash_attention_packed_int8``
  K11  ``flash_attention_packed_out_res``    K1, then the int8 attn_out
       projection of the f32 context, LayerScale and the residual add, in
       one kernel

all on the packed [B, N, H*64] layout of the projections, and

  K8   ``flash_attention``                   the same function on [B, N, H, 64]
                                             operands (``attn_impl="pallas"``)

whose kernel takes each operand's batch, token and head strides, so it reads
separately projected tensors and the column slices of one fused projection
alike, without a copy. The kernels are CUDA C++: K1, K7, K8, K10, K10b and K9
launch one attention program, ``csrc/flash_wgmma.cu`` (K10, K10b and K9 its
int8 instantiation, K9 with one scale a (row, head)), from the C entries of
``csrc/flash_attention_packed.cu`` (K1, K7), ``csrc/flash_attention.cu``
(K8) and ``csrc/flash_attention_i8qk.cu`` (K10, K10b, K9); K11 is its
OUT_RES instantiation, a thread-block cluster over the heads of a 64-row
tile, launched from ``csrc/flash_attention_out_res.cu``. Beside each wrapper stands its
plain PyTorch version, which mirrors the JAX package's ``_packed_reference``
and ``_packed_reference_bias`` for K1 and K7, ``attention_reference`` for K8,
and repeats the kernel body's arithmetic for K10, K10b and K9 (an exact
integer product, ``s32 * sq * sk`` with the softmax scale folded into ``sq``,
f32 softmax, P cast to v's dtype), and likewise for K11. No model of either
package calls K9 or K11.

``quantize_rows`` is the joint-row symmetric quantisation that K10 and K10b
read. The JAX package runs it outside its Pallas kernel; here CUDA rows go
through the int8 block's quantising prologue (``quant_rows_pair_kernel`` of
``csrc/int8_block.cu``, the arithmetic of ``quant_rows_kernel<false>`` on one
tensor or on q and k together in one launch; contiguous bfloat16 rows up to
1024 wide), CPU rows through plain PyTorch with the same f32 arithmetic.
``quantize_heads`` is K9's: the same arithmetic on each head's 64 values
(``quant_heads_pair_kernel``), scales [B, H, N].

Each wrapper calls the op ``caim::<its name>`` (``_library``), whose
implementation dispatches on the tensor's device: CPU tensors take the plain
version, CUDA tensors launch the kernel or raise. Each wrapper's
``.launches`` counts its kernel launches (never plain-version calls); the
op's implementation adds to it, so a loaded ``torch.export`` program counts.

Autograd (``_grad.py``, the JAX package's ``custom_vjp`` rules): K1 (K9 as
``int8_dots``), K7, K10 and K10b are differentiable; their backward
recomputes the float plain version of K1 or K7 from the saved inputs (for
K10, K10b and K9 straight through the quantisation). A forward under
per-block recompute runs, and counts, the kernel again. K8, K11,
``quantize_rows`` and ``quantize_heads`` have no backward in either package
and raise when grad is enabled and an input requires it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import ctypes

import torch

from cognitive_aim_tpu_torch.kernels import _build
from cognitive_aim_tpu_torch.kernels._grad import forbid_grad, recompute_vjp
from cognitive_aim_tpu_torch.kernels._launch import (
    DTYPE_CODES,
    check_cuda_inputs,
    ptr,
    require_device,
    stream_of,
)
from cognitive_aim_tpu_torch.kernels._library import kernel_op
from cognitive_aim_tpu_torch.kernels.int8_block import _check_vec as check_channel_vector
from cognitive_aim_tpu_torch.kernels.int8_ops import int_matmul, quantize_activations

HEAD_DIM = 64  # the kernels' head width (ViT-B and ViT-L both use 64)
MAX_QUANT_WIDTH = 1024  # widest row the quantising kernel keeps in registers


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, N, HD = t.shape
    return t.reshape(B, N, num_heads, HD // num_heads).transpose(1, 2)


def _attend(scores: torch.Tensor, v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, H, N, N] scores -> [B, N, H*Dh]: f32 softmax, P cast to v's dtype,
    P V in v's dtype."""
    B, N, HD = v.shape
    probs = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    out = torch.matmul(probs, _heads(v, num_heads))  # [B, H, N, D]
    return out.transpose(1, 2).reshape(B, N, HD)


# ---------------------------------------------------------- plain versions ----
def flash_attention_packed_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 scale: float, num_heads: int) -> torch.Tensor:
    """[B, N, H*Dh] -> [B, N, H*Dh]: per head softmax(q k^T * scale) v with
    the scores in the input dtype, an f32 softmax, and the probabilities cast
    back to the input dtype before the PV product (``_packed_reference``)."""
    scores = torch.matmul(_heads(q, num_heads),
                          _heads(k, num_heads).transpose(-1, -2)) * scale
    return _attend(scores, v, num_heads)


def flash_attention_packed_bias_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                      k_bias: torch.Tensor, scale: float,
                                      num_heads: int) -> torch.Tensor:
    """K1's plain version with ``k_bias`` [B, N] added, in the scores' dtype,
    to every query row's scores of its batch (``_packed_reference_bias``)."""
    scores = torch.matmul(_heads(q, num_heads),
                          _heads(k, num_heads).transpose(-1, -2)) * scale
    scores = scores + k_bias[:, None, None, :].to(scores.dtype)
    return _attend(scores, v, num_heads)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """K8's plain version. [B, N, H, Dh] -> [B, N, H, Dh]: scores in the
    input dtype, f32 softmax, P cast to q's dtype, P V in that dtype."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    scores = torch.matmul(qt, kt.transpose(-1, -2)) * scale
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.matmul(probs, vt).transpose(1, 2)


def _quantize_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    # a tensor divisor on x's device: by a Python scalar PyTorch's CUDA
    # division multiplies by the rounded 1/127, which is not a true division
    s = (xf.abs().amax(dim=-1, keepdim=True) / xf.new_full((1,), 127.0)).clamp(min=1e-12)
    return torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8), s


def quantize_rows_plain(x: torch.Tensor, y: Optional[torch.Tensor] = None):
    """``quantize_rows``'s plain version: (x8, sx), or with ``y`` (x8, sx,
    y8, sy), each tensor quantised on its own rows."""
    if y is None:
        return _quantize_plain(x)
    return (*_quantize_plain(x), *_quantize_plain(y))


def quantize_heads_plain(x: torch.Tensor, num_heads: int, y: Optional[torch.Tensor] = None):
    """``quantize_heads``'s plain version: [B, N, H*Dh] -> (int8 [B, N, H*Dh],
    f32 scales [B, H, N]), each head's Dh values of a row quantised on their
    own (``_quantize_plain`` on the [B, N, H, Dh] view), the scales head-major
    as the kernel writes them; with ``y`` (x8, sx, y8, sy)."""
    def one(t):
        B, N, HD = t.shape
        t8, s = _quantize_plain(t.reshape(B, N, num_heads, HD // num_heads))
        return t8.reshape(B, N, HD), s.squeeze(-1).transpose(1, 2).contiguous()

    return one(x) if y is None else (*one(x), *one(y))


def _i8qk_attend_plain(q8, sq, k8, sk, v, k_bias, scale, num_heads, head_scales=False):
    """The int8 attention program's arithmetic on quantised q8, k8 [B, N, H*Dh]
    with f32 scales [B, N, 1] (one a row: K10, K10b) or, ``head_scales``,
    [B, H, N] (one a (row, head): K9): an exact integer q k^T per head,
    ``s32 * (sq * scale) * sk``, the bias, f32 softmax, P cast to v's dtype,
    P V in v's dtype."""
    # 64 products of at most 127^2 sum below 2^24: the f32 product is exact
    s32 = torch.matmul(_heads(q8.float(), num_heads),
                       _heads(k8.float(), num_heads).transpose(-1, -2))  # [B, H, N, N]
    # the softmax scale folded into the query scales: [B, 1 or H, N, 1] and
    # [B, 1 or H, 1, N]
    if not head_scales:
        sq, sk = sq.transpose(1, 2), sk.transpose(1, 2)  # [B, 1, N]
    s = s32 * (sq * scale)[..., None] * sk[:, :, None, :]
    if k_bias is not None:
        s = s + k_bias[:, None, None, :].float()
    return _attend(s, v, num_heads)


def _i8qk_plain(q, k, v, k_bias, scale, num_heads):
    return _i8qk_attend_plain(*quantize_rows_plain(q, k), v, k_bias, scale, num_heads)


def flash_attention_packed_i8qk_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                      scale: float, num_heads: int) -> torch.Tensor:
    """The arithmetic of ``_flash_packed_i8qk_kernel``: q and k quantised per
    row over all heads, an exact integer q k^T per head, ``s32 * sq * sk`` in
    f32, f32 softmax, P cast to v's dtype, P V in v's dtype."""
    return _i8qk_plain(q, k, v, None, scale, num_heads)


def flash_attention_packed_i8qk_bias_plain(q: torch.Tensor, k: torch.Tensor,
                                           v: torch.Tensor, k_bias: torch.Tensor,
                                           scale: float, num_heads: int) -> torch.Tensor:
    """``flash_attention_packed_i8qk_plain`` with the f32 bias row [B, N]
    added to the dequantised scores (``_flash_packed_i8qk_bias_kernel``)."""
    return _i8qk_plain(q, k, v, k_bias, scale, num_heads)


def flash_attention_packed_int8_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                      scale: float, num_heads: int) -> torch.Tensor:
    """The arithmetic of ``_flash_packed_int8_kernel``, decomposed as the CUDA
    wrapper runs it: q and k quantised per (row, head) over the head's values
    (``quantize_heads_plain``: a true division), then K10's arithmetic on
    those scales: an exact integer q k^T, ``s32 * (sq * scale) * sk`` in f32,
    f32 softmax, P cast to v's dtype, P V in v's dtype."""
    return _i8qk_attend_plain(*quantize_heads_plain(q, num_heads, k), v, None, scale,
                              num_heads, head_scales=True)


def attention_context_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                          num_heads: int) -> torch.Tensor:
    """[B, N, H*Dh] f32: K1's attention with both products accumulated in f32
    and the context left unrounded; P passes through v's dtype, as in the
    kernels."""
    B, N, HD = v.shape
    scores = torch.matmul(_heads(q.float(), num_heads),
                          _heads(k.float(), num_heads).transpose(-1, -2)) * scale
    probs = torch.softmax(scores, dim=-1).to(v.dtype).float()
    ctx = torch.matmul(probs, _heads(v.float(), num_heads))
    return ctx.transpose(1, 2).reshape(B, N, HD)


def flash_attention_packed_out_res_plain(q, k, v, wq, ws, b, ls, res, scale: float,
                                         num_heads: int) -> torch.Tensor:
    """The arithmetic of ``_flash_packed_out_res_kernel``: the f32 context of
    all heads, quantised per row over the whole width, an exact integer
    product with the attn_out weight ``wq`` (int8 [HD, HD], rows the output
    channels), ``acc * sc * ws + b``, ``res + ls * y`` in f32, one cast."""
    c8, sc = quantize_activations(attention_context_f32(q, k, v, scale, num_heads))
    y = int_matmul(c8, wq).float() * sc * ws.float() + b.float()
    return (res.float() + ls.float() * y).to(res.dtype)


# ---------------------------------------------------------- CUDA plumbing ----
def _check_width(name: str, HD: int, num_heads: int):
    if HD != num_heads * HEAD_DIM:
        raise ValueError(f"{name}: width {HD} is not {num_heads} heads of {HEAD_DIM}")


def _check_bias(name: str, q: torch.Tensor, k_bias: torch.Tensor) -> torch.Tensor:
    """The kernels read the bias row as contiguous f32 [B, N] on q's device."""
    B, N, _ = q.shape
    if tuple(k_bias.shape) != (B, N) or k_bias.device != q.device:
        raise ValueError(f"{name}: k_bias must be [{B}, {N}] on {q.device}, got "
                         f"{tuple(k_bias.shape)} on {k_bias.device}")
    return k_bias.float().contiguous()


def _launch_packed(name, q, k, v, k_bias, scale, num_heads):
    B, N, HD = q.shape
    _check_width(name, HD, num_heads)
    code = check_cuda_inputs(name, (q, k, v), (B, N, HD))
    bias = _check_bias(name, q, k_bias) if k_bias is not None else None
    lib = _build.library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.caim_flash_attention_packed(
            ptr(q), ptr(k), ptr(v), ptr(bias) if bias is not None else None, ptr(out),
            B, N, num_heads, HEAD_DIM, float(scale), code, stream_of(q))
    _build.check(err)
    return out


def _launch_i8qk(name, q, k, v, k_bias, scale, num_heads):
    B, N, HD = q.shape
    _check_width(name, HD, num_heads)
    if v.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bfloat16 q, k, v, got {v.dtype}")
    check_cuda_inputs(name, (q, k, v), (B, N, HD))
    bias = _check_bias(name, q, k_bias) if k_bias is not None else None
    q8, sq, k8, sk = quantize_rows(q, k)  # one launch; scales [B, N, 1]
    return _launch_i8qk_kernel(q8, sq, k8, sk, v, bias, scale, num_heads)


def _launch_i8qk_kernel(q8, sq, k8, sk, v, bias, scale, num_heads, head_scales=False):
    """The int8 attention kernel alone on quantised q8, k8 (int8 [B, N, H*64])
    with their f32 scales, v bf16: K10 / K10b on row scales [B, N, 1] (bias
    None or contiguous f32 [B, N]), the wrappers' launch after
    ``quantize_rows``; ``head_scales``: K9 on (row, head) scales [B, H, N]
    (no bias), after ``quantize_heads``."""
    B, N, _ = q8.shape
    lib = _build.library()
    out = torch.empty_like(v)
    with torch.cuda.device(q8.device):  # the kernel folds scale into sq
        if not head_scales:
            err = lib.caim_flash_attention_i8qk(
                ptr(q8), ptr(sq), ptr(k8), ptr(sk), ptr(v),
                ptr(bias) if bias is not None else None, ptr(out), B, N, num_heads,
                HEAD_DIM, float(scale), stream_of(q8))
        else:
            err = lib.caim_flash_attention_i8qk_heads(
                ptr(q8), ptr(sq), ptr(k8), ptr(sk), ptr(v), ptr(out), B, N, num_heads,
                HEAD_DIM, float(scale), stream_of(q8))
    _build.check(err)
    return out


# ------------------------------------------------------------------- ops ----
# Each op's implementation: CPU -> plain version; CUDA -> the kernel or raise,
# counted on the wrapper. Fakes: shapes and dtypes, contiguous (``_library``).
def _like_v(q, k, v, *rest):
    return v.new_empty(v.shape)


@kernel_op("flash_attention_packed", _like_v)
def _k1_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
           num_heads: int) -> torch.Tensor:
    require_device("flash_attention_packed", q)
    if q.device.type == "cpu":
        return flash_attention_packed_plain(q, k, v, scale, num_heads)
    out = _launch_packed("flash_attention_packed", q, k, v, None, scale, num_heads)
    flash_attention_packed.launches += 1
    return out


@kernel_op("flash_attention_packed_bias", _like_v)
def _k7_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_bias: torch.Tensor,
           scale: float, num_heads: int) -> torch.Tensor:
    require_device("flash_attention_packed_bias", q)
    if q.device.type == "cpu":
        return flash_attention_packed_bias_plain(q, k, v, k_bias, scale, num_heads)
    out = _launch_packed("flash_attention_packed_bias", q, k, v, k_bias, scale,
                         num_heads)
    flash_attention_packed_bias.launches += 1
    return out


@kernel_op("flash_attention_packed_int8", _like_v)
def _k9_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
           num_heads: int) -> torch.Tensor:
    name = "flash_attention_packed_int8"
    require_device(name, q)
    if q.device.type == "cpu":
        return flash_attention_packed_int8_plain(q, k, v, scale, num_heads)
    B, N, HD = q.shape
    _check_width(name, HD, num_heads)
    if q.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bfloat16 q, k, v, got {q.dtype}")
    check_cuda_inputs(name, (q, k, v), (B, N, HD))
    q8, sq, k8, sk = quantize_heads(q, num_heads, k)  # one launch; scales [B, H, N]
    out = _launch_i8qk_kernel(q8, sq, k8, sk, v, None, scale, num_heads, head_scales=True)
    flash_attention_packed_int8.launches += 1
    return out


@kernel_op("flash_attention_packed_i8qk", _like_v)
def _k10_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
            num_heads: int) -> torch.Tensor:
    require_device("flash_attention_packed_i8qk", q)
    if q.device.type == "cpu":
        return flash_attention_packed_i8qk_plain(q, k, v, scale, num_heads)
    out = _launch_i8qk("flash_attention_packed_i8qk", q, k, v, None, scale, num_heads)
    flash_attention_packed_i8qk.launches += 1
    return out


@kernel_op("flash_attention_packed_i8qk_bias", _like_v)
def _k10b_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_bias: torch.Tensor,
             scale: float, num_heads: int) -> torch.Tensor:
    require_device("flash_attention_packed_i8qk_bias", q)
    if q.device.type == "cpu":
        return flash_attention_packed_i8qk_bias_plain(q, k, v, k_bias, scale, num_heads)
    out = _launch_i8qk("flash_attention_packed_i8qk_bias", q, k, v, k_bias, scale,
                       num_heads)
    flash_attention_packed_i8qk_bias.launches += 1
    return out


def _k11_fake(q, k, v, wq, ws, b, ls, res, scale, num_heads, return_quantised):
    out = [res.new_empty(res.shape)]
    if return_quantised:
        out += [q.new_empty(q.shape, dtype=torch.int8),
                q.new_empty((*q.shape[:-1], 1), dtype=torch.float32)]
    return out


@kernel_op("flash_attention_packed_out_res", _k11_fake)
def _k11_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, wq: torch.Tensor,
            ws: torch.Tensor, b: torch.Tensor, ls: torch.Tensor, res: torch.Tensor,
            scale: float, num_heads: int, return_quantised: bool) -> List[torch.Tensor]:
    name = "flash_attention_packed_out_res"
    require_device(name, q)
    if q.device.type == "cpu":
        out = flash_attention_packed_out_res_plain(q, k, v, wq, ws, b, ls, res, scale,
                                                   num_heads)
        if return_quantised:
            return [out, *quantize_activations(
                attention_context_f32(q, k, v, scale, num_heads))]
        return [out]
    B, N, HD = q.shape
    _check_out_res(name, HD, num_heads, scale)
    if q.dtype != torch.bfloat16 or res.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bfloat16 q, k, v, res, got "
                        f"{q.dtype} and {res.dtype}")
    check_cuda_inputs(name, (q, k, v, res), (B, N, HD))
    if (wq.dtype != torch.int8 or tuple(wq.shape) != (HD, HD) or not wq.is_contiguous()
            or wq.data_ptr() % 16 or wq.device != q.device):
        raise ValueError(f"{name}: the attn_out weight must be contiguous int8 [{HD}, {HD}] "
                         f"on {q.device}")
    for vec in (ws, b, ls):
        check_channel_vector(name, q, vec, HD)
    out = torch.empty_like(res)
    ctx8 = torch.empty(B, N, HD, dtype=torch.int8, device=q.device)
    sc = torch.empty(B, N, 1, dtype=torch.float32, device=q.device) if return_quantised else None
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.caim_flash_attention_out_res(
            ptr(q), ptr(k), ptr(v), ptr(wq), ptr(ws), ptr(b), ptr(ls), ptr(res), ptr(out),
            ptr(ctx8), ptr(sc) if return_quantised else None, B, N, num_heads, HEAD_DIM,
            float(scale), stream_of(q))
    _build.check(err)
    flash_attention_packed_out_res.launches += 1
    return [out, ctx8, sc] if return_quantised else [out]


def _k8_fake(q, k, v, scale):
    return q.new_empty(q.shape)


@kernel_op("flash_attention", _k8_fake)
def _k8_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    require_device("flash_attention", q)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale).contiguous()
    name = "flash_attention"
    if q.ndim != 4 or q.shape[-1] != HEAD_DIM:
        raise ValueError(f"{name}: operands must be [B, N, H, {HEAD_DIM}], got "
                         f"{tuple(q.shape)}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported (float32 or bfloat16)")
    for t in (q, k, v):
        _check_head_operand(name, t, q)
    B, N, H, _ = q.shape
    out = torch.empty(B, N, H, HEAD_DIM, dtype=q.dtype, device=q.device)
    strides = [(ctypes.c_longlong * 3)(*t.stride()[:3]) for t in (q, k, v)]
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.caim_flash_attention(
            ptr(q), ptr(k), ptr(v), ptr(out), *strides, B, N, H, HEAD_DIM, float(scale),
            DTYPE_CODES[q.dtype], stream_of(q))
    _build.check(err)
    flash_attention.launches += 1
    return out


def _q_fake(x, y):
    out = []
    for t in (x, y) if y is not None else (x,):
        out += [t.new_empty(t.shape, dtype=torch.int8),
                t.new_empty((*t.shape[:-1], 1), dtype=torch.float32)]
    return out


@kernel_op("quantize_rows", _q_fake)
def _q_op(x: torch.Tensor, y: Optional[torch.Tensor]) -> List[torch.Tensor]:
    require_device("quantize_rows", x)
    if x.device.type == "cpu":
        return list(quantize_rows_plain(x, y))
    B, N, HD = x.shape
    if x.dtype != torch.bfloat16:
        raise TypeError(f"quantize_rows: the CUDA kernel takes bfloat16, got {x.dtype}")
    if HD % 8 or HD > MAX_QUANT_WIDTH:
        raise ValueError(f"quantize_rows: width {HD} is not a multiple of 8 up to "
                         f"{MAX_QUANT_WIDTH}")
    check_cuda_inputs("quantize_rows", (x,) if y is None else (x, y), (B, N, HD))
    # separate tensors: a view of a stacked one costs the host more than an
    # allocation
    out = [torch.empty(B, N, HD, dtype=torch.int8, device=x.device),
           torch.empty(B, N, 1, dtype=torch.float32, device=x.device)]
    if y is not None:
        out += [torch.empty_like(out[0]), torch.empty_like(out[1])]
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.caim_quantize_rows(ptr(x), ptr(y) if y is not None else None, ptr(out[0]),
                                     ptr(out[-2]), ptr(out[1]), ptr(out[-1]), B * N, HD,
                                     stream_of(x))
    _build.check(err)
    quantize_rows.launches += 1
    return out


def _qh_fake(x, num_heads, y):
    out = []
    for t in (x, y) if y is not None else (x,):
        B, N, _ = t.shape
        out += [t.new_empty(t.shape, dtype=torch.int8),
                t.new_empty((B, num_heads, N), dtype=torch.float32)]
    return out


@kernel_op("quantize_heads", _qh_fake)
def _qh_op(x: torch.Tensor, num_heads: int, y: Optional[torch.Tensor]) -> List[torch.Tensor]:
    name = "quantize_heads"
    require_device(name, x)
    if x.device.type == "cpu":
        return list(quantize_heads_plain(x, num_heads, y))
    B, N, HD = x.shape
    _check_width(name, HD, num_heads)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got {x.dtype}")
    if HD > MAX_QUANT_WIDTH:
        raise ValueError(f"{name}: width {HD} is over {MAX_QUANT_WIDTH}")
    check_cuda_inputs(name, (x,) if y is None else (x, y), (B, N, HD))
    out = [torch.empty(B, N, HD, dtype=torch.int8, device=x.device),
           torch.empty(B, num_heads, N, dtype=torch.float32, device=x.device)]
    if y is not None:
        out += [torch.empty_like(out[0]), torch.empty_like(out[1])]
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.caim_quantize_heads(ptr(x), ptr(y) if y is not None else None, ptr(out[0]),
                                      ptr(out[-2]), ptr(out[1]), ptr(out[-1]), B, N, HD,
                                      stream_of(x))
    _build.check(err)
    quantize_heads.launches += 1
    return out


# ---------------------------------------------------------------- wrappers ----
def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float, num_heads: int, q_block: int = 0,
                           int8_dots: bool = False) -> torch.Tensor:
    """K1. q, k, v: [B, N, H*64] packed activations -> [B, N, H*64] in q's
    dtype (bfloat16 or float32). CPU -> plain version; CUDA -> the kernel.
    ``int8_dots=True`` is K9, ``flash_attention_packed_int8``, which counts
    its own launches. ``q_block`` is the JAX signature's query block of the
    TPU grid; the CUDA kernels' tile is fixed and the value is not read.
    Differentiable in q, k, v (``_grad.recompute_vjp``): the backward
    recomputes the float plain version, with ``int8_dots`` too, straight
    through the quantisation."""
    fwd = _k9_op if int8_dots else _k1_op
    return recompute_vjp(fwd, flash_attention_packed_plain, 3, q, k, v, scale, num_heads)


def flash_attention_packed_bias(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                k_bias: torch.Tensor, scale: float,
                                num_heads: int) -> torch.Tensor:
    """K7. K1 with ``k_bias`` [B, N] (read as f32) added to the logits of
    every query row: proportional attention for the token filter, where a
    fused context token gets +log(number of tokens it stands for).
    Differentiable in q, k, v and k_bias, through the plain version."""
    return recompute_vjp(_k7_op, flash_attention_packed_bias_plain, 4,
                         q, k, v, k_bias, scale, num_heads)


def flash_attention_packed_int8(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                scale: float, num_heads: int) -> torch.Tensor:
    """K9. Packed attention whose q k^T runs in int8 on q and k quantised
    per (row, head); P V stays in v's dtype. CUDA: bfloat16 [B, N, H*64] in
    and out; q and k quantised once, in one launch (``quantize_heads``), then
    the int8 attention program of K10 on (row, head) scales. Differentiable
    as ``flash_attention_packed(..., int8_dots=True)``: through the float
    plain version of K1."""
    return recompute_vjp(_k9_op, flash_attention_packed_plain, 3, q, k, v, scale,
                         num_heads)


OUT_RES_MAX_HEADS = 16  # K11: one CTA a head in a cluster; the card takes 16 at most


def out_res_cluster_size(num_heads: int) -> int:
    """The CTAs of K11's thread-block cluster at ``num_heads`` heads (one a
    head of a 64-row tile), 0 where the kernel takes no such count: the rule
    of ``caim_out_res_cluster_size`` (a card test holds the two equal)."""
    return num_heads if 1 <= num_heads <= OUT_RES_MAX_HEADS else 0


def _check_out_res(name: str, HD: int, num_heads: int, scale: float):
    """What K11's kernel takes: ``num_heads`` heads of 64, 1 to 16 (a cluster
    of one CTA a head), and a positive scale. Raises ValueError otherwise."""
    _check_width(name, HD, num_heads)
    if out_res_cluster_size(num_heads) == 0:
        raise ValueError(f"{name}: the CUDA kernel takes 1 to {OUT_RES_MAX_HEADS} heads (a "
                         f"cluster of one CTA a head), got {num_heads}")
    if not scale > 0:
        raise ValueError(f"{name}: the CUDA kernel takes a positive scale, got {scale}")


def flash_attention_packed_out_res(q, k, v, wq, ws, b, ls, res, scale: float,
                                   num_heads: int, q_block: int = 0,
                                   return_quantised: bool = False):
    """K11. ``res + ls * attn_out(attention(q, k, v))`` in one kernel: the
    attention context stays f32 on chip, is quantised per row and goes
    through the int8 attn_out weight ``wq`` (int8 [HD, HD], rows the output
    channels; ``ws``, ``b``, ``ls`` f32 [HD]). q, k, v, res [B, N, H*64] ->
    [B, N, H*64] in res's dtype. CUDA: bfloat16, 1 to 16 heads
    (``out_res_cluster_size``), a positive scale; one device kernel a call,
    whose CTAs share the int8 context through a scratch ``ctx8``. ``q_block``
    as in ``flash_attention_packed``. ``return_quantised`` also returns the
    int8 context [B, N, HD] and its f32 row scales [B, N, 1], for checks."""
    forbid_grad("flash_attention_packed_out_res", q, k, v, wq, ws, b, ls, res)
    out = _k11_op(q, k, v, wq, ws, b, ls, res, scale, num_heads, return_quantised)
    return tuple(out) if return_quantised else out[0]


def _check_head_operand(name: str, t: torch.Tensor, like: torch.Tensor):
    """K8 reads rows of 64 contiguous values at strides that keep every row
    16-byte aligned; anything else raises (no copy is made for the caller)."""
    vec = 16 // t.element_size()
    if t.shape != like.shape or t.dtype != like.dtype or t.device != like.device:
        raise ValueError(f"{name}: q, k, v differ in shape, dtype or device")
    if t.stride(3) != 1 or any(st % vec for st in t.stride()[:3]) or t.data_ptr() % 16:
        raise ValueError(f"{name}: operands need a contiguous last dimension and 16-byte "
                         f"aligned rows, got strides {t.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """K8. q, k, v: [B, N, H, 64], bfloat16 or float32, contiguous or strided
    views (a reshaped packed projection, a column slice of a fused one) ->
    a contiguous [B, N, H, 64] in q's dtype. CPU -> ``attention_reference``;
    CUDA -> the kernel, which addresses the operands in place. No backward,
    as in the JAX package: raises under grad."""
    forbid_grad("flash_attention", q, k, v)
    return _k8_op(q, k, v, scale)


def quantize_rows(x: torch.Tensor, y: Optional[torch.Tensor] = None):
    """[B, N, HD] -> (int8 [B, N, HD], f32 scales [B, N, 1]): symmetric per
    row, joint across heads; ``s = max(max|x| / 127, 1e-12)``, a true
    division, round-half-even, clip to +-127, all in f32. With ``y`` (the
    shape of x) -> (x8, sx, y8, sy), both quantised in one launch, as K10
    does q and k. CPU -> plain version; CUDA -> the kernel (bfloat16, width a
    multiple of 8 up to 1024)."""
    forbid_grad("quantize_rows", x, y)
    return tuple(_q_op(x, y))


def quantize_heads(x: torch.Tensor, num_heads: int, y: Optional[torch.Tensor] = None):
    """[B, N, H*64] -> (int8 [B, N, H*64], f32 scales [B, H, N], head-major):
    symmetric per (row, head) over the head's 64 values, ``quantize_rows``'
    arithmetic on each head's slice; with ``y`` (the shape of x) -> (x8, sx, y8, sy) in
    one launch, as K9 does q and k. CPU -> plain version; CUDA -> the kernel
    (bfloat16, width up to 1024)."""
    forbid_grad("quantize_heads", x, y)
    return tuple(_qh_op(x, num_heads, y))


def flash_attention_packed_i8qk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                scale: float, num_heads: int) -> torch.Tensor:
    """K10. Packed attention with an int8 q k^T: float q, k, v in, v's dtype
    out. q and k are quantised here (``quantize_rows``); the kernel reads
    int8 and dequantises its int32 scores with the row scales. CUDA: bf16.
    Differentiable in q, k, v through K1's FLOAT plain version, straight
    through the quantisation (the int8 plain version's own autograd would
    give zero gradients through ``round``)."""
    return recompute_vjp(_k10_op, flash_attention_packed_plain, 3, q, k, v, scale,
                         num_heads)


def flash_attention_packed_i8qk_bias(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                     k_bias: torch.Tensor, scale: float,
                                     num_heads: int) -> torch.Tensor:
    """K10b. K10 with the bias row of K7 added to the dequantised scores.
    Differentiable in q, k, v and k_bias through K7's float plain version."""
    return recompute_vjp(_k10b_op, flash_attention_packed_bias_plain, 4,
                         q, k, v, k_bias, scale, num_heads)


WRAPPERS = (flash_attention_packed, flash_attention_packed_bias,
            flash_attention_packed_i8qk, flash_attention_packed_i8qk_bias,
            quantize_rows, flash_attention, flash_attention_packed_int8,
            flash_attention_packed_out_res, quantize_heads)
for _w in WRAPPERS:
    _w.launches = 0
