"""K2-K5, K12, K13, K14: the chained int8 transformer-block GEMMs, the focal
qkv GEMM, the fused post-attention half, and the two variants that no model
calls.

Counterpart of cognitive_aim_tpu/kernels/int8_block.py, with its names and
argument order:

  K2  int8_qkv_proj_ln            LN(f32) -> row quant -> int8 GEMM [D -> 3D]
                                  -> dequant + bias -> q, k, v
  K5  int8_qkv_proj               K2 without the layernorm
  K3  int8_out_residual           row quant -> int8 GEMM -> dequant + bias
                                  -> res + ls * y
  K4a int8_fc1_gelu_ln            LN -> row quant -> int8 GEMM [D -> F] ->
                                  dequant + bias -> tanh-GELU -> row requant
                                  over the whole F row -> int8 h + f32 scales
  K4b int8_out_residual_prequant  int8 h, scales -> int8 GEMM [F -> D] ->
                                  dequant + bias -> res + ls * y
  K4  int8_mlp_ln                 K4a then K4b: the whole MLP; the int8
                                  hidden and its scales make one trip
                                  through device memory
  K12 int8_attnout_mlp_ln         K3 then K4 with the post-attention residual
                                  carried in f32 between them and into the
                                  last add: one cast, at the end. The chained
                                  block takes it in place of K3 and K4 when
                                  the environment has ``CAIM_FUSE_AOMLP=1``
  K13 int8_proj                   row quant -> int8 GEMM [K -> Nout] ->
                                  dequant + bias, unsplit; rows of any width
  K14 int8_fc1_gelu               K4a without the layernorm

K13 and K14 have no caller in either package's models (the JAX package's
kernel tests use them); K15 (kernels/int8_gemm.py) is K13's function on
flattened rows and is what the unchained int8 block calls.

The kernels are CUDA C++ in ``csrc/int8_block.cu``. Beside each wrapper
stands its plain PyTorch version (``*_plain``), the JAX kernel body's
arithmetic line by line: f32 layernorm with the variance as the mean of
squared deviations, ``s = max(max|x| / 127, 1e-12)``,
``q = clip(round_half_even(x / s))``, an exact integer product
(``int8_ops.int_matmul``), ``acc * s_x * s_w + b`` and
``res + ls * y`` in f32, one cast at the end.

Weights are int8 ``[N, K]`` (PyTorch's [out, in], K contiguous) with f32
scales ``[N]``; biases, layernorm parameters and LayerScales are used in
f32, whatever type they arrive in.

Every GEMM but the fc1 GEMM of K4a and K14 is one program (persistent
CTAs, a TMA producer warp, two ``wgmma`` consumer warpgroups, outputs stored
by TMA) whose output tile is 128 rows by ``gemm_tile_cols`` columns. K12 is
one kernel of its own (``csrc/int8_fused_block.cu``): a thread-block cluster
owns a 64-row tile across all of its columns, from the ctx rows to the
output, at the widths of ``ATTNOUT_MLP_SHAPES``.

Each wrapper but K4's calls the op ``caim::<its name>`` (``_library``), whose
implementation dispatches on the tensor's device: CPU tensors take the plain
version; CUDA tensors launch the kernel or raise (bf16 activations,
contiguous, contraction depths that are multiples of 128, output widths that
a tile width divides: ``gemm_tile_cols``, ``fc1_cluster_shape``,
``attnout_mlp_shape``). K2's and K5's ops return q, k and v packed, one
[3, B, N, D] tensor (a custom op's outputs may not be views of one buffer),
and so do their plain versions; the wrappers unbind it. Each wrapper's
``.launches`` counts its kernel launches and nothing else, from inside its
op, so a loaded ``torch.export`` program counts too; ``int8_mlp_ln`` calls
the ops of K4a and K4b and counts its CUDA calls itself.

None of these kernels has a backward, in either package: each wrapper raises
when grad is enabled and an input requires it (``_grad.forbid_grad``), so the
int8 policy does not train.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import Tensor

from cognitive_aim_tpu_torch.kernels import _build
from cognitive_aim_tpu_torch.kernels._grad import forbid_grad
from cognitive_aim_tpu_torch.kernels._launch import ptr, require_device, stream_of
from cognitive_aim_tpu_torch.kernels._library import kernel_op
from cognitive_aim_tpu_torch.kernels.int8_ops import int_matmul, quantize_activations

TILE_K = 128  # contraction depth per pipeline stage (csrc/int8_block.cu: BK)
GEMM_TILE_COLS = (192, 128)  # widths of the GEMM's output tile, as the C list
GEMM_TILE_ROWS = 128  # rows of the GEMM's output tile (BM)
H100_SMS = 132  # SMs of an H100 SXM, where gemm_tile_cols is asked without a card
MAX_QUANT_K = 1024  # widest row the layernorm prologue keeps in registers; rows
#                     without a layernorm may be wider (a two-pass prologue)
FC1_WARPGROUP_COLS = (64, 192, 256)  # widths of the fc1 GEMM's wgmma, as the C list
FC1_MAX_CLUSTER = 8  # CTAs of a thread-block cluster (the portable limit)
# K12's instantiations, as csrc/int8_fused_block.cu AO_SHAPES: (model width K,
# hidden width F) -> (CTAs of the cluster, hidden columns of a warpgroup's
# sweep, sweeps a warpgroup makes of them)
ATTNOUT_MLP_SHAPES = {(768, 3072): (8, 192, 1), (1024, 4096): (8, 128, 2),
                      (128, 512): (2, 128, 1)}


def gemm_tile_cols(M: int, N: int, parts: int = 1, sms: int = H100_SMS):
    """Columns of the int8 GEMM's output tile for M rows and N output columns
    made of ``parts`` equal outputs (the qkv projections: 3, so that a tile
    lies within one of q, k, v) on a card of ``sms`` SMs, one CTA an SM: of
    the widths of GEMM_TILE_COLS that divide N / parts, the one whose tiles
    cost the least counted as ``ceil(tiles / sms) * BN`` (rounds of tiles
    times their width), the wider on a tie (csrc/int8_block.cu,
    gemm_tile_cols). At M 10960 on 132 SMs: 192 for the qkv GEMMs, 128 for
    N 768 and 3072; ViT-L's 1024 and 4096 take 128 only. None where no width
    divides N / parts: the wrappers raise there, whatever M and sms."""
    if M <= 0 or N <= 0 or parts <= 0 or N % parts or sms <= 0:
        return None
    row_tiles = -(-M // GEMM_TILE_ROWS)
    best = None
    for bn in GEMM_TILE_COLS:
        if (N // parts) % bn == 0:
            cost = -(-row_tiles * (N // bn) // sms) * bn
            if best is None or cost < best[0]:
                best = (cost, bn)
    return None if best is None else best[1]


def fc1_cluster_shape(F: int):
    """(CTAs of the cluster, columns of a CTA) of the one-pass fc1 GEMM of K4a
    and K14 at hidden width F: a cluster of C CTAs owns all F columns of
    a 64-row tile, each CTA 2 NW of them (a consumer warpgroup each NW), NW
    the narrowest width with C <= 8 (csrc/int8_block.cu, fc1_warpgroup_cols).
    None where no such cluster splits F evenly: the wrappers raise there."""
    for nw in FC1_WARPGROUP_COLS:
        if F > 0 and F % (2 * nw) == 0 and F // (2 * nw) <= FC1_MAX_CLUSTER:
            return F // (2 * nw), 2 * nw
    return None


def attnout_mlp_shape(K: int, F: int):
    """(CTAs of the cluster, hidden columns of a warpgroup's sweep, sweeps) of
    K12's one kernel at model width K and hidden width F: a cluster of C CTAs
    owns a 64-row tile, each CTA K / C model and F / C hidden columns
    (csrc/int8_fused_block.cu, ``caim_attnout_mlp_cluster_size``). ViT-B's
    (768, 3072), ViT-L's (1024, 4096) and the tests' (128, 512); None for any
    other pair: the wrapper raises there."""
    return ATTNOUT_MLP_SHAPES.get((K, F))


# ---------------------------------------------------- shared arithmetic ----
def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3)))


def _ln_f32(xf: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float):
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * g.float() + b.float()


def _dequant(acc, sx, ws, b):
    return acc.float() * sx * ws.float() + b.float()


# -------------------------------------------------------- plain versions ----
def int8_qkv_proj_plain(x, wq, ws, b, out_dtype=torch.bfloat16):
    """-> q, k, v packed as one contiguous [3, B, N, D], the kernel's layout
    (the wrapper unbinds it)."""
    xq, sx = quantize_activations(x.float())
    y = _dequant(int_matmul(xq, wq), sx, ws, b)
    return y.to(out_dtype).unflatten(-1, (3, x.shape[-1])).movedim(-2, 0).contiguous()


def int8_qkv_proj_ln_plain(x, g, be, wq, ws, b, eps=1e-6, out_dtype=torch.bfloat16):
    return int8_qkv_proj_plain(_ln_f32(x.float(), g, be, eps), wq, ws, b, out_dtype)


def int8_out_residual_plain(x, wq, ws, b, ls, res):
    xq, sx = quantize_activations(x.float())
    y = _dequant(int_matmul(xq, wq), sx, ws, b)
    return (res.float() + ls.float() * y).to(res.dtype)


def int8_fc1_gelu_ln_plain(x, g, be, wq, ws, b, eps=1e-6):
    return int8_fc1_gelu_plain(_ln_f32(x.float(), g, be, eps), wq, ws, b)


def int8_proj_plain(x, wq, ws, b, out_dtype=torch.bfloat16):
    xq, sx = quantize_activations(x.float())
    return _dequant(int_matmul(xq, wq), sx, ws, b).to(out_dtype)


def int8_fc1_gelu_plain(x, wq, ws, b):
    xq, sx = quantize_activations(x.float())
    return quantize_activations(_gelu_tanh(_dequant(int_matmul(xq, wq), sx, ws, b)))


def int8_out_residual_prequant_plain(h8, sh, wq, ws, b, ls, res):
    y = _dequant(int_matmul(h8, wq), sh, ws, b)
    return (res.float() + ls.float() * y).to(res.dtype)


def int8_mlp_ln_plain(x, g, be, w1q, w1s, b1, w2q, w2s, b2, ls, eps=1e-6):
    h8, sh = int8_fc1_gelu_ln_plain(x, g, be, w1q, w1s, b1, eps)
    return int8_out_residual_prequant_plain(h8, sh, w2q, w2s, b2, ls, x)


def int8_attnout_mlp_ln_plain(ctx, wo, so, bo, ls1, res, g, be, w1q, w1s, b1, w2q, w2s, b2,
                              ls2, eps=1e-6):
    """The body of the JAX package's ``_attnout_mlp_kernel``. Not
    ``int8_mlp_ln_plain(int8_out_residual_plain(...))``: that rounds the
    post-attention residual to the activation dtype between the halves; here
    ``xf`` stays f32 into the layernorm and into the last add."""
    cq, sc = quantize_activations(ctx.float())
    yo = _dequant(int_matmul(cq, wo), sc, so, bo)
    xf = res.float() + ls1.float() * yo
    xq, sx = quantize_activations(_ln_f32(xf, g, be, eps))
    hq, sh = quantize_activations(_gelu_tanh(_dequant(int_matmul(xq, w1q), sx, w1s, b1)))
    y = _dequant(int_matmul(hq, w2q), sh, w2s, b2)
    return (xf + ls2.float() * y).to(res.dtype)


# --------------------------------------------------------- CUDA plumbing ----
def _check_act(name, t, shape, dtype=torch.bfloat16):
    if t.dtype != dtype:
        raise TypeError(f"{name}: the CUDA kernel takes {dtype} activations, "
                        f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: activations must be contiguous and "
                         f"16-byte aligned")


def _check_weight(name, x, wq, ws, K):
    N = wq.shape[0]
    if wq.dtype != torch.int8 or tuple(wq.shape) != (N, K) \
            or not wq.is_contiguous() or wq.data_ptr() % 16 or wq.device != x.device:
        raise ValueError(f"{name}: weight must be contiguous int8 [N, {K}] on "
                         f"{x.device}")
    if K % TILE_K:
        raise ValueError(f"{name}: the contraction depth K {K} must be a multiple of "
                         f"{TILE_K}")
    _check_vec(name, x, ws, N)
    return N


def _check_gemm_width(name, M, N):
    """The qkv GEMMs' D is a multiple of 128 (their K): a tile width divides
    it. The other GEMMs' output width is checked here."""
    if gemm_tile_cols(M, N) is None:
        raise ValueError(f"{name}: the int8 GEMM takes output widths that one of its tile "
                         f"widths {GEMM_TILE_COLS} divides, got {N}")


def _check_vec(name, x, v, n):
    if v.dtype != torch.float32 or tuple(v.shape) != (n,) \
            or not v.is_contiguous() or v.device != x.device:
        raise ValueError(f"{name}: per-channel vectors must be contiguous "
                         f"float32 [{n}] on {x.device}")


def _check_quant_width(name, K):
    if K > MAX_QUANT_K:
        raise ValueError(f"{name}: the quantising prologue takes rows up to "
                         f"{MAX_QUANT_K} wide, got {K}")


def _check_attnout_mlp_width(name, K, F):
    if attnout_mlp_shape(K, F) is None:
        raise ValueError(f"{name}: the kernel takes (model width, hidden width) in "
                         f"{sorted(ATTNOUT_MLP_SHAPES)}, got ({K}, {F})")


def _check_fc1_width(name, F):
    if fc1_cluster_shape(F) is None:
        raise ValueError(f"{name}: the fc1 GEMM takes hidden widths that a cluster of at "
                         f"most {FC1_MAX_CLUSTER} CTAs splits evenly (F = 2 C NW, NW in "
                         f"{FC1_WARPGROUP_COLS}), got {F}")


def _scratch(x, M, K):
    """int8 activations and their row scales: the prologue kernel's output.
    The wrapper drops them at return; the caching allocator hands the memory
    only to later work on the same stream, which runs after the kernels."""
    return (torch.empty(M, K, dtype=torch.int8, device=x.device),
            torch.empty(M, dtype=torch.float32, device=x.device))


def _launch_qkv(name, x, g, be, wq, ws, b, eps):
    B, N, D = x.shape
    _check_act(name, x, (B, N, D))
    _check_quant_width(name, D)
    if _check_weight(name, x, wq, ws, D) != 3 * D:
        raise ValueError(f"{name}: weight must be [3 * {D}, {D}]")
    _check_vec(name, x, b, 3 * D)
    if g is not None:
        _check_vec(name, x, g, D)
        _check_vec(name, x, be, D)
    M = B * N
    qkv = torch.empty(3, B, N, D, dtype=x.dtype, device=x.device)
    xq, sx = _scratch(x, M, D)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.caim_int8_qkv(
            ptr(x), ptr(g) if g is not None else None,
            ptr(be) if g is not None else None, float(eps), ptr(wq), ptr(ws),
            ptr(b), ptr(qkv), ptr(xq), ptr(sx), M, D, stream_of(x))
    _build.check(err)
    return qkv


def _launch_out_residual(name, a, sa, wq, ws, b, ls, res):
    """a: bf16 activations (sa None: quantised by the prologue) or int8
    activations with their row scales sa."""
    B, N, K = a.shape
    prequant = sa is not None
    _check_act(name, a, (B, N, K), torch.int8 if prequant else torch.bfloat16)
    Nout = _check_weight(name, a, wq, ws, K)
    _check_gemm_width(name, B * N, Nout)
    _check_act(name, res, (B, N, Nout))
    for v in (b, ls):
        _check_vec(name, a, v, Nout)
    M = B * N
    if prequant:
        if sa.dtype != torch.float32 or sa.numel() != M or not sa.is_contiguous():
            raise ValueError(f"{name}: row scales must be contiguous float32 "
                             f"[{B}, {N}, 1]")
        aq, sx = a, sa
    else:
        _check_quant_width(name, K)
        aq, sx = _scratch(a, M, K)
    out = torch.empty_like(res)
    lib = _build.library()
    with torch.cuda.device(a.device):
        err = lib.caim_int8_out_residual(
            None if prequant else ptr(a), ptr(aq), ptr(sx), ptr(wq), ptr(ws),
            ptr(b), ptr(ls), ptr(res), ptr(out), M, K, Nout, stream_of(a))
    _build.check(err)
    return out


def _launch_fc1_gelu(name, x, g, be, wq, ws, b, eps):
    """g, be None: no layernorm (K14)."""
    B, N, K = x.shape
    _check_act(name, x, (B, N, K))
    F = _check_weight(name, x, wq, ws, K)
    _check_vec(name, x, b, F)
    _check_fc1_width(name, F)
    if g is not None:
        _check_quant_width(name, K)
        for v in (g, be):
            _check_vec(name, x, v, K)
    M = B * N
    h8 = torch.empty(B, N, F, dtype=torch.int8, device=x.device)
    sh = torch.empty(B, N, 1, dtype=torch.float32, device=x.device)
    xq, sx = _scratch(x, M, K)
    lib = _build.library()
    with torch.cuda.device(x.device):
        if g is None:
            err = lib.caim_int8_fc1_gelu_rows(
                ptr(x), ptr(wq), ptr(ws), ptr(b), ptr(h8), ptr(sh), ptr(xq), ptr(sx),
                M, K, F, stream_of(x))
        else:
            err = lib.caim_int8_fc1_gelu(
                ptr(x), ptr(g), ptr(be), float(eps), ptr(wq), ptr(ws), ptr(b),
                ptr(h8), ptr(sh), ptr(xq), ptr(sx), M, K, F, stream_of(x))
    _build.check(err)
    return h8, sh


def launch_int8_linear(name, entry, x2, wq, ws, b):
    """x2 bf16 [M, K] -> bf16 [M, Nout] through the C entry named ``entry``
    (K13's or K15's: one kernel, a quantising prologue and the GEMM with the
    unsplit epilogue)."""
    M, K = x2.shape
    _check_act(name, x2, (M, K))
    Nout = _check_weight(name, x2, wq, ws, K)
    _check_gemm_width(name, M, Nout)
    _check_vec(name, x2, b, Nout)
    out = torch.empty(M, Nout, dtype=x2.dtype, device=x2.device)
    xq, sx = _scratch(x2, M, K)
    lib = _build.library()
    with torch.cuda.device(x2.device):
        err = getattr(lib, entry)(ptr(x2), ptr(xq), ptr(sx), ptr(wq), ptr(ws), ptr(b),
                                  ptr(out), M, K, Nout, stream_of(x2))
    _build.check(err)
    return out


def check_bf16_out(name, out_dtype):
    if out_dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel writes bfloat16")


# ------------------------------------------------------------------- ops ----
# Each op's implementation: CPU -> plain version; CUDA -> the kernel or raise,
# counted on the wrapper. Fakes: shapes and dtypes, contiguous (``_library``).
def _qkv_fake(x, *rest):  # rest ends with out_dtype
    return x.new_empty((3, *x.shape), dtype=rest[-1])


@kernel_op("int8_qkv_proj", _qkv_fake)
def _k5_op(x: Tensor, wq: Tensor, ws: Tensor, b: Tensor, out_dtype: torch.dtype) -> Tensor:
    require_device("int8_qkv_proj", x)
    if x.device.type == "cpu":
        return int8_qkv_proj_plain(x, wq, ws, b, out_dtype)
    check_bf16_out("int8_qkv_proj", out_dtype)
    out = _launch_qkv("int8_qkv_proj", x, None, None, wq, ws, b, 0.0)
    int8_qkv_proj.launches += 1
    return out


@kernel_op("int8_qkv_proj_ln", _qkv_fake)
def _k2_op(x: Tensor, g: Tensor, be: Tensor, wq: Tensor, ws: Tensor, b: Tensor, eps: float,
           out_dtype: torch.dtype) -> Tensor:
    require_device("int8_qkv_proj_ln", x)
    if x.device.type == "cpu":
        return int8_qkv_proj_ln_plain(x, g, be, wq, ws, b, eps, out_dtype)
    check_bf16_out("int8_qkv_proj_ln", out_dtype)
    out = _launch_qkv("int8_qkv_proj_ln", x, g, be, wq, ws, b, eps)
    int8_qkv_proj_ln.launches += 1
    return out


def _k3_fake(x, wq, ws, b, ls, res):
    return res.new_empty(res.shape)


@kernel_op("int8_out_residual", _k3_fake)
def _k3_op(x: Tensor, wq: Tensor, ws: Tensor, b: Tensor, ls: Tensor, res: Tensor) -> Tensor:
    require_device("int8_out_residual", x)
    if x.device.type == "cpu":
        return int8_out_residual_plain(x, wq, ws, b, ls, res)
    out = _launch_out_residual("int8_out_residual", x, None, wq, ws, b, ls, res)
    int8_out_residual.launches += 1
    return out


def _k4b_fake(h8, sh, wq, ws, b, ls, res):
    return res.new_empty(res.shape)


@kernel_op("int8_out_residual_prequant", _k4b_fake)
def _k4b_op(h8: Tensor, sh: Tensor, wq: Tensor, ws: Tensor, b: Tensor, ls: Tensor,
            res: Tensor) -> Tensor:
    require_device("int8_out_residual_prequant", h8)
    if h8.device.type == "cpu":
        return int8_out_residual_prequant_plain(h8, sh, wq, ws, b, ls, res)
    out = _launch_out_residual("int8_out_residual_prequant", h8, sh, wq, ws, b, ls, res)
    int8_out_residual_prequant.launches += 1
    return out


def _hidden_fake(x, wq):
    lead = x.shape[:-1]
    return (x.new_empty((*lead, wq.shape[0]), dtype=torch.int8),
            x.new_empty((*lead, 1), dtype=torch.float32))


@kernel_op("int8_fc1_gelu_ln", lambda x, g, be, wq, ws, b, eps: _hidden_fake(x, wq))
def _k4a_op(x: Tensor, g: Tensor, be: Tensor, wq: Tensor, ws: Tensor, b: Tensor,
            eps: float) -> Tuple[Tensor, Tensor]:
    require_device("int8_fc1_gelu_ln", x)
    if x.device.type == "cpu":
        return int8_fc1_gelu_ln_plain(x, g, be, wq, ws, b, eps)
    out = _launch_fc1_gelu("int8_fc1_gelu_ln", x, g, be, wq, ws, b, eps)
    int8_fc1_gelu_ln.launches += 1
    return out


@kernel_op("int8_fc1_gelu", lambda x, wq, ws, b: _hidden_fake(x, wq))
def _k14_op(x: Tensor, wq: Tensor, ws: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
    require_device("int8_fc1_gelu", x)
    if x.device.type == "cpu":
        return int8_fc1_gelu_plain(x, wq, ws, b)
    out = _launch_fc1_gelu("int8_fc1_gelu", x, None, None, wq, ws, b, 0.0)
    int8_fc1_gelu.launches += 1
    return out


def _proj_fake(x, wq, ws, b, out_dtype):
    return x.new_empty((*x.shape[:-1], wq.shape[0]), dtype=out_dtype)


@kernel_op("int8_proj", _proj_fake)
def _k13_op(x: Tensor, wq: Tensor, ws: Tensor, b: Tensor, out_dtype: torch.dtype) -> Tensor:
    require_device("int8_proj", x)
    if x.device.type == "cpu":
        return int8_proj_plain(x, wq, ws, b, out_dtype)
    check_bf16_out("int8_proj", out_dtype)
    B, N, K = x.shape
    _check_act("int8_proj", x, (B, N, K))
    out = launch_int8_linear("int8_proj", "caim_int8_proj", x.view(B * N, K), wq, ws, b)
    int8_proj.launches += 1
    return out.view(B, N, -1)


def _k12_fake(ctx, wo, so, bo, ls1, res, *rest):
    return res.new_empty(res.shape)


@kernel_op("int8_attnout_mlp_ln", _k12_fake)
def _k12_op(ctx: Tensor, wo: Tensor, so: Tensor, bo: Tensor, ls1: Tensor, res: Tensor,
            g: Tensor, be: Tensor, w1q: Tensor, w1s: Tensor, b1: Tensor, w2q: Tensor,
            w2s: Tensor, b2: Tensor, ls2: Tensor, eps: float) -> Tensor:
    name = "int8_attnout_mlp_ln"
    require_device(name, ctx)
    if ctx.device.type == "cpu":
        return int8_attnout_mlp_ln_plain(ctx, wo, so, bo, ls1, res, g, be, w1q, w1s, b1,
                                         w2q, w2s, b2, ls2, eps)
    B, N, K = ctx.shape
    _check_act(name, ctx, (B, N, K))
    _check_act(name, res, (B, N, K))
    if _check_weight(name, ctx, wo, so, K) != K:
        raise ValueError(f"{name}: the attn_out weight must be [{K}, {K}]")
    F = _check_weight(name, ctx, w1q, w1s, K)
    if _check_weight(name, ctx, w2q, w2s, F) != K:
        raise ValueError(f"{name}: the fc2 weight must be [{K}, {F}]")
    _check_attnout_mlp_width(name, K, F)
    for v in (bo, ls1, g, be, b2, ls2):
        _check_vec(name, ctx, v, K)
    _check_vec(name, ctx, b1, F)
    out = torch.empty_like(res)
    lib = _build.library()
    with torch.cuda.device(ctx.device):
        err = lib.caim_int8_attnout_mlp(
            ptr(ctx), ptr(wo), ptr(so), ptr(bo), ptr(ls1), ptr(res), ptr(g), ptr(be),
            float(eps), ptr(w1q), ptr(w1s), ptr(b1), ptr(w2q), ptr(w2s), ptr(b2), ptr(ls2),
            ptr(out), B * N, K, F, stream_of(ctx))
    _build.check(err)
    int8_attnout_mlp_ln.launches += 1
    return out


# -------------------------------------------------------------- wrappers ----
def int8_qkv_proj(x, wq, ws, b, out_dtype=torch.bfloat16):
    """K5. x [B, N, D] -> (q, k, v), each a contiguous [B, N, D]: one GEMM
    over the concatenated [3D, D] weight, split at columns D and 2D (the op
    returns them packed, [3, B, N, D])."""
    forbid_grad("int8_qkv_proj", x, wq, ws, b)
    return _k5_op(x, wq, ws, b, out_dtype).unbind(0)


def int8_qkv_proj_ln(x, g, be, wq, ws, b, eps=1e-6, out_dtype=torch.bfloat16):
    """K2. The pre-layernorm fused into the qkv GEMM: the normalised
    activation reaches device memory only as int8."""
    forbid_grad("int8_qkv_proj_ln", x, g, be, wq, ws, b)
    return _k2_op(x, g, be, wq, ws, b, eps, out_dtype).unbind(0)


def int8_out_residual(x, wq, ws, b, ls, res):
    """K3. x bf16 [B, N, K] -> res + ls * (dequant(quant(x) @ wq^T) + b)."""
    forbid_grad("int8_out_residual", x, wq, ws, b, ls, res)
    return _k3_op(x, wq, ws, b, ls, res)


def int8_out_residual_prequant(h8, sh, wq, ws, b, ls, res):
    """K4b. (h8 int8 [B, N, F], sh f32 [B, N, 1]) ->
    res + ls * (dequant(h8 @ wq^T) + b)."""
    forbid_grad("int8_out_residual_prequant", h8, sh, wq, ws, b, ls, res)
    return _k4b_op(h8, sh, wq, ws, b, ls, res)


def int8_fc1_gelu_ln(x, g, be, wq, ws, b, eps=1e-6):
    """K4a. x [B, N, K] -> (h8 int8 [B, N, F], sh f32 [B, N, 1]): LN, quant,
    GEMM, tanh-GELU and the requantisation over the whole F-wide row. The
    hidden never reaches device memory in a float type: one GEMM pass, a
    thread-block cluster owning all F columns of a row tile and exchanging
    the rows' maxima on chip (``fc1_cluster_shape``)."""
    forbid_grad("int8_fc1_gelu_ln", x, g, be, wq, ws, b)
    return _k4a_op(x, g, be, wq, ws, b, eps)


def int8_fc1_gelu(x, wq, ws, b):
    """K14. K4a without the layernorm: x [B, N, K] -> quant -> GEMM ->
    tanh-GELU -> requant -> (h8 int8 [B, N, F], sh f32 [B, N, 1])."""
    forbid_grad("int8_fc1_gelu", x, wq, ws, b)
    return _k14_op(x, wq, ws, b)


def int8_proj(x, wq, ws, b, out_dtype=torch.bfloat16):
    """K13. x [B, N, K] -> [B, N, Nout]: row quant, int8 GEMM,
    ``acc * s_x * s_w + b``, no split. CUDA: bfloat16 in and out, K a
    multiple of 128 (rows of any such width: K 3072 at the fc2 shape), Nout
    a width ``gemm_tile_cols`` takes."""
    forbid_grad("int8_proj", x, wq, ws, b)
    return _k13_op(x, wq, ws, b, out_dtype)


def int8_mlp_ln(x, g, be, w1q, w1s, b1, w2q, w2s, b2, ls, eps=1e-6):
    """K4. The whole transformer MLP:

        x + ls * fc2(quant(gelu(fc1(quant(LN(x))))))

    as K4a followed by K4b (the TPU kernel's arithmetic; its f32 hidden tile
    does not fit an SM's shared memory): two ops, ``caim::int8_fc1_gelu_ln``
    and ``caim::int8_out_residual_prequant``, whatever the device. Its own
    count, of CUDA calls, is kept here, outside any op: a loaded program
    advances K4a's and K4b's."""
    forbid_grad("int8_mlp_ln", x, g, be, w1q, w1s, b1, w2q, w2s, b2, ls)
    require_device("int8_mlp_ln", x)
    h8, sh = int8_fc1_gelu_ln(x, g, be, w1q, w1s, b1, eps)
    out = int8_out_residual_prequant(h8, sh, w2q, w2s, b2, ls, x)
    if x.device.type == "cuda" and not torch.compiler.is_compiling():  # not while tracing
        int8_mlp_ln.launches += 1
    return out


def int8_attnout_mlp_ln(ctx, wo, so, bo, ls1, res, g, be, w1q, w1s, b1, w2q, w2s, b2, ls2,
                        eps=1e-6):
    """K12. The whole post-attention half of the chained int8 block:

        x   = res + ls1 * attn_out(quant(ctx))
        out = x + ls2 * fc2(quant(gelu(fc1(quant(LN2(x))))))

    with x in f32 from the first residual add to the last (K3 followed by K4
    rounds it to bf16 in between). ctx, res bf16 [B, N, K] -> bf16 [B, N, K].
    On the card: one launch, a thread-block cluster a 64-row tile that keeps
    x, the int8 activations and the int8 hidden on chip (the notes at the top
    of csrc/int8_fused_block.cu); (K, F) one of ``ATTNOUT_MLP_SHAPES``."""
    forbid_grad("int8_attnout_mlp_ln", ctx, wo, so, bo, ls1, res, g, be, w1q, w1s, b1, w2q,
                w2s, b2, ls2)
    return _k12_op(ctx, wo, so, bo, ls1, res, g, be, w1q, w1s, b1, w2q, w2s, b2, ls2, eps)


WRAPPERS = (int8_qkv_proj_ln, int8_qkv_proj, int8_out_residual,
            int8_fc1_gelu_ln, int8_out_residual_prequant, int8_mlp_ln,
            int8_proj, int8_fc1_gelu, int8_attnout_mlp_ln)
for _w in WRAPPERS:
    _w.launches = 0
