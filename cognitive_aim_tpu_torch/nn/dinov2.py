"""DINOv2 ViT backbone (counterpart of cognitive_aim_tpu/nn/dinov2.py).

The inference path, unfiltered or with the token filter:

  * patch embedding as reshape + matmul over the (p, p, 3) patch layout,
    not ``Conv2d`` (whose cuDNN path runs TF32 by default);
  * bicubic position-embedding interpolation through static resize
    matrices, skipped when the grid equals the pretrain grid;
  * pre-LN blocks with LayerScale, one fused [D, 3D] qkv projection, and
    tanh or erf GELU by policy:
        x = x + ls1 * MHSA(LN1(x));  x = x + ls2 * MLP(LN2(x))
  * the final layernorm.

With ``attn_impl="pallas_packed"`` the attention goes through the K1
wrapper (the CUDA kernel for CUDA tensors, its plain version for CPU
tensors), or K7 where the token filter hands the block a key-side logit
bias; with ``"pallas_packed_i8qk"`` through K10 and K10b, whose first
product is int8. ``attn_impl="plain"`` and ``"plain_i8qk"`` always take the
plain versions of those two routes, which is what the kernels are compared
with on the card. Everything runs in the policy's compute dtype, as the JAX
package casts the parameters to it.

Under the int8 policy ``Block.quantize_`` replaces the four dense
projections by their int8 state, and the block runs as the JAX package's
chained int8 block: K2 ``int8_qkv_proj_ln`` -> K1 -> K3
``int8_out_residual`` -> K4 ``int8_mlp_ln`` (kernels/int8_block.py), with no
bare elementwise op between them. ``attn_impl="plain"`` runs the plain
versions of the same four steps. With ``CAIM_FUSE_AOMLP=1`` in the
environment (read at each call, the JAX package's switch) K12
``int8_attnout_mlp_ln`` takes the place of K3 and K4, after any packed
attention route, with or without a key bias. The chained block is chosen by
the JAX package's rule: quantised, a packed attention route, tanh GELU and
no live adapters. Any other quantised block runs unchained, as every float
block does: layernorm in the compute dtype, q, k, v through K15
``int8_linear_fused`` on the fused weight (packed routes) or through
``int8_ops.int8_linear`` (the ``[B, N, H, Dh]`` routes), the other three
projections through ``int8_ops.int8_linear`` (XLA's int8 matmul in the JAX
package, ``torch._int_mm`` on the card), GELU in the compute dtype.

Adapters (LoRA): with ``cfg.use_lora`` a block adds the low-rank products
``scaling * (x @ A^T) @ B^T`` of its targets (``attn_out`` on the attention
context, and ``qkv``, ``fc1``, ``fc2``) as small float matmuls. A block built
without ``use_lora`` ignores adapter tensors it holds. ``merge_lora`` folds
them into the dense weights and drops them.

``attn_impl="pallas"`` is the JAX package's ``[B, N, H, Dh]`` route through
K8 ``flash_attention``; ``"plain_heads"`` asks for that route's plain
version. With a key bias the JAX package takes its XLA attention on this
route (its K8 has no bias input), and so does the port: the plain biased
attention, on any device. This is the package's dispatch, not a fallback.

The token filter (``filter_*`` arguments of ``DinoV2.forward``, off by
default) is the JAX package's approximate fast path: after ``filter_layer``
full blocks keep CLS and the ``filter_keep`` share of the patch tokens,
ranked by the next layer's CLS attention plus the guidance priority; run the
remaining blocks on the short stream; put the dropped tokens back, frozen
at their filter-point values, before the final layernorm. Ported: single
stage and progressive ``filter_schedule``, the fused context token(s)
(``filter_fuse``, ``filter_fuse_k``), ``filter_strat_stride``,
``filter_rollout``, ``filter_ctx_frac`` and proportional attention
(``filter_prop_attn``); merge mode (``filter_merge``: each dropped token is
averaged into its most similar kept token, and every position reads its
representative's final value) and the delta correction
(``filter_delta_correct``: a dropped position gets its nearest kept token's
update over the remaining blocks). Every shape is static per specification
and nothing reads a device value on the host.

The forward is differentiable: the float block's ops are autograd's, the
packed attention kernels carry the JAX package's recompute backward
(kernels/_grad.py), and the int8 kernels raise under grad. ``remat``
recomputes each block in the backward (``torch.utils.checkpoint``).

Tensor parallelism (parallel/sharding.py): a block whose ``tp`` holds the
mesh's ``model`` group holds its rank's heads of q, k and v (rows of each
third of the fused qkv), its rank's columns of fc1 and the matching inputs of
attn_out and fc2. It runs Megatron's pair of collectives (parallel/comm.py)
around each half: the layernormed input enters through ``copy_to``, K1 runs
on the rank's heads, and attn_out's and fc2's partial products are summed by
``reduce_from`` before their biases. Adapters stay whole on every rank: the
attn_out and fc2 adapters read the gathered context and hidden activations,
the qkv and fc1 adapters' outputs are cut to the rank's columns.

``DinoV2.apply_pipelined`` runs the block stack under the GPipe schedule
(parallel/pipeline.py): embedding and final layernorm on every stage's rows,
each stage's chunk of blocks on its rank.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint
import torch.nn.functional as F
from torch import nn

from cognitive_aim_tpu_torch.core.device import resolve_device
from cognitive_aim_tpu_torch.kernels import flash_attention as FA
from cognitive_aim_tpu_torch.kernels import int8_block as IB
from cognitive_aim_tpu_torch.kernels import int8_gemm as IG
from cognitive_aim_tpu_torch.kernels import int8_ops as I8
from cognitive_aim_tpu_torch.nn import init as tinit
from cognitive_aim_tpu_torch.nn import layers as L
from cognitive_aim_tpu_torch.nn.torch_interp import resize_weights
from cognitive_aim_tpu_torch.parallel import comm

# routes on the packed [B, N, H*Dh] layout, and on [B, N, H, Dh]
PACKED_IMPLS = ("pallas_packed", "pallas_packed_i8qk", "plain", "plain_i8qk")
HEADS_IMPLS = ("pallas", "plain_heads")
ATTN_IMPLS = PACKED_IMPLS + HEADS_IMPLS

# attn_impl -> (attention without a key bias, attention with one)
_ATTEND = {
    "pallas_packed": (FA.flash_attention_packed, FA.flash_attention_packed_bias),
    "pallas_packed_i8qk": (FA.flash_attention_packed_i8qk,
                           FA.flash_attention_packed_i8qk_bias),
    "plain": (FA.flash_attention_packed_plain, FA.flash_attention_packed_bias_plain),
    "plain_i8qk": (FA.flash_attention_packed_i8qk_plain,
                   FA.flash_attention_packed_i8qk_bias_plain),
}


def attend(attn_impl: str, q, k, v, k_bias, scale: float, num_heads: int):
    """The JAX package's attention dispatch: by route, and by whether the
    token filter gave the block a key-side logit bias [B, N]."""
    unbiased, biased = _ATTEND[attn_impl]
    if k_bias is None:
        return unbiased(q, k, v, scale, num_heads)
    return biased(q, k, v, k_bias, scale, num_heads)


def attend_heads(attn_impl: str, q, k, v, k_bias, scale: float):
    """The ``[B, N, H, Dh]`` routes: K8 (``"pallas"``) or its plain version
    (``"plain_heads"``). With a key bias both take the plain biased
    attention, as the JAX package takes its XLA attention there."""
    if k_bias is not None:
        B, N, H, hd = q.shape
        q, k, v = (t.reshape(B, N, H * hd) for t in (q, k, v))
        return FA.flash_attention_packed_bias_plain(q, k, v, k_bias, scale,
                                                    H).view(B, N, H, hd)
    if attn_impl == "pallas":
        return FA.flash_attention(q, k, v, scale)
    return FA.attention_reference(q, k, v, scale)


# projections that can carry an adapter, in the order they are folded
LORA_TARGETS = ("attn_out", "fc1", "fc2", "qkv")


def adapter_names(target: str) -> Tuple[str, str]:
    """The JAX tree's names: the ``attn_out`` adapter keeps the bare
    ``lora_A`` / ``lora_B``, the others are ``lora_<target>_A`` / ``_B``."""
    if target == "attn_out":
        return "lora_A", "lora_B"
    return f"lora_{target}_A", f"lora_{target}_B"


@dataclasses.dataclass(frozen=True)
class DinoV2Config:
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_ratio: int = 4
    patch_size: int = 14
    pretrain_image_size: int = 518  # position-embedding grid = 37x37
    layer_norm_eps: float = 1e-6
    layerscale_value: float = 1.0
    use_lora: bool = False
    lora_rank: int = 16
    lora_alpha: int = 16
    # which projections carry adapters: ("attn_out",) by default, up to
    # ("qkv", "attn_out", "fc1", "fc2")
    lora_targets: tuple = ("attn_out",)
    gelu_approx: bool = False

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def num_pretrain_patches(self):
        g = self.pretrain_image_size // self.patch_size
        return g * g

    @property
    def mlp_dim(self):
        return int(self.hidden_size * self.mlp_ratio)


BASE = DinoV2Config(hidden_size=768, num_layers=12, num_heads=12)
LARGE = DinoV2Config(hidden_size=1024, num_layers=24, num_heads=16)


def config_for(backbone_size: str, **kw) -> DinoV2Config:
    """'base' -> 768-d, 'large' -> 1024-d, anything else falls back to base."""
    base = LARGE if backbone_size == "large" else BASE
    return dataclasses.replace(base, **kw)


class Block(nn.Module):
    def __init__(self, cfg: DinoV2Config, device=None):
        super().__init__()
        D = cfg.hidden_size
        device = resolve_device(device)
        self.cfg = cfg
        self.norm1 = L.layernorm(D, cfg.layer_norm_eps, device)
        self.qkv = L.linear(D, 3 * D, device)  # rows: q, k, v outputs
        self.attn_out = L.linear(D, D, device)
        self.ls1 = nn.Parameter(torch.empty(D, device=device))
        self.norm2 = L.layernorm(D, cfg.layer_norm_eps, device)
        self.fc1 = L.linear(D, cfg.mlp_dim, device)
        self.fc2 = L.linear(cfg.mlp_dim, D, device)
        self.ls2 = nn.Parameter(torch.empty(D, device=device))
        self.tp = None  # the mesh's `model` group, set by parallel.sharding.shard_params
        if cfg.use_lora:
            for target in LORA_TARGETS:
                if target in cfg.lora_targets:
                    self.add_adapter(target, cfg.lora_rank)

    def add_adapter(self, target: str, rank: int):
        """Uninitialised adapter parameters of one target, with the JAX
        shapes: A [rank, in], B [out, rank]."""
        D, F_ = self.cfg.hidden_size, self.cfg.mlp_dim
        din, dout = {"qkv": (D, 3 * D), "attn_out": (D, D), "fc1": (D, F_),
                     "fc2": (F_, D)}[target]
        device = self.ls1.device
        a, b = adapter_names(target)
        setattr(self, a, nn.Parameter(torch.empty(rank, din, device=device)))
        setattr(self, b, nn.Parameter(torch.empty(dout, rank, device=device)))

    def adapter(self, target: str):
        """(A, B) of a target, or None where the block holds none."""
        a, b = adapter_names(target)
        if getattr(self, a, None) is None:
            return None
        return getattr(self, a), getattr(self, b)

    @property
    def has_adapters(self) -> bool:
        return any(self.adapter(t) is not None for t in LORA_TARGETS)

    @property
    def live_adapters(self) -> bool:
        """Adapters that the forward applies: held, and ``cfg.use_lora``."""
        return self.cfg.use_lora and self.has_adapters

    def _lora_delta(self, target: str, x: torch.Tensor):
        """``scaling * (x @ A^T) @ B^T`` of a target's adapter in x's dtype,
        or None. Gated by ``cfg.use_lora``: a block built without it ignores
        adapter tensors it holds."""
        ab = self.adapter(target)
        if not self.cfg.use_lora or ab is None:
            return None
        a, b = ab
        scaling = self.cfg.lora_alpha / self.cfg.lora_rank
        return scaling * ((x @ a.to(x.dtype).T) @ b.to(x.dtype).T)

    @torch.no_grad()
    def merge_lora_(self, scaling: float):
        """Fold every adapter into its dense weight, ``W += scaling * B @ A``
        in the [out, in] layout (the fused qkv weight takes the whole
        [3D, r] @ [r, D]), and drop the adapter tensors. In place."""
        if not self.has_adapters:
            return
        if self.quantized:
            raise RuntimeError("merge_lora: fold the adapters before the weights are "
                               "quantised (merge_lora_params, then prepare_params)")
        for target in LORA_TARGETS:
            ab = self.adapter(target)
            if ab is None:
                continue
            w = getattr(self, target).weight
            w += scaling * (ab[1].float() @ ab[0].float()).to(w.dtype)
            for name in adapter_names(target):
                delattr(self, name)

    def init(self, g: torch.Generator) -> "Block":
        for ln in (self.norm1, self.norm2):
            nn.init.ones_(ln.weight)
            nn.init.zeros_(ln.bias)
        # q, k, v are torch-default Linears(D, D): fan_in D for all three,
        # so the stacked [3D, D] weight draws from the same U(-b, b)
        for lin in (self.qkv, self.attn_out, self.fc1, self.fc2):
            tinit.linear_default_(lin, g)
        nn.init.constant_(self.ls1, self.cfg.layerscale_value)
        nn.init.constant_(self.ls2, self.cfg.layerscale_value)
        for target in LORA_TARGETS:  # A 0.01 * randn, B zeros
            ab = self.adapter(target)
            if ab is not None:
                tinit.normal_(ab[0], 0.01, g)
                nn.init.zeros_(ab[1])
        return self

    def qkv_proj(self, x: torch.Tensor):
        """One [D, 3D] GEMM that writes q, k and v as three contiguous
        [B, N, D] slices of one buffer, the layout K1 reads (a
        tensor-parallel rank's heads: [B, N, D / tp] each)."""
        B, N, D = x.shape
        w = self.qkv.weight.to(x.dtype)
        Dq = w.shape[0] // 3
        w = w.view(3, Dq, D).transpose(1, 2)
        b = self.qkv.bias.to(x.dtype).view(3, 1, Dq)
        qkv = torch.baddbmm(b, x.reshape(1, B * N, D).expand(3, B * N, D), w)
        return [t.view(B, N, Dq) for t in qkv.unbind(0)]

    def _lin(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """A dense projection in x's dtype: the float matmul, or
        ``int8_ops.int8_linear`` on a quantised weight (outside any kernel,
        as XLA's int8 matmul is in the JAX package)."""
        lin = getattr(self, name)
        if isinstance(lin, L.Int8Linear):
            return I8.int8_linear(x, {"q": lin.wq, "s": lin.ws}, lin.bias)
        return L.linear_apply(lin, x, x.dtype)

    def _row_lin(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """attn_out or fc2: under tensor parallelism the rank's partial
        product summed over ``model``, then the bias (in the GEMM where the
        group holds one rank, so world 1 computes what the block without a
        group does)."""
        if self.tp is None:
            return self._lin(name, x)
        lin = getattr(self, name)
        w, b = lin.weight.to(x.dtype), lin.bias.to(x.dtype)
        if comm.group_size(self.tp) == 1:
            return comm.reduce_from(F.linear(x, w, b), self.tp)
        return comm.reduce_from(F.linear(x, w), self.tp) + b

    def _lora_split(self, target: str, x: torch.Tensor, parts: int = 1):
        """The adapter delta of a column-split target (qkv, fc1) on the
        whole input, cut to this rank's columns of each of ``parts``."""
        d = self._lora_delta(target, x)
        if d is None or self.tp is None:
            return d
        *lead, n = d.shape
        d = comm.split_to(d.reshape(*lead, parts, n // parts), self.tp, -1)
        return d.reshape(*lead, -1)

    def mhsa(self, x: torch.Tensor, attn_impl: str, k_bias=None) -> torch.Tensor:
        cfg = self.cfg
        B, N, D = x.shape
        hd = cfg.head_dim
        packed = attn_impl in PACKED_IMPLS
        dqkv = self._lora_split("qkv", x, 3)  # [B, N, 3D] (3D / tp on a TP rank) or None
        if self.quantized:
            w = {"q": self.qkv.wq, "s": self.qkv.ws}
            if not packed:
                qkv = I8.int8_linear(x, w, self.qkv.bias)
            elif attn_impl.startswith("pallas"):
                qkv = IG.int8_linear_fused(x, w, self.qkv.bias)  # K15
            else:
                qkv = IG.int8_linear_fused_plain(x, w, self.qkv.bias)
            if dqkv is not None:
                qkv = qkv + dqkv
            if packed:  # one copy into the three contiguous slices K1 reads
                q, k, v = qkv.view(B, N, 3, D).permute(2, 0, 1, 3).contiguous().unbind(0)
            else:  # K8 reads the column slices in place
                q, k, v = qkv.split(D, dim=-1)
        else:
            q, k, v = self.qkv_proj(x if self.tp is None else comm.copy_to(x, self.tp))
            if dqkv is not None:
                q, k, v = ((t + d).contiguous()
                           for t, d in zip((q, k, v), dqkv.split(q.shape[-1], dim=-1)))
        H = q.shape[-1] // hd  # this rank's heads under tensor parallelism
        if packed:
            ctx = attend(attn_impl, q, k, v, k_bias, hd ** -0.5, H)
        else:
            q, k, v = (t.view(B, N, H, hd) for t in (q, k, v))
            ctx = attend_heads(attn_impl, q, k, v, k_bias, hd ** -0.5).reshape(B, N, H * hd)
        out = self._row_lin("attn_out", ctx)
        # applied to the attention context (all heads, gathered under tensor parallelism)
        d_out = self._lora_delta(
            "attn_out", ctx if self.tp is None else comm.gather_from(ctx, self.tp, -1))
        return out if d_out is None else out + d_out

    @property
    def quantized(self) -> bool:
        return isinstance(self.qkv, L.Int8Linear)

    @torch.no_grad()
    def quantize_(self, compute_dtype: torch.dtype) -> "Block":
        """The int8 policy's state, from float32 parameters: qkv, attn_out,
        fc1 and fc2 become ``Int8Linear`` (int8 weight, f32 scales). What the
        JAX package casts to the compute dtype and its kernels then read in
        f32 (biases, layernorm parameters, LayerScales) stays float32 at the
        value rounded to ``compute_dtype``."""
        if self.quantized:
            raise RuntimeError("Block.quantize_: the block is already quantised")
        for name in ("qkv", "attn_out", "fc1", "fc2"):
            lin = getattr(self, name)
            setattr(self, name, L.Int8Linear.from_float(lin.weight, lin.bias,
                                                        compute_dtype))
        for p in (*self.norm1.parameters(), *self.norm2.parameters(),
                  self.ls1, self.ls2):
            p.data = L.round_through(p.data, compute_dtype)
        for target in LORA_TARGETS:  # adapters stay float, in the compute dtype
            for p in self.adapter(target) or ():
                p.data = p.data.to(compute_dtype)
        return self

    def chained(self, attn_impl: str) -> bool:
        """The JAX package's rule for ``_block_int8_chained``: quantised, a
        packed attention route, tanh GELU, no live adapters."""
        return (self.quantized and attn_impl in PACKED_IMPLS and self.cfg.gelu_approx
                and not self.live_adapters)

    def _forward_int8(self, x: torch.Tensor, attn_impl: str, k_bias=None) -> torch.Tensor:
        cfg = self.cfg
        fused = attn_impl.startswith("pallas_packed")
        n1, n2, eps = self.norm1, self.norm2, cfg.layer_norm_eps
        qkv_ln = IB.int8_qkv_proj_ln if fused else IB.int8_qkv_proj_ln_plain
        q, k, v = qkv_ln(x, n1.weight, n1.bias, self.qkv.wq, self.qkv.ws,
                         self.qkv.bias, eps, x.dtype)
        ctx = attend(attn_impl, q, k, v, k_bias, cfg.head_dim ** -0.5, cfg.num_heads)
        out = (self.attn_out.wq, self.attn_out.ws, self.attn_out.bias, self.ls1)
        mlp = (n2.weight, n2.bias, self.fc1.wq, self.fc1.ws, self.fc1.bias,
               self.fc2.wq, self.fc2.ws, self.fc2.bias, self.ls2, eps)
        # read at call time (the engine's graphs: while capturing), as JAX reads it tracing
        if os.environ.get("CAIM_FUSE_AOMLP", "0") == "1":
            aomlp = IB.int8_attnout_mlp_ln if fused else IB.int8_attnout_mlp_ln_plain
            return aomlp(ctx, *out, x, *mlp)
        out_res = IB.int8_out_residual if fused else IB.int8_out_residual_plain
        mlp_ln = IB.int8_mlp_ln if fused else IB.int8_mlp_ln_plain
        return mlp_ln(out_res(ctx, *out, x), *mlp)

    def forward(self, x: torch.Tensor, attn_impl: str, k_bias=None) -> torch.Tensor:
        """k_bias: optional [B, N] f32 additive key-side logit bias, the
        token filter's proportional attention."""
        if self.chained(attn_impl):
            return self._forward_int8(x, attn_impl, k_bias)
        dt = x.dtype
        h = L.layernorm_apply(self.norm1, x)
        x = x + self.ls1.to(dt) * self.mhsa(h, attn_impl, k_bias)
        h = L.layernorm_apply(self.norm2, x)
        h1 = self._lin("fc1", h if self.tp is None else comm.copy_to(h, self.tp))
        d1 = self._lora_split("fc1", h)
        if d1 is not None:
            h1 = h1 + d1
        g = F.gelu(h1, approximate="tanh" if self.cfg.gelu_approx else "none")
        h2 = self._row_lin("fc2", g)
        d2 = self._lora_delta("fc2", g if self.tp is None else comm.gather_from(g, self.tp, -1))
        if d2 is not None:
            h2 = h2 + d2
        return x + self.ls2.to(dt) * h2


def merge_lora(backbone: "DinoV2", scaling: float) -> "DinoV2":
    """Fold the adapters of every block into its dense weights,
    ``W' = W + scaling * B @ A`` per target (scaling = lora_alpha /
    lora_rank), and drop the adapter tensors: the deployment transform of
    the adapter-gated filter sandwich, whose folded weights then take the
    ordinary int8 quantisation. Mathematically the runtime adapter
    (x (W + dW)^T = x W^T + x dW^T) up to float rounding. In place, unlike
    the JAX function, which returns a new tree; a no-op without adapters."""
    for blk in backbone.layers:
        blk.merge_lora_(scaling)
    return backbone


# ------------------------------------------------------- token filtering ----
def _layer_qk_weights(blk: Block, dtype: torch.dtype):
    """Float32 (Wq, bq, Wk, bk) of a block's query and key projections, with
    the values the block itself computes with: the int8 weight times its
    per-row scales, or the float weight rounded to the compute dtype. The
    weights are [out, in], so q and k are row slices of the fused [3D, D]
    (on a tensor-parallel rank [3D / tp, D]: its heads of each)."""
    D = blk.qkv.bias.shape[0] // 3
    if blk.quantized:
        w = blk.qkv.wq[:2 * D].float() * blk.qkv.ws[:2 * D, None]
        b = blk.qkv.bias[:2 * D]
    else:
        w = L.round_through(blk.qkv.weight[:2 * D], dtype)
        b = L.round_through(blk.qkv.bias[:2 * D], dtype)
    return w[:D], b[:D], w[D:], b[D:]


def _cls_importance(blk: Block, x: torch.Tensor, return_keys: bool = False):
    """Patch-token importance [B, P]: the CLS row of the NEXT block's
    attention, averaged over heads (EViT-style), all in float32. Costs one
    [B, N, D] x [D, D] key projection and one score row. With
    ``return_keys`` also the key projection [B, N, D] (f32, heads
    flattened), which merge mode and the delta correction use as the token
    similarity embedding.

    On a tensor-parallel block each rank holds its heads of q and k: it sums
    the CLS rows of its heads, the sum is all-reduced over ``model`` and
    divided by the head count, so every rank keeps the same set; the keys
    are all-gathered (only merge mode and the delta correction read them)."""
    cfg = blk.cfg
    H, hd = cfg.num_heads, cfg.head_dim
    n1 = blk.norm1
    h = F.layer_norm(x.float(), n1.normalized_shape, L.round_through(n1.weight, x.dtype),
                     L.round_through(n1.bias, x.dtype), n1.eps)
    tp = blk.tp
    if tp is not None:
        h = comm.copy_to(h, tp)
    wq, bq, wk, bk = _layer_qk_weights(blk, x.dtype)
    q_cls = F.linear(h[:, 0], wq, bq)
    k = F.linear(h, wk, bk)
    B, N, Dk = k.shape
    Hk = Dk // hd  # this rank's heads under tensor parallelism
    scores = torch.einsum("bhd,bnhd->bhn", q_cls.reshape(B, Hk, hd),
                          k.reshape(B, N, Hk, hd)) * (hd ** -0.5)
    probs = torch.softmax(scores, dim=-1)
    if tp is None:
        imp = probs.mean(dim=1)[:, 1:]  # patch columns
    else:
        imp = comm.reduce_from(probs.sum(dim=1), tp)[:, 1:] / H
        if return_keys:
            k = comm.gather_from(k, tp, -1)
    return (imp, k) if return_keys else imp


def _top_k(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest per row, the lower index first among equal
    values (``jax.lax.top_k``'s order; ``torch.topk`` promises none)."""
    return torch.sort(values, dim=1, descending=True, stable=True).indices[:, :k]


def _mask_of(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """[B, n] with 1 at the indices idx [B, k], 0 elsewhere."""
    return torch.zeros(idx.shape[0], n, dtype=dtype, device=idx.device).scatter_(1, idx, 1.0)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, T, D] at token indices idx [B, k] -> [B, k, D]."""
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))


def _group_fused(x_tokens, w, groups, n_groups: int, w_fallback=None):
    """[B, n_groups, D] context tokens: per-group means of the tokens,
    weighted by w [B, T] (importance times dropped-mask). groups [B, T]
    holds each token's group id. A group whose w-mass is zero (all its
    tokens kept) takes ``w_fallback``, its importance-weighted mean over all
    its tokens, instead of a zero vector."""
    dt = x_tokens.dtype
    eps = torch.full((), 1e-9, dtype=dt, device=x_tokens.device)
    # all groups in one pass: [B, T, G] one-hot weights, one reduction over T
    gmask = (groups[..., None] == torch.arange(n_groups, device=groups.device)).to(dt)
    wg = w[..., None] * gmask
    den = wg.sum(dim=1)  # [B, G]
    if w_fallback is not None:
        use_fb = (den <= 0).to(dt)
        wg = wg + use_fb[:, None] * (w_fallback[..., None] * gmask)
        den = wg.sum(dim=1)
    num = torch.einsum("btg,btd->bgd", wg, x_tokens)
    return num / (den[..., None] + eps)


def _keep_indices(importance, keep_weights, k_keep: int, ctx_frac: float = 0.0):
    """[B, k_keep] ascending patch indices of the kept set. Priority = CLS
    attention + 10 * (guidance weight - 1), so guided-region tokens outrank
    background and within a tier the attention decides. ``ctx_frac`` > 0
    reserves round(ctx_frac * k_keep) slots for the top tokens by RAW
    importance, immune to the guidance boost; without guidance it is a
    no-op."""
    prio = importance
    if keep_weights is not None:
        prio = prio + 10.0 * (keep_weights.float() - 1.0)
    k_ctx = int(round(k_keep * ctx_frac)) if keep_weights is not None else 0
    if k_ctx <= 0:
        return torch.sort(_top_k(prio, k_keep), dim=1).values
    idx_g = _top_k(prio, k_keep - k_ctx)
    taken = _mask_of(idx_g, importance.shape[1], torch.float32)
    # importance is in [0, 1], so the offset cannot meet a live value
    idx_c = _top_k(importance - 1e9 * taken, k_ctx)
    return torch.sort(torch.cat([idx_g, idx_c], dim=1), dim=1).values


def _filter_tokens(x, importance, keep_weights, k_keep: int, fuse: bool = False,
                   fuse_groups=None, fuse_n_groups: int = 0, ctx_frac: float = 0.0):
    """Keep CLS + the k_keep highest-priority patch tokens. With ``fuse`` one
    more token, the importance-weighted mean of the DROPPED tokens, is
    appended (or one per spatial group: ``fuse_groups`` [P] group ids,
    ``fuse_n_groups`` of them). The weights, the sum and the division run in
    x's dtype. Returns ([B, 1+k(+G), D], [B, k] ascending patch indices)."""
    idx = _keep_indices(importance, keep_weights, k_keep, ctx_frac)
    parts = [x[:, :1], _take(x[:, 1:], idx)]
    if fuse:
        B, P = importance.shape
        w = importance.to(x.dtype) * (1.0 - _mask_of(idx, P, x.dtype))
        if fuse_groups is not None:
            parts.append(_group_fused(x[:, 1:], w, fuse_groups[None].expand(B, P),
                                      fuse_n_groups, w_fallback=importance.to(x.dtype)))
        else:
            denom = w.sum(dim=1, keepdim=True) + torch.full((), 1e-9, dtype=x.dtype,
                                                            device=x.device)
            parts.append((x[:, 1:] * w[..., None]).sum(dim=1, keepdim=True)
                         / denom[..., None])
    return torch.cat(parts, dim=1), idx


def _refilter_tokens(x, imp_all, k_prev: int, keep_w_gathered, k_keep: int,
                     fuse: bool = False, groups_gathered=None, n_groups: int = 1,
                     ctx_frac: float = 0.0):
    """A later stage of a progressive schedule: the stream is [B, 1 + k_prev
    (+G fused), D]. Keep the k_keep highest-priority of the k_prev patch
    tokens and fold the newly dropped ones, with the old context token(s),
    into the new context token(s). Returns (stream, [B, k_keep] ascending
    LOCAL indices into the previous kept set)."""
    B = x.shape[0]
    n_fused_in = x.shape[1] - 1 - k_prev
    imp_p = imp_all[:, :k_prev]
    idx = _keep_indices(imp_p, keep_w_gathered, k_keep, ctx_frac)
    patches = x[:, 1:1 + k_prev]
    parts = [x[:, :1], _take(patches, idx)]
    if fuse:
        w = imp_p.to(x.dtype) * (1.0 - _mask_of(idx, k_prev, x.dtype))
        if n_groups > 1:
            if n_fused_in not in (0, n_groups):
                raise ValueError(
                    f"fused-context token count mismatch: stream carries "
                    f"{n_fused_in} context tokens but n_groups={n_groups} "
                    f"(stage disagreement — a bug in the caller)")
            x_in, w_in, g_in = patches, w, groups_gathered
            fb = imp_p.to(x.dtype)
            if n_fused_in:
                # the old context tokens join their own group's reduction
                gids = torch.arange(n_groups, device=x.device)[None].expand(B, n_groups)
                x_in = torch.cat([patches, x[:, 1 + k_prev:1 + k_prev + n_groups]], dim=1)
                w_f = imp_all[:, k_prev:k_prev + n_groups].to(x.dtype)
                w_in = torch.cat([w, w_f], dim=1)
                g_in = torch.cat([groups_gathered, gids], dim=1)
                fb = torch.cat([fb, w_f], dim=1)
            parts.append(_group_fused(x_in, w_in, g_in, n_groups, w_fallback=fb))
        else:
            num = (patches * w[..., None]).sum(dim=1, keepdim=True)
            den = w.sum(dim=1, keepdim=True)
            if n_fused_in >= 1:
                w_f = imp_all[:, k_prev:k_prev + 1].to(x.dtype)
                num = num + x[:, 1 + k_prev:2 + k_prev] * w_f[..., None]
                den = den + w_f
            eps = torch.full((), 1e-9, dtype=x.dtype, device=x.device)
            parts.append(num / (den[..., None] + eps))
    return torch.cat(parts, dim=1), idx


def _scatter_tokens(x_full, x_filtered, idx):
    """The updated CLS + kept patch tokens written back into the full-length
    stream (dropped tokens keep their filter-point values); trailing context
    tokens are discarded."""
    k, D = idx.shape[1], x_full.shape[-1]
    patches = x_full[:, 1:].scatter(1, idx[..., None].expand(-1, -1, D),
                                    x_filtered[:, 1:1 + k])
    return torch.cat([x_filtered[:, :1], patches], dim=1)


def _complement_indices(idx: torch.Tensor, n_total: int, n_drop: int) -> torch.Tensor:
    """[B, n_drop] ascending: the exact complement of the kept set idx
    [B, k]. Ranking by negated priority instead would, on a tie at the keep
    boundary, put one token in both sets and another in neither."""
    mask = 1.0 - _mask_of(idx, n_total, torch.float32)
    return torch.sort(_top_k(mask, n_drop), dim=1).values


def _nearest_kept(keys: torch.Tensor, idx: torch.Tensor, idx_drop: torch.Tensor):
    """[B, n_drop] index into the kept set of each dropped token's most
    similar kept token, by cosine similarity of the key rows keys [B, T, D]
    (f32); the lowest index among equal similarities."""
    kn = keys * torch.rsqrt((keys * keys).sum(dim=-1, keepdim=True) + 1e-12)
    sim = torch.einsum("bjd,bkd->bjk", _take(kn, idx_drop), _take(kn, idx))
    return sim.argmax(dim=-1)


def _slot_map(idx, idx_drop, assign, n_total: int) -> torch.Tensor:
    """[B, n_total] int64: a kept token's own row of the kept block, a
    dropped token's representative's."""
    B, k = idx.shape
    slots = torch.arange(k, device=idx.device)[None].expand(B, k)
    rep = torch.zeros(B, n_total, dtype=torch.long, device=idx.device)
    return rep.scatter_(1, idx, slots).scatter_(1, idx_drop, assign)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n).float()`` as a comparison with ``arange(n)``: the
    same values, without the range checks that read the indices on the
    host (a captured forward may not)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _filter_tokens_merge(x, importance, keys, keep_weights, k_keep: int,
                         ctx_frac: float = 0.0):
    """Merge mode (ToMe-style): the same kept set as ``_filter_tokens``, but
    each dropped token is averaged, in f32, into its most similar kept token
    instead of frozen, so its evidence stays live through the remaining
    blocks, and at the end its position reads its representative's final
    value. Returns (stream [B, 1+k, D], idx [B, k] kept patch indices, rep
    [B, P] patch position -> row of the kept block that stands for it, sizes
    [B, k] f32 merged-group sizes)."""
    B, P = importance.shape
    idx = _keep_indices(importance, keep_weights, k_keep, ctx_frac)
    n_drop = P - k_keep
    patches = x[:, 1:]
    kept = _take(patches, idx)
    if n_drop == 0:
        rep = torch.arange(P, device=x.device)[None].expand(B, P)
        return (torch.cat([x[:, :1], kept], dim=1), idx, rep,
                torch.ones(B, k_keep, dtype=torch.float32, device=x.device))
    idx_drop = _complement_indices(idx, P, n_drop)
    assign = _nearest_kept(keys[:, 1:], idx, idx_drop)
    onehot = _one_hot(assign, k_keep)  # [B, P-k, k]
    absorbed = torch.einsum("bjk,bjd->bkd", onehot, _take(patches, idx_drop).float())
    sizes = 1.0 + onehot.sum(dim=1)
    merged = ((kept.float() + absorbed) / sizes[..., None]).to(x.dtype)
    return (torch.cat([x[:, :1], merged], dim=1), idx,
            _slot_map(idx, idx_drop, assign, P), sizes)


def _assign_dropped(importance, keys, idx, k_keep: int):
    """The delta correction's helper: for the kept set idx of
    ``_filter_tokens``, (idx_drop [B, P-k] ascending, its exact complement;
    assign [B, P-k] index into the kept set of each dropped token's most
    similar kept token)."""
    P = importance.shape[1]
    idx_drop = _complement_indices(idx, P, P - k_keep)
    return idx_drop, _nearest_kept(keys[:, 1:], idx, idx_drop)


def _refilter_tokens_merge(x, imp_all, keys, k_prev: int, keep_w_gathered, k_keep: int,
                           sizes, ctx_frac: float = 0.0):
    """A later stage of a progressive merge schedule: the stream is [B, 1 +
    k_prev, D] with group sizes [B, k_prev]. Keep the k_keep highest-priority
    slots and absorb each dropped slot into its most similar kept slot,
    weighted by size. Returns (stream [B, 1+k_keep, D], idx_local [B, k_keep]
    into the previous kept set, slot_map [B, k_prev] old slot -> new slot,
    new sizes [B, k_keep])."""
    imp_p = imp_all[:, :k_prev]
    idx_local = _keep_indices(imp_p, keep_w_gathered, k_keep, ctx_frac)
    slots = x[:, 1:1 + k_prev]
    drop_local = _complement_indices(idx_local, k_prev, k_prev - k_keep)
    assign = _nearest_kept(keys[:, 1:1 + k_prev], idx_local, drop_local)
    onehot = _one_hot(assign, k_keep)
    s_kept, s_drop = sizes.gather(1, idx_local), sizes.gather(1, drop_local)
    absorbed = torch.einsum("bjk,bjd->bkd", onehot,
                            _take(slots, drop_local).float() * s_drop[..., None])
    new_sizes = s_kept + torch.einsum("bjk,bj->bk", onehot, s_drop)
    merged = ((_take(slots, idx_local).float() * s_kept[..., None] + absorbed)
              / new_sizes[..., None]).to(x.dtype)
    return (torch.cat([x[:, :1], merged], dim=1), idx_local,
            _slot_map(idx_local, drop_local, assign, k_prev), new_sizes)


def _prop_bias_merge(sizes: torch.Tensor) -> torch.Tensor:
    """[B, 1+k] f32 key bias of proportional attention in merge mode: 0 for
    CLS, +log(group size) on every kept token."""
    z = torch.zeros(sizes.shape[0], 1, dtype=torch.float32, device=sizes.device)
    return torch.cat([z, torch.log(sizes.float())], dim=1)


def _fuse_group_ids(gh: int, gw: int, n_groups: int) -> Tuple[np.ndarray, int]:
    """Spatial cell id of every patch for ``filter_fuse_k`` context tokens
    (a q x q split of the grid), made consecutive: on a grid smaller than q
    per side some cells are empty, and every stage must agree on the count."""
    q = int(round(n_groups ** 0.5))
    rows = np.arange(gh)[:, None] * q // gh
    cols = np.arange(gw)[None, :] * q // gw
    ids = (rows * q + cols).reshape(-1)
    uniq = np.unique(ids)
    return np.searchsorted(uniq, ids).astype(np.int64), int(len(uniq))


@functools.lru_cache(maxsize=32)
def _fuse_groups_on(gh: int, gw: int, n_groups: int, device: torch.device):
    """``_fuse_group_ids`` on ``device``, made once per grid: ([P] int64 group
    ids, [P, G] f32 one-hot membership)."""
    ids, n = _fuse_group_ids(gh, gw, n_groups)
    groups = torch.from_numpy(ids).to(device)
    return groups, F.one_hot(groups, n).float()


@functools.lru_cache(maxsize=32)
def _strat_bonus_on(gh: int, gw: int, stride: int, device: torch.device):
    """[1, P] f32 on ``device``, made once per grid: 0.25 at every
    (stride, stride)-strided grid position, 0 elsewhere."""
    m = np.zeros((gh, gw), np.float32)
    m[stride // 2::stride, stride // 2::stride] = 1.0
    return torch.from_numpy(0.25 * m.reshape(-1)).to(device)[None]


def _prop_bias_drop(idx_global, P: int, group_onehot):
    """[B, 1+k+G] f32 key bias of proportional attention: 0 for CLS and the
    kept tokens, +log(number of dropped tokens it stands for) for each
    context token; a group with nothing dropped gets log(1e-6).
    group_onehot: [P, G] f32 membership of each patch, or None for G = 1."""
    B, k = idx_global.shape
    dr = 1.0 - _mask_of(idx_global, P, torch.float32)
    if group_onehot is not None:
        counts = dr @ group_onehot  # sums of 0s and 1s: exact
    else:
        counts = dr.sum(dim=1, keepdim=True)
    zeros = torch.zeros(B, 1 + k, dtype=torch.float32, device=idx_global.device)
    return torch.cat([zeros, torch.log(counts.clamp(min=1e-6))], dim=1)


@functools.lru_cache(maxsize=32)
def _bicubic_weights_on(src: int, dst: int, device: torch.device) -> torch.Tensor:
    """The [dst, src] bicubic resize matrix on ``device``, made once per size."""
    return torch.from_numpy(resize_weights(src, dst, "bicubic").copy()).to(device)


class DinoV2(nn.Module):
    def __init__(self, cfg: DinoV2Config, device=None):
        super().__init__()
        D = cfg.hidden_size
        device = resolve_device(device)
        self.cfg = cfg
        self.cls_token = nn.Parameter(torch.empty(1, 1, D, device=device))
        self.mask_token = nn.Parameter(torch.empty(1, D, device=device))
        self.pos_embed = nn.Parameter(
            torch.empty(1, cfg.num_pretrain_patches + 1, D, device=device))
        # rows of the [in, D] weight follow the (p_row, p_col, channel) order
        self.patch_embed = L.linear(cfg.patch_size ** 2 * 3, D, device)
        self.layers = nn.ModuleList(Block(cfg, device) for _ in range(cfg.num_layers))
        self.final_norm = L.layernorm(D, cfg.layer_norm_eps, device)

    def init(self, g: torch.Generator) -> "DinoV2":
        """The JAX init's distributions: N(0, 1) CLS token and position
        embeddings, zero mask token, torch-default Linears, unit LayerScale."""
        tinit.normal_(self.cls_token, 1.0, g)
        nn.init.zeros_(self.mask_token)
        tinit.normal_(self.pos_embed, 1.0, g)
        tinit.linear_default_(self.patch_embed, g)
        for blk in self.layers:
            blk.init(g)
        nn.init.ones_(self.final_norm.weight)
        nn.init.zeros_(self.final_norm.bias)
        return self

    def interpolate_pos_embed(self, grid_h: int, grid_w: int) -> torch.Tensor:
        """HF Dinov2 bicubic interpolation (half-pixel, no antialias, f32)."""
        pos = self.pos_embed
        n_pos = pos.shape[1] - 1
        src = int(round(n_pos ** 0.5))
        if grid_h * grid_w == n_pos and grid_h == grid_w:
            return pos
        dev = pos.device
        Wh = _bicubic_weights_on(src, grid_h, dev)
        Ww = _bicubic_weights_on(src, grid_w, dev)
        patch = pos[:, 1:].reshape(1, src, src, -1).float()
        out = torch.einsum("oh,bhwd->bowd", Wh, patch)
        out = torch.einsum("pw,bowd->bopd", Ww, out)
        out = out.reshape(1, grid_h * grid_w, -1).to(pos.dtype)
        return torch.cat([pos[:, :1], out], dim=1)

    def embed(self, images: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
        """[B, H, W, 3] -> [B, 1 + gh*gw, D]: patchify + linear, CLS, pos."""
        B, H, W, C = images.shape
        p = self.cfg.patch_size
        gh, gw = H // p, W // p
        x = images.to(compute_dtype).reshape(B, gh, p, gw, p, C)
        x = x.permute(0, 1, 3, 2, 4, 5)
        x = L.linear_apply(self.patch_embed, x.reshape(B, gh * gw, p * p * C),
                           compute_dtype)
        cls = self.cls_token.to(compute_dtype).expand(B, 1, -1)
        x = torch.cat([cls, x], dim=1)
        return x + self.interpolate_pos_embed(gh, gw).to(compute_dtype)

    def _run(self, x, start: int, stop: int, attn_impl: str, k_bias=None,
             remat: bool = False):
        for blk in self.layers[start:stop]:
            if remat:
                # the block's activations are recomputed in the backward
                # (jax.checkpoint with nothing_saveable in the JAX package):
                # memory O(one block), the forward's kernels launched twice.
                # A block draws nothing, so no RNG state is stashed (reading
                # the device's would break a captured training step)
                x = torch.utils.checkpoint.checkpoint(blk, x, attn_impl, k_bias,
                                                      use_reentrant=False,
                                                      preserve_rng_state=False)
            else:
                x = blk(x, attn_impl, k_bias)
        return x

    def apply_pipelined(self, images: torch.Tensor, mesh, *, n_micro: int = 4,
                        compute_dtype=torch.float32, attn_impl: str = "plain",
                        remat: bool = False) -> torch.Tensor:
        """The forward with the block stack under the GPipe schedule over the
        mesh's ``pipe`` axis (parallel/pipeline.py): embedding and final
        layernorm on this rank's rows, each stage's chunk of blocks on its
        rank, the output replicated to every stage. The sequential forward's
        result up to the rounding of microbatch-sized matmuls.
        Differentiable; ``remat`` recomputes each stage chunk in the
        backward."""
        from cognitive_aim_tpu_torch.parallel.pipeline import pipelined_scan

        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
        x = self.embed(images, compute_dtype)
        x = pipelined_scan(mesh, self.layers, x, lambda blk, c: blk(c, attn_impl), n_micro,
                           remat=remat)
        return L.layernorm_apply(self.final_norm, x)

    def forward(self, images: torch.Tensor, **kw) -> torch.Tensor:
        """images [B, H, W, 3] normalized NHWC -> last_hidden_state
        [B, 1 + N, D] after the final layernorm, in ``compute_dtype``.
        Arguments as ``forward_with_kept``."""
        return self.forward_with_kept(images, **kw)[0]

    def forward_with_kept(
        self, images: torch.Tensor, *, compute_dtype=torch.float32,
        attn_impl: str = "plain", remat: bool = False,
        filter_layer: int = 0, filter_keep: float = 1.0,
        filter_fuse: bool = True, filter_fuse_k: int = 1, filter_schedule=(),
        filter_rollout: float = 0.0, filter_merge: bool = False,
        filter_delta_correct: bool = False, filter_strat_stride: int = 0,
        filter_prop_attn: bool = False, filter_ctx_frac: float = 0.0,
        keep_weights: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The forward pass and the token filter's final kept set:
        (last_hidden_state [B, 1 + N, D], [B, k] ascending patch indices, or
        None when no filter stage is active). Differentiable; callers that
        serve wrap it in ``torch.no_grad()``.

        remat: recompute each block's activations in the backward
          (``torch.utils.checkpoint``), the training memory option.
        filter_layer / filter_keep: after ``filter_layer`` full blocks keep
          CLS + that share of the patch tokens; off by default.
        filter_schedule: ((layer, keep), ...), layers strictly increasing,
          keeps strictly decreasing: the progressive variant; overrides the
          pair above.
        filter_fuse / filter_fuse_k: append the importance-weighted mean of
          the dropped tokens as a context token, or one per cell of a
          sqrt(k) x sqrt(k) split of the grid.
        filter_rollout: at later stages rank by (1-r) * fresh + r * carried
          importance.
        filter_strat_stride: every (N, N)-strided grid position gets a
          priority bonus above background and below every guided tier.
        filter_prop_attn: post-filter blocks add log(number of tokens it
          stands for) to each context token's attention logit (K7 / K10b).
        filter_ctx_frac: share of the keep budget reserved for the top
          tokens by raw importance.
        keep_weights: [B, P] guidance mask weights (priority), or None.
        filter_merge: merge mode: dropped tokens are absorbed into their most
          similar kept token, and every position reads its representative's
          final value; no context tokens.
        filter_delta_correct: drop mode whose dropped positions get, at the
          end, their filter-point value plus their most similar kept token's
          update over the remaining blocks. Single stage only."""
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
        cfg = self.cfg
        n_layers = cfg.num_layers
        x = self.embed(images, compute_dtype)
        B, P = x.shape[0], x.shape[1] - 1
        schedule = tuple(filter_schedule or ())
        if not schedule and 0 < filter_layer < n_layers and 0.0 < filter_keep < 1.0:
            schedule = ((filter_layer, filter_keep),)
        # drop degenerate stages (keep >= 1 or layer out of range)
        schedule = tuple((int(l), float(k)) for l, k in schedule
                         if 0 < int(l) < n_layers and 0.0 < float(k) < 1.0)
        idx_global = None
        if not schedule:
            x = self._run(x, 0, n_layers, attn_impl, remat=remat)
            return L.layernorm_apply(self.final_norm, x), idx_global

        ls = [l for l, _ in schedule]
        kf = [k for _, k in schedule]
        if ls != sorted(set(ls)):
            raise ValueError(f"filter schedule layers must be strictly "
                             f"increasing: {schedule}")
        if any(b >= a for a, b in zip(kf, kf[1:])):
            raise ValueError(f"filter schedule keep fractions must be "
                             f"strictly decreasing: {schedule}")
        if filter_delta_correct and (filter_merge or len(schedule) > 1):
            raise ValueError(
                "filter_delta_correct ('@d') is single-stage drop-mode "
                "only (not composable with '@m' or progressive schedules)")
        if not 0.0 <= filter_ctx_frac < 1.0:
            raise ValueError(
                f"filter_ctx_frac ('@cF') must be in [0, 1) — reserving "
                f"the WHOLE budget for context leaves no guided slots "
                f"(got {filter_ctx_frac})")
        if filter_prop_attn and not (filter_fuse or filter_merge):
            raise ValueError(
                "filter_prop_attn ('@p') weights tokens by how many "
                "source tokens they represent — it needs token_filter_fuse "
                "(drop mode) or merge mode to have any such tokens")
        p_sz = cfg.patch_size
        gh, gw = images.shape[1] // p_sz, images.shape[2] // p_sz
        fuse_groups = group_onehot = None
        n_groups = max(1, int(filter_fuse_k))
        if n_groups > 1:
            q = int(round(n_groups ** 0.5))
            if q * q != n_groups:
                raise ValueError(
                    f"filter_fuse_k must be a perfect square (got "
                    f"{filter_fuse_k})")
            if filter_merge or filter_delta_correct:
                raise ValueError(
                    "filter_fuse_k > 1 is drop-mode only ('@m'/'@d' have "
                    "no fused context tokens)")
            fuse_groups, group_onehot = _fuse_groups_on(gh, gw, n_groups, x.device)
            n_groups = group_onehot.shape[1]
        if filter_strat_stride > 1:
            # +0.25 on the keep-weight scale = +2.5 priority: above
            # background (0), below the lowest guided tier (+5)
            bonus = _strat_bonus_on(gh, gw, int(filter_strat_stride), x.device)
            base = keep_weights if keep_weights is not None else 1.0
            keep_weights = (base + bonus).float().expand(B, P)
        ks = [max(1, int(round(k * P))) for k in kf]
        x_full = None
        imp_carry = None  # the surviving tokens' importance at their last ranking
        rep = None  # merge mode: [B, P] patch position -> current slot
        sizes = None  # merge mode: [B, k] merged-group sizes
        dc = None  # delta correction: (idx_drop, assign)
        k_bias = None  # proportional-attention logit bias [B, T]
        r = float(filter_rollout)
        prev = 0
        for (boundary, _), k_i in zip(schedule, ks):
            x = self._run(x, prev, boundary, attn_impl, k_bias, remat)
            prev = boundary
            if filter_merge or filter_delta_correct:
                imp, keys = _cls_importance(self.layers[boundary], x, return_keys=True)
            else:
                imp = _cls_importance(self.layers[boundary], x)
            if idx_global is None:
                if filter_merge:
                    x, idx_global, rep, sizes = _filter_tokens_merge(
                        x, imp, keys, keep_weights, k_i, ctx_frac=filter_ctx_frac)
                else:
                    x_full = x
                    x, idx_global = _filter_tokens(
                        x, imp, keep_weights, k_i, fuse=filter_fuse and k_i < P,
                        fuse_groups=fuse_groups, fuse_n_groups=n_groups,
                        ctx_frac=filter_ctx_frac)
                    if filter_delta_correct and k_i < P:
                        dc = _assign_dropped(imp, keys, idx_global, k_i)
                imp_carry = imp.gather(1, idx_global)
            else:
                k_prev = idx_global.shape[1]
                if k_i >= k_prev:
                    continue  # nothing more to drop at this stage
                kw = None
                if keep_weights is not None:
                    kw = keep_weights.gather(1, idx_global)
                if r > 0.0:
                    imp_p = (1.0 - r) * imp[:, :k_prev] + r * imp_carry
                    imp = torch.cat([imp_p, imp[:, k_prev:]], dim=1)
                if filter_merge:
                    x, idx_local, slot_map, sizes = _refilter_tokens_merge(
                        x, imp, keys, k_prev, kw, k_i, sizes, ctx_frac=filter_ctx_frac)
                    rep = slot_map.gather(1, rep)
                else:
                    # tokens dropped HERE freeze at their current values
                    x_full = _scatter_tokens(x_full.to(x.dtype), x, idx_global)
                    gg = fuse_groups[idx_global] if fuse_groups is not None else None
                    x, idx_local = _refilter_tokens(
                        x, imp, k_prev, kw, k_i, fuse=filter_fuse, groups_gathered=gg,
                        n_groups=n_groups, ctx_frac=filter_ctx_frac)
                imp_carry = imp[:, :k_prev].gather(1, idx_local)
                idx_global = idx_global.gather(1, idx_local)
            if filter_prop_attn:
                if filter_merge:
                    k_bias = _prop_bias_merge(sizes)
                elif filter_fuse and idx_global.shape[1] < P:
                    k_bias = _prop_bias_drop(idx_global, P, group_onehot)
        x = self._run(x, prev, n_layers, attn_impl, k_bias, remat)
        k_last = idx_global.shape[1]
        if filter_merge:
            # unmerge: every patch position reads its representative's final
            # value, so none carries a stale one
            x = torch.cat([x[:, :1], _take(x[:, 1:1 + k_last], rep)], dim=1)
        elif dc is not None:
            # a dropped position = its own filter-point value + its nearest kept
            # neighbour's update over the remaining blocks
            idx_drop, assign = dc
            fp = x_full.to(x.dtype)[:, 1:]
            final_kept = x[:, 1:1 + k_last]
            delta = final_kept - _take(fp, idx_global)
            corrected = _take(fp, idx_drop) + _take(delta, assign)
            D = fp.shape[-1]
            patches = fp.scatter(1, idx_global[..., None].expand(-1, -1, D), final_kept)
            patches = patches.scatter(1, idx_drop[..., None].expand(-1, -1, D), corrected)
            x = torch.cat([x[:, :1], patches], dim=1)
        else:
            x = _scatter_tokens(x_full.to(x.dtype), x, idx_global)
        return L.layernorm_apply(self.final_norm, x), idx_global
