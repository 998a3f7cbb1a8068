"""DINOv2 ViT backbone (counterpart of cognitive_aim_tpu/nn/dinov2.py).

The unfiltered inference path only:

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
tensors); ``attn_impl="plain"`` always takes the plain version, which is
what the kernel is compared with on the card. Everything runs in the
policy's compute dtype, as the JAX package casts the parameters to it.

Under the int8 policy ``Block.quantize_`` replaces the four dense
projections by their int8 state, and the block runs as the JAX package's
chained int8 block: K2 ``int8_qkv_proj_ln`` -> K1 -> K3
``int8_out_residual`` -> K4 ``int8_mlp_ln`` (kernels/int8_block.py), with no
bare elementwise op between them. ``attn_impl="plain"`` runs the plain
versions of the same four steps. The chained block needs tanh GELU, as in
the JAX package; its per-projection int8 path for erf GELU is not ported.

LoRA, the token filter and pipelining are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from cognitive_aim_tpu_torch.core.device import resolve_device
from cognitive_aim_tpu_torch.kernels import int8_block as IB
from cognitive_aim_tpu_torch.kernels.flash_attention import (
    flash_attention_packed,
    flash_attention_packed_plain,
)
from cognitive_aim_tpu_torch.nn import init as tinit
from cognitive_aim_tpu_torch.nn import layers as L
from cognitive_aim_tpu_torch.nn.torch_interp import resize_weights

ATTN_IMPLS = ("pallas_packed", "plain")


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

    def init(self, g: torch.Generator):
        for ln in (self.norm1, self.norm2):
            nn.init.ones_(ln.weight)
            nn.init.zeros_(ln.bias)
        # q, k, v are torch-default Linears(D, D): fan_in D for all three,
        # so the stacked [3D, D] weight draws from the same U(-b, b)
        for lin in (self.qkv, self.attn_out, self.fc1, self.fc2):
            tinit.linear_default_(lin, g)
        nn.init.constant_(self.ls1, self.cfg.layerscale_value)
        nn.init.constant_(self.ls2, self.cfg.layerscale_value)

    def qkv_proj(self, x: torch.Tensor):
        """One [D, 3D] GEMM that writes q, k and v as three contiguous
        [B, N, D] slices of one buffer, the layout K1 reads."""
        B, N, D = x.shape
        w = self.qkv.weight.to(x.dtype).view(3, D, D).transpose(1, 2)
        b = self.qkv.bias.to(x.dtype).view(3, 1, D)
        qkv = torch.baddbmm(b, x.reshape(1, B * N, D).expand(3, B * N, D), w)
        return [t.view(B, N, D) for t in qkv.unbind(0)]

    def mhsa(self, x: torch.Tensor, attn_impl: str) -> torch.Tensor:
        cfg = self.cfg
        q, k, v = self.qkv_proj(x)
        attend = (flash_attention_packed if attn_impl == "pallas_packed"
                  else flash_attention_packed_plain)
        ctx = attend(q, k, v, cfg.head_dim ** -0.5, cfg.num_heads)
        return L.linear_apply(self.attn_out, ctx, ctx.dtype)

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
        return self

    def _forward_int8(self, x: torch.Tensor, attn_impl: str) -> torch.Tensor:
        cfg = self.cfg
        if not cfg.gelu_approx:
            raise NotImplementedError(
                "the chained int8 block needs tanh GELU; the per-projection "
                "int8 path for erf GELU is not ported yet (ROADMAP.md)")
        fused = attn_impl == "pallas_packed"
        n1, n2, eps = self.norm1, self.norm2, cfg.layer_norm_eps
        qkv_ln = IB.int8_qkv_proj_ln if fused else IB.int8_qkv_proj_ln_plain
        attend = flash_attention_packed if fused else flash_attention_packed_plain
        out_res = IB.int8_out_residual if fused else IB.int8_out_residual_plain
        mlp_ln = IB.int8_mlp_ln if fused else IB.int8_mlp_ln_plain
        q, k, v = qkv_ln(x, n1.weight, n1.bias, self.qkv.wq, self.qkv.ws,
                         self.qkv.bias, eps, x.dtype)
        ctx = attend(q, k, v, cfg.head_dim ** -0.5, cfg.num_heads)
        x = out_res(ctx, self.attn_out.wq, self.attn_out.ws, self.attn_out.bias,
                    self.ls1, x)
        return mlp_ln(x, n2.weight, n2.bias, self.fc1.wq, self.fc1.ws, self.fc1.bias,
                      self.fc2.wq, self.fc2.ws, self.fc2.bias, self.ls2, eps)

    def forward(self, x: torch.Tensor, attn_impl: str) -> torch.Tensor:
        if self.quantized:
            return self._forward_int8(x, attn_impl)
        dt = x.dtype
        h = L.layernorm_apply(self.norm1, x)
        x = x + self.ls1.to(dt) * self.mhsa(h, attn_impl)
        h = L.layernorm_apply(self.norm2, x)
        h = L.linear_apply(self.fc1, h, dt)
        h = F.gelu(h, approximate="tanh" if self.cfg.gelu_approx else "none")
        return x + self.ls2.to(dt) * L.linear_apply(self.fc2, h, dt)


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
        Wh = torch.from_numpy(resize_weights(src, grid_h, "bicubic").copy()).to(dev)
        Ww = torch.from_numpy(resize_weights(src, grid_w, "bicubic").copy()).to(dev)
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

    @torch.no_grad()
    def forward(self, images: torch.Tensor, *, compute_dtype=torch.float32,
                attn_impl: str = "plain") -> torch.Tensor:
        """images [B, H, W, 3] normalized NHWC -> last_hidden_state
        [B, 1 + N, D] after the final layernorm, in ``compute_dtype``."""
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {attn_impl!r} not in {ATTN_IMPLS}")
        x = self.embed(images, compute_dtype)
        for blk in self.layers:
            x = blk(x, attn_impl)
        return L.layernorm_apply(self.final_norm, x)
