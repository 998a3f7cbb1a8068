"""Cognitive streams: ambient, focal, iterative focal, EXIF prior
(counterpart of cognitive_aim_tpu/models/streams.py).

The focal streams run in the compute dtype of their input, with their
parameters rounded to it, as the JAX package casts the focal-stream tree to
the policy's compute dtype. Their softmax and every attention view stay f32.
With ``fused_attention=True`` the N x N attention goes through the K6
wrapper (the CUDA kernel for CUDA tensors, its plain version for CPU
tensors); otherwise through the plain version.

Under the int8 policy a focal stream also carries ``qkv_i8``, its q, k and
v projections as one int8 [3D, D] weight, and projects through K5
``int8_qkv_proj`` (its plain version when ``fused_attention`` is off; the
JAX package's unfused path keeps the three float projections there).

Under ``train`` the ambient MLP, each focal projection and the EXIF fusion
drop 0.1 after their first hidden layer (masks from the ``generator``, none
without one), and the focal stream returns its attention entropy, the
training regulariser; at inference the entropy is 0.0, as in JAX.

``focal_pos_encoding_np`` and ``center_bias_np`` are numpy copies of the JAX
package's cached tables (that module imports jax at the top).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from cognitive_aim_tpu_torch.core.device import resolve_device
from cognitive_aim_tpu_torch.core.rng import NoiseMode, normal_like
from cognitive_aim_tpu_torch.kernels import int8_block as IB
from cognitive_aim_tpu_torch.kernels.focal_attention import (
    focal_attention_fused,
    focal_attention_plain,
)
from cognitive_aim_tpu_torch.nn import init as tinit
from cognitive_aim_tpu_torch.nn import layers as L


# ------------------------------------------------ static constant tables ----
@functools.lru_cache(maxsize=32)
def focal_pos_encoding_np(num_patches: int, patch_dim: int) -> np.ndarray:
    """Sin/cos 2-D positional encoding for square layouts, 1-D otherwise."""
    pe = np.zeros((num_patches, patch_dim), np.float32)
    g = int(num_patches**0.5)
    if g * g == num_patches:
        if patch_dim >= 4:
            half = patch_dim // 2
            div = np.exp(
                np.arange(0, half, 2, dtype=np.float32) * -(math.log(10000.0) / half)
            )
            rows = (np.arange(num_patches) // g).astype(np.float32)[:, None]
            cols = (np.arange(num_patches) % g).astype(np.float32)[:, None]
            if div.size > 0:
                pe[:, 0:half:2] = np.sin(rows * div)
                pe[:, 1:half:2] = np.cos(rows * div)
                pe[:, half::2] = np.sin(cols * div)
                pe[:, half + 1 :: 2] = np.cos(cols * div)
    else:
        pos = np.arange(num_patches, dtype=np.float32)[:, None]
        div = np.exp(
            np.arange(0, patch_dim, 2, dtype=np.float32)
            * -(math.log(10000.0) / patch_dim)
        )
        if div.size > 0:
            pe[:, 0::2] = np.sin(pos * div)
            if patch_dim > 1:
                pe[:, 1::2] = np.cos(pos * div)[:, : pe[:, 1::2].shape[1]]
    pe.setflags(write=False)
    return pe


@functools.lru_cache(maxsize=32)
def center_bias_np(num_patches: int, center_strength: float = 0.3) -> np.ndarray:
    """Gaussian center-bias mask: 2-D with sigma = grid/6 for square
    layouts, 1-D with sigma = N/12 otherwise."""
    g = int(num_patches**0.5)
    if g * g != num_patches:
        center = num_patches // 2
        pos = np.arange(num_patches, dtype=np.float32)
        dist = np.abs(pos - center)
        sigma = num_patches / 12.0
        out = (np.exp(-(dist**2) / (2 * sigma**2)) * center_strength).astype(np.float32)
    else:
        c = g // 2
        yy, xx = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
        dist = np.sqrt((xx - c).astype(np.float32) ** 2 + (yy - c).astype(np.float32) ** 2)
        sigma = g / 6.0
        bias = np.exp(-(dist**2) / (2 * sigma**2)).reshape(-1)
        out = (bias * center_strength).astype(np.float32)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=16)
def _pos_encoding(num_patches: int, patch_dim: int, device, dtype) -> torch.Tensor:
    """Device copy of focal_pos_encoding_np, made once per shape and device
    (read-only: callers never write to it)."""
    pe = focal_pos_encoding_np(num_patches, patch_dim).copy()
    return torch.from_numpy(pe).to(device=device, dtype=dtype)


@functools.lru_cache(maxsize=16)
def _center_bias(num_patches: int, device) -> torch.Tensor:
    return torch.from_numpy(center_bias_np(num_patches).copy()).to(device)


# -------------------------------------------------------- AmbientStream -----
class AmbientStream(nn.Module):
    """MLP input -> 256 -> 128 -> 64 on the CLS token."""

    def __init__(self, input_dim: int, hidden_dim: int = 256, device=None):
        super().__init__()
        self.mlp = L.MLP([input_dim, hidden_dim, hidden_dim // 2, hidden_dim // 4], device)

    def init(self, g: torch.Generator) -> "AmbientStream":
        self.mlp.init(g)
        return self


def ambient_apply(mod: AmbientStream, cls_token: torch.Tensor, *, generator=None,
                  train: bool = False) -> torch.Tensor:
    # Sequential(Linear, ReLU, Dropout(0.1), Linear, ReLU, Linear)
    return L.mlp_apply(mod.mlp, cls_token, dropout_rate=0.1, dropout_after=(0,),
                       generator=generator, train=train)


# ---------------------------------------------------------- FocalStream -----
class FocalStream(nn.Module):
    def __init__(self, patch_dim: int, hidden_dim: int = 256, num_heads: int = 8,
                 curiosity_guided: bool = True, device=None):
        super().__init__()
        D = patch_dim
        device = resolve_device(device)
        self.query_proj = L.linear(D, D, device)
        self.key_proj = L.linear(D, D, device)
        self.value_proj = L.linear(D, D, device)
        self.projection = L.MLP([D, hidden_dim, hidden_dim // 4], device)
        self.adaptive_weight = nn.Parameter(torch.empty((), device=device))
        if curiosity_guided:
            self.curiosity_modulator = L.MLP([1, hidden_dim // 8, num_heads], device)

    def init(self, g: torch.Generator, diversity: Optional[float] = None) -> "FocalStream":
        """FocalStream's own init (q, k xavier_normal gain 2.0 with
        U(-0.05, 0.05) bias; v gain 1.0, zero bias; xavier_uniform gain 0.8
        heads with zero bias; adaptive_weight 0.5). With ``diversity`` d
        (iterative members, d = 1 + 0.1 i) q, k take gain 1.2 d with
        U(-0.01 d, 0.01 d) bias and v gain d."""
        qk_gain, qk_b, v_gain = 2.0, 0.05, 1.0
        if diversity is not None:
            qk_gain, qk_b, v_gain = 1.2 * diversity, 0.01 * diversity, diversity
        for lin in (self.query_proj, self.key_proj):
            tinit.xavier_normal_(lin.weight, qk_gain, g)
            tinit.uniform_(lin.bias, -qk_b, qk_b, g)
        tinit.xavier_normal_(self.value_proj.weight, v_gain, g)
        nn.init.zeros_(self.value_proj.bias)
        heads = [self.projection]
        if hasattr(self, "curiosity_modulator"):
            heads.append(self.curiosity_modulator)
        _xavier_heads(heads, g)
        nn.init.constant_(self.adaptive_weight, 0.5)
        return self

    @torch.no_grad()
    def fused_qkv_int8(self, round_dtype: torch.dtype) -> L.Int8Linear:
        """The q, k, v projections as one int8 [3D, D] projection, quantised
        from the float32 weights (call before any cast); attach the result
        as ``qkv_i8`` after the cast."""
        lins = (self.query_proj, self.key_proj, self.value_proj)
        return L.Int8Linear.from_float(torch.cat([l.weight for l in lins], 0),
                                       torch.cat([l.bias for l in lins], 0),
                                       round_dtype)


def _xavier_heads(mlps, g: torch.Generator):
    for mlp in mlps:
        for i in range(mlp.n):
            tinit.xavier_uniform_(mlp.layer(i).weight, 0.8, g)
            nn.init.zeros_(mlp.layer(i).bias)


def focal_apply(mod: FocalStream, patch_tokens: torch.Tensor,
                curiosity_score: Optional[torch.Tensor] = None, *,
                num_heads: int = 8, curiosity_guided: bool = True,
                generator=None, train: bool = False,
                noise_mode: NoiseMode = NoiseMode.SAMPLE,
                fused_attention: bool = False):
    """Returns (focal_features [B, 64] f32, attention [B, N] f32, entropy):
    a 0-d f32 tensor, the batch mean of the attention's entropy under
    ``train``, 0.0 otherwise (the JAX function's values).

    Under the int8 policy the projections are one quantising GEMM on either
    route: ``fused_attention`` launches K5 ``int8_qkv_proj``, and the plain
    route (``attn_impl="plain"``) runs its plain twin ``int8_qkv_proj_plain``,
    the same arithmetic, held against the JAX kernel by
    tests/test_torch_int8.py::test_qkv_proj_matches_jax_kernel. The port has
    no ``xla`` route: where the JAX function, not fused, takes its three float
    projections, the port's plain route is still the kernel's twin."""
    B, N, D = patch_tokens.shape
    dt = patch_tokens.dtype
    dev = patch_tokens.device
    x = patch_tokens + _pos_encoding(N, D, dev, dt)[None]
    if hasattr(mod, "qkv_i8"):  # int8 policy: one fused quantising GEMM
        i8 = mod.qkv_i8
        qkv = IB.int8_qkv_proj if fused_attention else IB.int8_qkv_proj_plain
        q, k, v = qkv(x, i8.wq, i8.ws, i8.bias, dt)
    else:
        q = L.linear_apply(mod.query_proj, x, dt)
        k = L.linear_apply(mod.key_proj, x, dt)
        v = L.linear_apply(mod.value_proj, x, dt)
    scale = math.sqrt(D // num_heads)  # a divisor, single-head
    attend = focal_attention_fused if fused_attention else focal_attention_plain
    attended, colmean, adiag, armax = attend(q, k, v, scale)

    # per-patch attention: column mean + center bias, then the uniformity
    # fallbacks; torch_var is unbiased over the whole batch
    cb = _center_bias(N, dev)[None]
    pa = colmean + cb
    pa = torch.where(L.torch_var(pa) < 1e-6, adiag + cb, pa)
    pa = torch.where(L.torch_var(pa) < 1e-6, armax + cb, pa)
    norms = torch.linalg.vector_norm(x.float(), dim=-1)
    nstd = L.torch_std(norms)  # unbiased, over all elements of the batch
    noise = normal_like(generator, norms.shape, norms.dtype, dev, noise_mode) * 0.1 * nstd
    pa = torch.where(L.torch_var(pa) < 1e-6, norms + noise, pa)
    pa = pa / (pa.sum(-1, keepdim=True) + 1e-8)

    if curiosity_guided and curiosity_score is not None and hasattr(mod, "curiosity_modulator"):
        m = L.mlp_apply(mod.curiosity_modulator, curiosity_score[:, None],
                        final_act=torch.sigmoid, param_dtype=dt)
        cw = m.mean(-1, keepdim=True)
        w = mod.adaptive_weight.to(dt)
        final = w * (pa * (1.0 + cw)) + (1.0 - w) * pa
    else:
        final = pa
    final = final.clamp(min=1e-8)
    final = final / (final.sum(-1, keepdim=True) + 1e-8)

    entropy = torch.zeros((), dtype=final.dtype, device=dev)
    if train:
        entropy = (-(final * torch.log(final + 1e-8)).sum(-1)).mean()

    weighted = (attended.float() * final[..., None]).sum(dim=1)
    feats = L.mlp_apply(mod.projection, weighted, param_dtype=dt, dropout_rate=0.1,
                        dropout_after=(0,), generator=generator, train=train)
    return feats, final, entropy


# ------------------------------------------------- IterativeFocalStream -----
class IterativeFocalStream(nn.Module):
    def __init__(self, patch_dim: int, hidden_dim: int = 256, num_iterations: int = 2,
                 curiosity_guided: bool = True, device=None):
        super().__init__()
        out_dim = hidden_dim // 4
        device = resolve_device(device)
        self.streams = nn.ModuleList(
            FocalStream(patch_dim, hidden_dim, 8, curiosity_guided, device)
            for _ in range(num_iterations))
        self.initial_focus = nn.Parameter(torch.empty(1, patch_dim, device=device))
        self.fusion = L.MLP([out_dim * num_iterations, hidden_dim // 2, out_dim], device)
        if curiosity_guided:
            self.curiosity_amplifier = L.MLP([1, 32, num_iterations], device)

    def init(self, g: torch.Generator) -> "IterativeFocalStream":
        for i, s in enumerate(self.streams):
            s.init(g, diversity=1.0 + 0.1 * i)
        tinit.normal_(self.initial_focus, 0.02, g)
        heads = [self.fusion]
        if hasattr(self, "curiosity_amplifier"):
            heads.append(self.curiosity_amplifier)
        _xavier_heads(heads, g)
        return self


def iterative_focal_apply(mod: IterativeFocalStream, patch_tokens: torch.Tensor,
                          curiosity_score: Optional[torch.Tensor] = None, *,
                          focus_strength: float = 0.1, curiosity_guided: bool = True,
                          generator=None, train: bool = False,
                          noise_mode: NoiseMode = NoiseMode.SAMPLE,
                          fused_attention: bool = False):
    """Returns (fused_features [B, 64] f32, last attention [B, N] f32,
    entropy): a 0-d f32 tensor, the members' mean entropy under ``train``,
    0.0 otherwise."""
    dt = patch_tokens.dtype
    iter_w = None
    if curiosity_guided and curiosity_score is not None and hasattr(mod, "curiosity_amplifier"):
        iter_w = torch.softmax(
            L.mlp_apply(mod.curiosity_amplifier, curiosity_score[:, None], param_dtype=dt),
            dim=-1)
    n = len(mod.streams)
    feats, ents = [], []
    cur = patch_tokens
    attn = None
    for i, sp in enumerate(mod.streams):
        ic = curiosity_score if iter_w is None else curiosity_score * iter_w[:, i]
        f, attn, ent = focal_apply(sp, cur, ic, curiosity_guided=curiosity_guided,
                                   generator=generator, train=train, noise_mode=noise_mode,
                                   fused_attention=fused_attention)
        feats.append(f)
        ents.append(ent)
        if i < n - 1:  # re-focus through f32 and back
            cur = (cur.float() * (1.0 + focus_strength * attn[..., None])).to(dt)
    fused = L.mlp_apply(mod.fusion, torch.cat(feats, dim=1), param_dtype=dt)
    entropy = torch.stack(ents).mean() if train else ents[-1]
    return fused, attn, entropy


# ---------------------------------------------------- EXIFPriorDatabase -----
class ExifPrior(nn.Module):
    def __init__(self, num_cameras: int, hidden_dim: int = 256, device=None):
        super().__init__()
        self.camera_embedding = L.embedding(num_cameras, 64, device)
        self.exif_encoder = L.MLP([3, 64, 64], device)
        self.fusion = L.MLP([128, hidden_dim, hidden_dim // 4], device)

    def init(self, g: torch.Generator) -> "ExifPrior":
        tinit.normal_(self.camera_embedding.weight, 1.0, g)  # nn.Embedding: N(0, 1)
        self.exif_encoder.init(g)
        self.fusion.init(g)
        return self


def exif_prior_apply(mod: ExifPrior, exif_data: Dict[str, torch.Tensor], *,
                     generator=None, train: bool = False) -> torch.Tensor:
    """exif_data: 'camera_idx' int [B]; 'focal_length', 'aperture', 'iso'
    float [B], passed through as given."""
    cam = L.embedding_apply(mod.camera_embedding, exif_data["camera_idx"].long())
    cont = torch.stack([exif_data["focal_length"], exif_data["aperture"],
                        torch.log(exif_data["iso"] + 1.0)], dim=1).float()
    ef = L.mlp_apply(mod.exif_encoder, cont)
    return L.mlp_apply(mod.fusion, torch.cat([cam, ef], dim=1), dropout_rate=0.1,
                       dropout_after=(0,), generator=generator, train=train)
