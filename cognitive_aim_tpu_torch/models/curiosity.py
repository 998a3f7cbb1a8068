"""Variational curiosity module (counterpart of
cognitive_aim_tpu/models/curiosity.py).

The VAE samples even at inference (reparameterization, the local-curiosity
perturbation); every draw takes a ``torch.Generator`` through
``core.rng.normal_like``, and ``NoiseMode.ZEROS`` makes them 0. Under
``train`` the encoders and the decoder drop 0.1 after their hidden layer,
with masks from the same generator. The reconstruction target and the
local term's sensitivity are detached, as the JAX function stops their
gradients.
``ExplorationHistory`` is a copy of the JAX package's host-side tracker
(that module imports jax at the top).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cognitive_aim_tpu_torch.core.device import resolve_device
from cognitive_aim_tpu_torch.core.rng import NoiseMode, normal_like
from cognitive_aim_tpu_torch.nn import layers as L


class Curiosity(nn.Module):
    """latent_dim = feature_dim // 4; torch-default Linears; hierarchical
    terms (geometric, local) with learned mixing weights."""

    def __init__(self, feature_dim: int, hidden_dim: int = 128,
                 enable_hierarchical: bool = True, device=None):
        super().__init__()
        D, latent = feature_dim, feature_dim // 4
        device = resolve_device(device)
        self.encoder_mean = L.MLP([D, D // 2, latent], device)
        self.encoder_logvar = L.MLP([D, D // 2, latent], device)
        self.decoder = L.MLP([latent, D // 2, latent], device)
        self.uncertainty_head = L.MLP([D, D // 4, 1], device)
        self.hierarchical = enable_hierarchical
        if enable_hierarchical:
            self.geometric_curiosity = L.MLP([D + 4, hidden_dim, 1], device)
            self.local_curiosity = L.MLP([D, hidden_dim // 2, 1], device)
            self.curiosity_weights = nn.Parameter(torch.empty(3, device=device))

    def init(self, g: torch.Generator) -> "Curiosity":
        for m in self.children():
            m.init(g)
        if self.hierarchical:
            with torch.no_grad():
                self.curiosity_weights.copy_(torch.tensor([0.4, 0.3, 0.3]))
        return self


def curiosity_apply(mod: Curiosity, features: torch.Tensor,
                    exif_data: Optional[Dict[str, torch.Tensor]] = None, *,
                    loss_type: str = "robust", uncertainty_weight: float = 0.1,
                    kl_weight=0.1, generator=None, train: bool = False,
                    noise_mode: NoiseMode = NoiseMode.SAMPLE):
    """Returns (curiosity_reward [B], uncertainty_score [B], components).
    ``loss_type`` is the reconstruction error: 'simple' (mean square),
    'robust' (the bounded norm the forward uses) or 'huber' (delta 1).
    ``kl_weight`` is a float or a 0-d tensor (the trainer's beta schedule)."""
    drop = dict(dropout_rate=0.1, dropout_after=(0,), generator=generator, train=train)
    mu = L.mlp_apply(mod.encoder_mean, features, **drop)
    logvar = L.mlp_apply(mod.encoder_logvar, features, **drop)
    std = torch.exp(0.5 * logvar)
    eps = normal_like(generator, std.shape, std.dtype, std.device, noise_mode)
    z = mu + eps * std
    recon = L.mlp_apply(mod.decoder, z, **drop)

    diff = recon - features[:, :recon.shape[1]].detach()
    if loss_type == "simple":
        rec_err = (diff ** 2).mean(dim=1)
    elif loss_type == "robust":
        rec_err = torch.sqrt((diff ** 2).sum(dim=1) + 1e-8)
        rec_err = rec_err / (1.0 + rec_err)
    elif loss_type == "huber":
        ad = diff.abs()
        rec_err = torch.where(ad <= 1.0, 0.5 * diff ** 2, ad - 0.5).mean(dim=1)
    else:
        raise ValueError(f"Unknown loss_type: {loss_type}")

    kl = -0.5 * (1.0 + logvar - mu ** 2 - torch.exp(logvar)).sum(dim=1)
    unc = L.mlp_apply(mod.uncertainty_head, features, final_act=F.softplus)[:, 0]

    rec_err = rec_err.clamp(min=0.0)
    kl = kl.clamp(min=0.0)
    unc = unc.clamp(0.0, 10.0)
    basic = rec_err + kl_weight * kl + uncertainty_weight * unc
    components = {
        "reconstruction_error": rec_err,
        "kl_divergence": kl,
        "uncertainty_estimate": unc,
        "basic_uncertainty": basic,
        "latent_mean": mu,
        "latent_logvar": logvar,
    }
    if mod.hierarchical:
        geo = _geometric(mod, features, exif_data)
        loc = _local(mod, features, generator, noise_mode)
        w = torch.softmax(mod.curiosity_weights, dim=0)
        reward = w[0] * geo + w[1] * loc + w[2] * basic
        components.update({"geometric_uncertainty": geo,
                           "local_uncertainty": loc, "weights": w})
    else:
        reward = basic
    return reward.clamp(0.0, 100.0), basic.clamp(0.0, 100.0), components


def _geometric(mod: Curiosity, features, exif_data):
    """exif absent -> constant 0.5."""
    B = features.shape[0]
    if exif_data is None:
        return torch.full((B,), 0.5, dtype=features.dtype, device=features.device)
    zeros = torch.zeros(B, dtype=features.dtype, device=features.device)
    focal = exif_data.get("focal_length", zeros).reshape(-1)
    aperture = exif_data.get("aperture", zeros).reshape(-1)
    iso = exif_data.get("iso", zeros).reshape(-1)
    ef = torch.stack([(focal / 200.0).clamp(0.0, 1.0),
                      (aperture / 32.0).clamp(0.0, 1.0),
                      (iso / 6400.0).clamp(0.0, 1.0),
                      torch.ones_like(zeros)], dim=1)
    combined = torch.cat([features, ef.to(features.dtype)], dim=1)
    g = L.mlp_apply(mod.geometric_curiosity, combined, final_act=torch.sigmoid)
    return g[:, 0].clamp(0.0, 1.0)


def _local(mod: Curiosity, features, generator, noise_mode: NoiseMode):
    """Perturbation sensitivity of the local head."""
    base = L.mlp_apply(mod.local_curiosity, features, final_act=torch.sigmoid)[:, 0]
    noise = normal_like(generator, features.shape, features.dtype,
                        features.device, noise_mode) * 0.01
    noisy = L.mlp_apply(mod.local_curiosity, features + noise,
                        final_act=torch.sigmoid)[:, 0]
    return (base + (base - noisy).abs().detach() * 0.2).clamp(0.0, 1.0)


# ------------------------------------------------- exploration history ------
@dataclasses.dataclass
class ExplorationHistory:
    """Host-side circular buffer of rewards: capacity 1000; statistics over
    the entries > 0."""

    capacity: int = 1000

    def __post_init__(self):
        self.buffer = np.zeros(self.capacity, np.float32)
        self.pointer = 0

    def update(self, rewards):
        rewards = np.asarray(rewards).reshape(-1)
        for r in rewards:
            self.buffer[self.pointer % self.capacity] = float(r)
            self.pointer = (self.pointer + 1) % self.capacity

    def statistics(self) -> dict:
        valid = self.buffer[self.buffer > 0]
        if valid.size == 0:
            return {"mean": 0.0, "std": 0.0, "max": 0.0, "samples": 0}
        return {
            "mean": float(valid.mean()),
            "std": float(valid.std(ddof=1)) if valid.size > 1 else 0.0,
            "max": float(valid.max()),
            "min": float(valid.min()),
            "samples": int(valid.size),
        }
