"""Training losses (counterpart of cognitive_aim_tpu/train/losses.py)."""

from __future__ import annotations

import torch


def scale_invariant_loss(pred: torch.Tensor, target: torch.Tensor,
                         lambda_reg: float = 0.5) -> torch.Tensor:
    """Eigen-style SILog over all elements: mean(d^2) - lambda * mean(d)^2,
    d = log(pred + 1e-8) - log(target + 1e-8)."""
    diff = torch.log(pred + 1e-8) - torch.log(target + 1e-8)
    n = diff.numel()
    return (diff ** 2).sum() / n - lambda_reg * diff.sum() ** 2 / (n ** 2)


def curiosity_loss(curiosity_scores: torch.Tensor,
                   prediction_error: torch.Tensor) -> torch.Tensor:
    """MSE(mean over dim 1 of the curiosity, sigmoid of the DETACHED
    prediction error); a [B] curiosity is taken as it is."""
    target = torch.sigmoid(prediction_error.detach())
    scores = curiosity_scores.mean(dim=1) if curiosity_scores.ndim > 1 else curiosity_scores
    return ((scores - target) ** 2).mean()


def huber_loss(pred: torch.Tensor, target: torch.Tensor, delta: float = 0.5) -> torch.Tensor:
    diff = pred - target
    ad = diff.abs()
    return torch.where(ad <= delta, 0.5 * diff ** 2, delta * ad - 0.5 * delta ** 2).mean()


def attention_entropy_loss(entropy: torch.Tensor) -> torch.Tensor:
    """The focal attention entropy as a loss: it rewards concentration."""
    return entropy


def global_norm_clip(grads, max_norm: float = 1.0):
    """Scale a list of gradients by min(1, max_norm / (norm + 1e-6)); returns
    (scaled list, global norm)."""
    gn = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    scale = torch.clamp(max_norm / (gn + 1e-6), max=1.0)
    return [g * scale for g in grads], gn
