"""The variational KL beta schedule and the weight-decay schedule the
configs declare (counterpart of cognitive_aim_tpu/train/schedules.py, which
imports nothing of jax; a copy, as this package imports none of that one)."""

from __future__ import annotations

import math


def beta_schedule(name: str, start: float, end: float, total_epochs: int):
    """Returns beta(epoch) for the curiosity KL weight."""
    total = max(1, total_epochs - 1)

    def constant(_):
        return end

    def linear(e):
        t = min(e / total, 1.0)
        return start + (end - start) * t

    def cosine(e):
        t = min(e / total, 1.0)
        return start + (end - start) * (1.0 - math.cos(math.pi * t)) / 2.0

    return {"constant": constant, "linear": linear, "cosine": cosine}[name]


def weight_decay_schedule(name: str, start: float, end: float, total_epochs: int):
    return beta_schedule(name, start, end, total_epochs)
