"""Noise modes (counterpart of cognitive_aim_tpu/core/rng.py).

The model samples noise even at inference (VAE reparameterization, the
local-curiosity perturbation, the focal uniformity fallback), and dropout
under training. Every draw takes an explicit ``torch.Generator``, and
``fold_in`` derives one stream from another as ``jax.random.fold_in`` derives
a key; ``NoiseMode.ZEROS`` makes every draw
0, which is what the parity tests use, since torch cannot reproduce JAX's
random streams.
"""

from __future__ import annotations

import enum
from typing import Optional, Sequence

import numpy as np
import torch

from cognitive_aim_tpu_torch.parallel import comm


class NoiseMode(str, enum.Enum):
    SAMPLE = "sample"  # draw from N(0, I) with the given generator
    ZEROS = "zeros"  # deterministic: all stochastic draws are 0


def normal_like(
    generator: Optional[torch.Generator],
    shape: Sequence[int],
    dtype: torch.dtype,
    device: torch.device,
    mode: NoiseMode,
) -> torch.Tensor:
    """N(0, I) of ``shape`` from ``generator``; zeros under ``ZEROS`` or
    without a generator. Inside ``parallel.comm.batch_shard`` the draw is
    the global batch's, cut to this rank's rows."""
    if mode == NoiseMode.ZEROS or generator is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    full, rows = comm.global_shape(shape)
    draw = torch.randn(full, generator=generator, dtype=dtype, device=device)
    return draw if rows is None else draw[rows]


def fold_in(generator: Optional[torch.Generator], i: int) -> Optional[torch.Generator]:
    """A new generator on ``generator``'s device, seeded from its initial
    seed and ``i`` (host values: no device sync), so that one stream's draws
    do not move another's; None stays None."""
    if generator is None:
        return None
    seed = np.random.SeedSequence([generator.initial_seed(), i]).generate_state(1, np.uint64)[0]
    return torch.Generator(generator.device).manual_seed(int(seed) >> 1)
