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
from typing import Dict, Optional, Sequence

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


def fold_seed(seed: int, i: int) -> int:
    """The seed of stream ``i`` folded out of ``seed`` (host values)."""
    return int(np.random.SeedSequence([seed, i]).generate_state(1, np.uint64)[0]) >> 1


class Streams:
    """A generator's folded streams made ahead: ``fold_in(streams, i)`` is
    ``generators[i]``, where ``fold_in(g, i)`` would make a new generator.
    A captured training step draws from generators registered with its
    graph, which the host seeds before each replay with ``fold_seed`` of
    the step's generator: the replay draws what the eager ``fold_in`` chain
    draws."""

    def __init__(self, generators: Dict[int, torch.Generator]):
        self.generators = generators

    def fold(self, i: int) -> torch.Generator:
        if i not in self.generators:
            raise KeyError(f"stream {i} was not made ahead (streams {sorted(self.generators)})")
        return self.generators[i]


def fold_in(generator, i: int) -> Optional[torch.Generator]:
    """A new generator on ``generator``'s device, seeded from its initial
    seed and ``i`` (host values: no device sync), so that one stream's draws
    do not move another's; None stays None; of ``Streams``, stream ``i``."""
    if generator is None:
        return None
    if isinstance(generator, Streams):
        return generator.fold(i)
    return torch.Generator(generator.device).manual_seed(fold_seed(generator.initial_seed(), i))
