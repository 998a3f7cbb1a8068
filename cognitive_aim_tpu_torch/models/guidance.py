"""9-way spatial guidance masks (counterpart of
cognitive_aim_tpu/models/guidance.py).

``_mask_table_np`` is a numpy copy of the JAX package's table function (that
module imports jax.numpy at the top): ``center`` uses radial tiers 3.0 inside
r = g//4 and 1.5 inside 2r; the eight directions a circular focus at
grid-fraction anchors with 5.0 inside r = g//6 and 2.0 inside 2r;
background 1.0. A patch count that is not g*g is met by a bilinear resize.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from cognitive_aim_tpu_torch.core.device import resolve_device
from cognitive_aim_tpu_torch.nn.torch_interp import resize_weights

# Instruction order is the public vocabulary (demo.py --instruction).
INSTRUCTIONS = (
    "center",
    "left",
    "right",
    "top",
    "bottom",
    "top-left",
    "top-right",
    "bottom-left",
    "bottom-right",
)

_ALIASES = {
    "topleft": "top-left",
    "topright": "top-right",
    "bottomleft": "bottom-left",
    "bottomright": "bottom-right",
}


def instruction_index(name: str) -> int:
    """Map an instruction string (case-insensitive, aliases accepted) to its
    table row."""
    key = name.lower()
    key = _ALIASES.get(key, key)
    return INSTRUCTIONS.index(key)


def _focus_anchor(g: int, instruction: str) -> tuple[int, int]:
    """(focus_y, focus_x) by integer division of the grid."""
    q, h, t = g // 4, g // 2, g * 3 // 4
    return {
        "left": (h, q),
        "right": (h, t),
        "top": (q, h),
        "bottom": (t, h),
        "top-left": (q, q),
        "top-right": (q, t),
        "bottom-left": (t, q),
        "bottom-right": (t, t),
    }[instruction]


@functools.lru_cache(maxsize=32)
def _mask_table_np(g: int) -> np.ndarray:
    """[9, g, g] float32; row order = INSTRUCTIONS."""
    yy, xx = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
    table = np.ones((len(INSTRUCTIONS), g, g), np.float32)

    cy = cx = g // 2
    r = max(1, g // 4)
    dist = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
    m = np.ones((g, g), np.float32)
    m[dist <= 2 * r] = 1.5
    m[dist <= r] = 3.0
    table[0] = m

    r = max(1, g // 6)
    for i, name in enumerate(INSTRUCTIONS[1:], start=1):
        fy, fx = _focus_anchor(g, name)
        dist = np.sqrt((yy - fy) ** 2 + (xx - fx) ** 2)
        m = np.ones((g, g), np.float32)
        m[dist <= 2 * r] = 2.0
        m[dist <= r] = 5.0
        table[i] = m
    table.setflags(write=False)
    return table


@functools.lru_cache(maxsize=32)
def mask_table(grid_size: int, num_patches: int | None = None,
               device=None) -> torch.Tensor:
    """[9, N] float32 guidance table for a grid_size x grid_size layout; if
    num_patches differs from grid_size**2 the mask is bilinearly resized to
    the sqrt(num_patches) grid. Cached per device; callers must not write
    to it."""
    table = _mask_table_np(grid_size)
    if num_patches is not None and num_patches != grid_size * grid_size:
        tgt = int(math.sqrt(num_patches))
        Wh = resize_weights(grid_size, tgt, "bilinear")
        table = np.einsum("oh,khw->kow", Wh, table)
        table = np.einsum("pw,kow->kop", Wh, table)
    flat = np.ascontiguousarray(table.reshape(len(INSTRUCTIONS), -1), np.float32)
    return torch.from_numpy(flat.copy()).to(device)


def guidance_vector(instruction: str, num_patches: int, device=None) -> torch.Tensor:
    """[N] float32 guidance weights for one instruction; the patch layout is
    taken to be square, a grid of int(sqrt(N)). On the CUDA device unless the
    caller passes ``device``."""
    g = int(math.sqrt(num_patches))
    table = mask_table(g, num_patches, resolve_device(device))
    return table[instruction_index(instruction)].clone()
