"""Inputs and weights made from the run's seed: the same seed gives the same
images, EXIF scalars, instructions, arrivals and weights.

Large tensors are drawn on the run's device from a ``torch.Generator`` in one
call each; the small per-image scalars on the host from numpy."""

from __future__ import annotations

import math
import zlib
from typing import Dict, Tuple

import numpy as np
import torch

from benchmark.reference.layout import Dims

N_INSTRUCTIONS = 9


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    state = np.random.SeedSequence([seed % 2 ** 64, zlib.crc32(tag.encode())])
    return int(state.generate_state(1, np.uint64)[0]) >> 1


def images_u8(n: int, size: int, seed: int, tag: str, device) -> torch.Tensor:
    """[n, size, size, 3] uint8 on ``device``, uniform pixels."""
    g = torch.Generator(device).manual_seed(sub_seed(seed, tag))
    return torch.randint(0, 256, (n, size, size, 3), generator=g, dtype=torch.uint8,
                         device=device)


def exif(n: int, seed: int, tag: str, num_cameras: int) -> Dict[str, np.ndarray]:
    """Each image's EXIF scalars: a camera of the table, a focal length of
    8-200 mm, an f-number of 1.4-16 and an ISO of 50-6400, the last three
    log-uniform."""
    rng = np.random.default_rng(sub_seed(seed, tag))

    def logu(lo, hi):
        return np.exp(rng.uniform(math.log(lo), math.log(hi), n)).astype(np.float32)

    return {"camera_idx": rng.integers(0, num_cameras, n).astype(np.int32),
            "focal_length": logu(8.0, 200.0), "aperture": logu(1.4, 16.0),
            "iso": logu(50.0, 6400.0)}


def instructions(n: int, seed: int, tag: str) -> np.ndarray:
    """Instruction indices drawn uniformly from the 9."""
    return np.random.default_rng(sub_seed(seed, tag)).integers(0, N_INSTRUCTIONS, n)


def weights(ref, d: Dims, seed: int, device) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """The float32 parameters of the reference module ``ref``'s model in the
    flat layout, drawn on ``device`` in one call (keys in sorted order,
    each by ``ref.rule``) and copied to the host in one: (the host buffer,
    key -> a view of it)."""
    shapes = ref.param_shapes(d)
    keys = sorted(shapes)
    sizes = [math.prod(shapes[k]) for k in keys]
    g = torch.Generator(device).manual_seed(sub_seed(seed, "weights"))
    buf = torch.rand(sum(sizes), generator=g, device=device).mul_(2.0).sub_(1.0)
    off = 0
    for k, n in zip(keys, sizes):
        centre, half = ref.rule(k, shapes)
        buf[off:off + n].mul_(half).add_(centre)
        off += n
    host = buf.cpu().numpy()
    del buf
    flat, off = {}, 0
    for k, n in zip(keys, sizes):
        flat[k] = host[off:off + n].reshape(shapes[k])
        off += n
    return host, flat


def on_device(flat: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in flat.items()}
