"""Where modules are built: on the card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device and raises where there is none; nothing
    falls back to the CPU by itself. The CPU tests pass ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: this package builds its modules on the GPU by "
                "default; pass device='cpu' to build them on the CPU")
        return torch.device("cuda")
    return torch.device(device)
