"""What the certification modules share: the fixed normalised EXIF every
cell trains and measures with, the backbone overrides of the scripts' ``--layers`` / ``--tiny`` flags, the flat float32
npz, the AbsRel metric and a no-grad forward's depths.

The scripts' default paths (scene caches, checkpoints, result JSONs) lie
under ``build/certify/`` of the checkout, which git ignores.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cognitive_aim_tpu_torch.api import flatten_tree, npz_meta, unflatten_npz
from cognitive_aim_tpu_torch.convert import load_flat_params
from cognitive_aim_tpu_torch.core.rng import NoiseMode
from cognitive_aim_tpu_torch.models.config import ModelArchConfig
from cognitive_aim_tpu_torch.nn.dinov2 import BASE, DinoV2Config

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BUILD = os.path.join(ROOT, "build", "certify")

# NORMALISED exif (io/exif.py divides raw values by 200 / 22 / 6400): the
# constants every cell trains and is measured with
EXIF = {"camera_idx": 0, "focal_length": 0.25, "aperture": 0.127, "iso": 0.016}


def exif_numpy(B: int) -> Dict[str, np.ndarray]:
    return {"camera_idx": np.zeros(B, np.int32),
            "focal_length": np.full(B, EXIF["focal_length"], np.float32),
            "aperture": np.full(B, EXIF["aperture"], np.float32),
            "iso": np.full(B, EXIF["iso"], np.float32)}


def exif_batch(B: int, device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in exif_numpy(B).items()}


def vit_config(layers: int = 0, tiny: bool = False,
               image_size: int = 518) -> Optional[DinoV2Config]:
    """The scripts' backbone override: None (the arch's own ViT-B or ViT-L)
    unless ``layers`` or ``tiny``; then ViT-B's config with ``layers`` blocks,
    and with ``tiny`` D 64, 4 heads and a pretrain grid of ``image_size``."""
    if not (layers or tiny):
        return None
    kw = {"num_layers": layers or BASE.num_layers}
    if tiny:
        kw.update(hidden_size=64, num_heads=4, pretrain_image_size=image_size)
    return dataclasses.replace(BASE, **kw)


def arch(image_size: int, backbone: str = "base", **kw) -> ModelArchConfig:
    """The certification recipe's architecture: 6 focal iterations, the
    backbone trainable, no adapters unless ``kw`` adds them."""
    return ModelArchConfig(**{"num_iterations": 6, "image_size": image_size,
                              "freeze_backbone": False, "use_lora": False,
                              "backbone_size": backbone, **kw})


def load_flat(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """(the flat float32 interchange, the '__meta__/*' stamps) of an npz."""
    with np.load(path) as z:
        return unflatten_npz(z), npz_meta(z)


def save_flat(path: str, flat: Dict[str, np.ndarray]):
    """Write through a temporary file and a rename, so a reader never finds
    half a checkpoint."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flatten_tree(flat))
    os.replace(tmp, path)


def load_into(model, flat: Dict[str, np.ndarray]):
    """``load_flat_params`` without the ``filterpath/`` overlay, which no
    model of these scripts holds as parameters."""
    return load_flat_params(model, {k: v for k, v in flat.items()
                                    if not k.startswith("filterpath/")})


def absrel(pred: np.ndarray, gt: np.ndarray) -> float:
    pred, gt = np.asarray(pred, np.float64), np.asarray(gt, np.float64)
    return float(np.mean(np.abs(pred - gt) / np.maximum(np.abs(gt), 1e-6)))


@torch.no_grad()
def depths(model, x: torch.Tensor, guidance=None, generator=None,
           noise_mode: NoiseMode = NoiseMode.ZEROS) -> torch.Tensor:
    """[B] depths of one inference forward on the device (no host sync)."""
    B = x.shape[0]
    if guidance is not None and not torch.is_tensor(guidance):
        guidance = torch.full((B,), int(guidance), dtype=torch.long, device=x.device)
    out = model(x, exif_batch(B, x.device), guidance=guidance, generator=generator,
                noise_mode=noise_mode)
    return out.depth[:, 0]
