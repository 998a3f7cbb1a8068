"""Image preprocessing (counterpart of cognitive_aim_tpu/io/preprocess.py).

Two routes, as in the JAX package:

  * on the device: ``resize_normalize`` takes uint8 [B, H, W, 3] to a
    normalized float32 [B, out_h, out_w, 3] (a bilinear half-pixel resize as
    two static resize matrices, then ImageNet normalization), and
    ``normalize_u8`` is the /255 + ImageNet step alone, for images the
    native loader already resized on the host;
  * on the host: ``load_image_uint8`` decodes with PIL, ``pil_resize_host``
    is PIL's antialiased bilinear resize (what ``predict`` serves), and
    ``normalize_np`` / ``preprocess_paths`` normalize in numpy.

The layout is NHWC, as in the JAX package. PIL is imported inside the
functions that need it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cognitive_aim_tpu_torch.nn.torch_interp import resize_weights

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
IMAGENET_MEAN_NP = np.asarray(IMAGENET_MEAN, np.float32)
IMAGENET_STD_NP = np.asarray(IMAGENET_STD, np.float32)


def resize_normalize(images_u8: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    if images_u8.dtype != torch.uint8 or images_u8.ndim != 4 or images_u8.shape[-1] != 3:
        raise ValueError("resize_normalize expects uint8 [B, H, W, 3]")
    dev = images_u8.device
    x = images_u8.float() / 255.0
    in_h, in_w = x.shape[1], x.shape[2]
    Wh = torch.from_numpy(resize_weights(in_h, out_h, "bilinear").copy()).to(dev)
    Ww = torch.from_numpy(resize_weights(in_w, out_w, "bilinear").copy()).to(dev)
    x = torch.einsum("oh,bhwc->bowc", Wh, x)
    x = torch.einsum("pw,bowc->bopc", Ww, x)
    return _imagenet(x)


def normalize_u8(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC on its device -> /255 -> ImageNet-normalized float32
    (counterpart of ``native_loader.normalize_u8_on_device``)."""
    return _imagenet(images_u8.float() / 255.0)


@functools.lru_cache(maxsize=8)
def _imagenet_on(device: torch.device):
    """(mean, std) float32 [3] on ``device``, made once per device (a copy
    from the host per call would break a captured forward); read-only."""
    return (torch.tensor(IMAGENET_MEAN, device=device),
            torch.tensor(IMAGENET_STD, device=device))


def _imagenet(x: torch.Tensor) -> torch.Tensor:
    """float32 NHWC in [0, 1] -> ImageNet-normalized, on x's device."""
    mean, std = _imagenet_on(x.device)
    return (x - mean) / std


def load_image_uint8(path: str) -> np.ndarray:
    """[H, W, 3] uint8 via PIL (host)."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"), np.uint8)


def pil_resize_host(img_u8: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """PIL's bilinear resize on the host (antialiased, as torchvision's Resize
    on PIL images). Returns float32 [out_h, out_w, 3] in [0, 1]."""
    from PIL import Image

    img = Image.fromarray(img_u8).resize((out_w, out_h), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def normalize_np(x: np.ndarray) -> np.ndarray:
    return (x - IMAGENET_MEAN_NP) / IMAGENET_STD_NP


def preprocess_paths(paths, image_size: int, exact_pil: bool = True) -> np.ndarray:
    """Batch [B, S, S, 3] normalized float32 from image paths (host path);
    ``exact_pil=False`` resizes with ``resize_normalize`` on CPU tensors."""
    out = np.empty((len(paths), image_size, image_size, 3), np.float32)
    for i, p in enumerate(paths):
        u8 = load_image_uint8(p)
        if exact_pil:
            out[i] = normalize_np(pil_resize_host(u8, image_size, image_size))
        else:
            out[i] = resize_normalize(torch.from_numpy(u8.copy())[None], image_size,
                                      image_size)[0].numpy()
    return out
