"""The model's parameter tree as the reference reads it: every key of the
flat layout (``/``-joined names; linear weights ``[in, out]``; the backbone's
blocks stacked on a leading ``[L]`` axis) with its shape, worked out from
the configuration's sizes alone, and the uniform draw of each key.

What every block kind shares lives here: ``Dims``, read from a
configuration file of ``benchmark/configs/`` by ``dims_of`` given the
block's feed-forward width; the keys outside the blocks and those of a
block's attention half; the draw rule. A configuration's reference module
(``benchmark/reference/<module>.py``) adds its block's own keys.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Tuple


@dataclasses.dataclass(frozen=True)
class Dims:
    hidden: int  # D
    layers: int
    heads: int
    mlp: int  # the block's feed-forward width
    patch: int
    pretrain_image: int  # the position-embedding grid is (pretrain_image / patch)^2
    image: int
    num_cameras: int
    num_iterations: int  # focal iterations
    focus_strength: float
    focal_hidden: int = 256
    fusion: int = 192
    eps: float = 1e-6

    @property
    def grid(self) -> int:
        return self.image // self.patch

    @property
    def patches(self) -> int:
        return self.grid * self.grid

    @property
    def pos_tokens(self) -> int:
        return (self.pretrain_image // self.patch) ** 2 + 1


def dims_of(cfg: Mapping, mlp: int) -> Dims:
    """The sizes of a configuration file (its ``backbone`` group, the image
    size of ``dataset`` and the focal and EXIF settings it states), with
    ``mlp``, the feed-forward width that the block's reference module
    works out from them."""
    bb = cfg["backbone"]
    focal = cfg.get("focal_config", {})
    return Dims(hidden=int(bb["hidden_size"]), layers=int(bb["num_hidden_layers"]),
                heads=int(bb["num_attention_heads"]), mlp=int(mlp),
                patch=int(bb["patch_size"]), pretrain_image=int(bb["pretrain_image_size"]),
                image=int(cfg["dataset"]["image_size"]),
                num_cameras=int(cfg["model"]["exif_config"]["num_cameras"]),
                num_iterations=int(focal.get("num_iterations", 3)),
                focus_strength=float(focal.get("focus_strength", 1.5)))


def _mlp(prefix: str, sizes) -> Dict[str, Tuple[int, ...]]:
    out = {}
    for i, (a, b) in enumerate(zip(sizes, sizes[1:])):
        out[f"{prefix}/fc{i}/w"] = (a, b)
        out[f"{prefix}/fc{i}/b"] = (b,)
    return out


def attention_shapes(d: Dims) -> Dict[str, Tuple[int, ...]]:
    """Key -> shape, within one block, of its attention half and of the
    LayerNorm and LayerScale around its feed-forward (``model.Backbone``)."""
    D = d.hidden
    s = {n: (D,) for n in ("ls1", "ls2", "norm1/scale", "norm1/bias", "norm2/scale",
                           "norm2/bias", "q/b", "k/b", "v/b", "attn_out/b")}
    s.update({f"{n}/w": (D, D) for n in ("q", "k", "v", "attn_out")})
    return s


def param_shapes(d: Dims, block: Mapping[str, Tuple[int, ...]]) -> Dict[str, Tuple[int, ...]]:
    """Key -> shape of every parameter of the model whose blocks each hold
    ``block`` (key within a block -> shape), stacked on ``[L]``."""
    D, h = d.hidden, d.focal_hidden
    s: Dict[str, Tuple[int, ...]] = {
        "backbone/cls_token": (1, 1, D),
        "backbone/mask_token": (1, D),
        "backbone/pos_embed": (1, d.pos_tokens, D),
        "backbone/patch_embed/w": (d.patch * d.patch * 3, D),
        "backbone/patch_embed/b": (D,),
        "backbone/final_norm/scale": (D,),
        "backbone/final_norm/bias": (D,),
    }
    s.update({f"backbone/layers/{k}": (d.layers, *v) for k, v in block.items()})
    s.update(_mlp("ambient_stream/mlp", (D, 256, 128, 64)))
    s["focal_stream/initial_focus"] = (1, D)
    for i in range(d.num_iterations):
        p = f"focal_stream/streams/{i}"
        s[f"{p}/adaptive_weight"] = ()
        for n in ("query_proj", "key_proj", "value_proj"):
            s[f"{p}/{n}/w"] = (D, D)
            s[f"{p}/{n}/b"] = (D,)
        s.update(_mlp(f"{p}/projection", (D, h, h // 4)))
    s.update(_mlp("focal_stream/fusion", (h // 4 * d.num_iterations, h // 2, h // 4)))
    s["guided_projection/w"] = (D, 64)
    s["guided_projection/b"] = (64,)
    s["exif_prior/camera_embedding/table"] = (d.num_cameras, 64)
    s.update(_mlp("exif_prior/exif_encoder", (3, 64, 64)))
    s.update(_mlp("exif_prior/fusion", (128, 256, 64)))
    c = "curiosity_module"
    s[f"{c}/curiosity_weights"] = (3,)
    s.update(_mlp(f"{c}/encoder_mean", (D, D // 2, D // 4)))
    s.update(_mlp(f"{c}/encoder_logvar", (D, D // 2, D // 4)))
    s.update(_mlp(f"{c}/decoder", (D // 4, D // 2, D // 4)))
    s.update(_mlp(f"{c}/uncertainty_head", (D, D // 4, 1)))
    s.update(_mlp(f"{c}/geometric_curiosity", (D + 4, 256, 1)))
    s.update(_mlp(f"{c}/local_curiosity", (D, 128, 1)))
    s.update(_mlp("fusion", (d.fusion, d.fusion)))
    s.update(_mlp("decision_head", (d.fusion, 1)))
    s.update(_mlp("confidence_head", (d.fusion, 1, 1)))
    return s


# The heads' draws, (centre, half width or None for 1/sqrt(fan_in)): the
# output biases at the model's own init (depth 1.0, confidence 2.0). The
# confidence head's hidden unit (192 -> 1 under a ReLU, on the fusion's
# ReLU output) gets a bias of 2, above what its inputs swing, so that the
# ReLU never zeroes it; its output weight about -1 against the bias of 2
# puts the confidence about 0.5, where it follows the unit.
HEADS = {"decision_head/fc0/b": (1.0, None), "confidence_head/fc0/b": (2.0, None),
         "confidence_head/fc1/w": (-1.0, 0.1), "confidence_head/fc1/b": (2.0, None)}


def draw_rule(key: str, shapes) -> Tuple[float, float]:
    """(centre, half width) of the uniform draw of one parameter: linear
    weights and biases (leaves ``w``, ``b``) U(-1/sqrt(fan_in),
    1/sqrt(fan_in)), as torch's Linear, but for ``HEADS``; LayerNorm and
    LayerScale about 1 and 0; unit variance for the tokens, position
    embeddings and the camera table. Raises ``KeyError`` on another leaf:
    a reference module whose block has one draws it by a rule of its own."""
    leaf = key.rsplit("/", 1)[-1]
    if leaf in ("w", "b"):
        centre, half = HEADS.get(key, (0.0, None))
        return centre, half or 1.0 / math.sqrt(shapes[key[:-1] + "w"][-2])
    return {"scale": (1.0, 0.1), "bias": (0.0, 0.1), "ls1": (1.0, 0.1), "ls2": (1.0, 0.1),
            "cls_token": (0.0, math.sqrt(3)), "pos_embed": (0.0, math.sqrt(3)),
            "mask_token": (0.0, math.sqrt(3)), "table": (0.0, math.sqrt(3)),
            "initial_focus": (0.0, 0.02 * math.sqrt(3)), "adaptive_weight": (0.5, 0.1),
            "curiosity_weights": (1.0 / 3.0, 0.1)}[leaf]
