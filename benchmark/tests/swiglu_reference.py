"""A reference module of a block kind that no configuration here uses yet,
for the test that such a configuration is added as new files only: a
DINOv2 block whose feed-forward is SwiGLU (ViT-g/14's kind): ``w12``
projects to the gate and the value, each of width F = ``int(2/3 * 4 * D)``
rounded up to a multiple of 8, and ``w3`` projects ``silu(gate) * value``
back to D. The test copies it into ``benchmark/reference/`` of a copy of
the benchmark; the names it defines are those ``dinov2_gelu.py`` lists.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import layout, model
from benchmark.reference.layout import Dims
from benchmark.roofline import work
from benchmark.roofline.work import Unit


def swiglu_width(hidden: int) -> int:
    return (int(2 / 3 * 4 * hidden) + 7) // 8 * 8


def dims(cfg) -> Dims:
    return layout.dims_of(cfg, mlp=swiglu_width(int(cfg["backbone"]["hidden_size"])))


def param_shapes(d: Dims) -> Dict[str, Tuple[int, ...]]:
    D, Fw = d.hidden, d.mlp
    return layout.param_shapes(d, {**layout.attention_shapes(d), "w12/w": (D, 2 * Fw),
                                   "w12/b": (2 * Fw,), "w3/w": (Fw, D), "w3/b": (D,)})


rule = layout.draw_rule


class Backbone(model.Backbone):
    def feed_forward(self, i: int, h: torch.Tensor) -> torch.Tensor:
        L, q = self.layer, self.bits
        gate, value = model.qlinear(h, L(i, "w12/w"), model.bf16(L(i, "w12/b")), q).chunk(2, -1)
        return model.qlinear(F.silu(gate) * value, L(i, "w3/w"), model.bf16(L(i, "w3/b")), q)


def forward(p, d: Dims, images, exif, guidance, **kw) -> Dict[str, torch.Tensor]:
    return model.forward(Backbone, p, d, images, exif, guidance, **kw)


def units(d: Dims, batch: int, token_filter=None) -> List[Unit]:
    """K2, K1 and K3 as the GELU block's; the gated feed-forward "K4s":
    three products of M x D x F (gate, value, and back)."""
    D, Fw, B = d.hidden, d.mlp, batch
    out: List[Unit] = []
    for n in work.block_tokens(d, token_filter):
        M = B * n
        act = M * D * 2
        out += [
            Unit("int8_block", "K2", n, act + 3 * D * D + 3 * act + 8 * D + 24 * D,
                 2 * M * D * 3 * D, "int8"),
            Unit("flash_attention", "K1", n, 4 * act, 4 * B * n * n * D, "bf16"),
            Unit("int8_block", "K3", n, 3 * act + D * D + 12 * D, 2 * M * D * D, "int8"),
            Unit("int8_block", "K4s", n, 2 * act + 3 * Fw * D + 12 * Fw + 20 * D,
                 6 * M * D * Fw, "int8"),
        ]
    return out + work.focal_units(d, batch)


outside_ops = work.outside_ops


def program_backbone(d: Dims) -> dict:
    raise NotImplementedError("the program has no SwiGLU block")
