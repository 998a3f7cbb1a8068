"""The reference module of a DINOv2 backbone whose blocks end in a tanh-GELU
MLP of width ``hidden_size * mlp_ratio`` (ViT-S/14, ViT-B/14, ViT-L/14).

A configuration names its reference module in
``benchmark/configs/<config>.reference.json``; the harness calls it
through these names alone:

  * ``dims(cfg)``: the configuration's ``layout.Dims``;
  * ``param_shapes(d)``: key -> shape of every parameter;
  * ``rule(key, shapes)``: (centre, half width) of a parameter's uniform draw;
  * ``forward(p, d, images, exif, guidance, token_filter=, bits=)``: the
    plain reference (``model.forward``);
  * ``units(d, batch, token_filter)``: the forward's ``work.Unit``s;
  * ``outside_ops(d, batch, token_filter)``: the operations of its matrix
    products outside the units, by type;
  * ``program_backbone(d)``: the keyword arguments of the program's
    ``DinoV2Config`` at these sizes, which the harness builds at a test's
    tiny widths, where the configuration file's backbone size does not
    hold.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.reference import layout, model
from benchmark.reference.layout import Dims
from benchmark.roofline import work
from benchmark.roofline.work import Unit


def dims(cfg) -> Dims:
    bb = cfg["backbone"]
    return layout.dims_of(cfg, mlp=int(bb["hidden_size"]) * int(bb["mlp_ratio"]))


def param_shapes(d: Dims) -> Dict[str, Tuple[int, ...]]:
    D, F = d.hidden, d.mlp
    return layout.param_shapes(d, {**layout.attention_shapes(d), "fc1/w": (D, F),
                                   "fc1/b": (F,), "fc2/w": (F, D), "fc2/b": (D,)})


rule = layout.draw_rule


class Backbone(model.Backbone):
    def feed_forward(self, i: int, h: torch.Tensor) -> torch.Tensor:
        L, q = self.layer, self.bits
        u = model.gelu_tanh(model.qlinear(h, L(i, "fc1/w"), model.bf16(L(i, "fc1/b")), q))
        return model.qlinear(u, L(i, "fc2/w"), model.bf16(L(i, "fc2/b")), q)


def forward(p, d: Dims, images, exif, guidance, **kw) -> Dict[str, torch.Tensor]:
    return model.forward(Backbone, p, d, images, exif, guidance, **kw)


def units(d: Dims, batch: int, token_filter=None) -> List[Unit]:
    """Each block's K2 (LayerNorm and q/k/v), K1 (attention), K3 (the
    output projection and residual) and K4 (LayerNorm, fc1, GELU, fc2: two
    products of M x D x F), then the focal iterations'."""
    D, Fh, B = d.hidden, d.mlp, batch
    out: List[Unit] = []
    for n in work.block_tokens(d, token_filter):
        M = B * n
        act = M * D * 2  # a bfloat16 [M, D] activation
        out += [
            Unit("int8_block", "K2", n, act + 3 * D * D + 3 * act + 8 * D + 24 * D,
                 2 * M * D * 3 * D, "int8"),
            Unit("flash_attention", "K1", n, 4 * act, 4 * B * n * n * D, "bf16"),
            Unit("int8_block", "K3", n, 3 * act + D * D + 12 * D, 2 * M * D * D, "int8"),
            Unit("int8_block", "K4", n, 2 * act + 2 * Fh * D + 8 * Fh + 20 * D,
                 4 * M * D * Fh, "int8"),
        ]
    return out + work.focal_units(d, batch)


outside_ops = work.outside_ops


def program_backbone(d: Dims) -> dict:
    return dict(hidden_size=d.hidden, num_layers=d.layers, num_heads=d.heads,
                mlp_ratio=d.mlp // d.hidden, patch_size=d.patch,
                pretrain_image_size=d.pretrain_image, gelu_approx=True)
