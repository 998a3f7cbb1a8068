"""Precision policy (counterpart of cognitive_aim_tpu/core/precision.py).

The default policy computes the ViT backbone and the focal streams in
bfloat16 with tanh GELU; the small cognitive heads always run in float32
and the parameters are stored in float32. STRICT_F32 computes everything in
float32 with exact erf GELU; it is the parity policy.

INT8_BACKBONE is the default policy with the backbone's dense projections
(qkv, attn_out, fc1, fc2) and each focal stream's fused q/k/v projection
quantised to int8 (kernels/int8_ops.py): bf16 activations, tanh GELU,
int32 accumulation. ``CognitiveAimModel.prepare_params`` applies it.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    backbone_compute_dtype: torch.dtype = torch.bfloat16
    # int8 dense projections in the backbone and the focal qkv projection
    quantize_backbone: bool = False
    # tanh-approximate GELU in the backbone; the parity policy keeps erf
    fast_gelu: bool = True


DEFAULT_POLICY = Policy()
STRICT_F32 = Policy(backbone_compute_dtype=torch.float32, fast_gelu=False)
INT8_BACKBONE = Policy(quantize_backbone=True)


def policy_from_name(name: str) -> Policy:
    return {
        "default": DEFAULT_POLICY,
        "bf16": DEFAULT_POLICY,
        "f32": STRICT_F32,
        "strict_f32": STRICT_F32,
        "int8": INT8_BACKBONE,
    }[name]
