"""The work of one forward, counted from the configuration's shapes alone,
and the least time the card could take for it.

Each unit of work is the function of one of the model's kernels as the JAX
package defines it (K1, K2, K3, K4, K5, K6), at the token count each block
runs at: its operations, and its bytes with every input read once and every
output written once (activations bfloat16, int8 weights, float32 vectors),
as ``chip_smoke.py``'s kernel table counts them. A unit's least time is the
larger of its bytes over the HBM bandwidth and its operations over the peak
of their type; a family's least time is the sum over its units. None of it
depends on how a kernel is written, so a later change to a kernel moves the
denominator of its share only.

``matmul_least_s`` is the numerator of the whole forward's mfu: every
matrix product of the forward at the peak of the type the configuration
computes it in (int8 projections, bfloat16 attention and patch embedding,
the token filter's float32 key projection). The heads' products on the CLS
token (under 0.01% of the operations) are left out.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from benchmark.reference.layout import Dims
from benchmark.roofline.peaks import HBM_BYTES_PER_S, OPS_PER_S


@dataclasses.dataclass(frozen=True)
class Unit:
    family: str  # flash_attention | int8_block | focal_attention
    kernel: str  # the JAX package's kernel this unit is the function of
    tokens: int
    bytes: float
    ops: float
    kind: str  # the operations' type, a key of OPS_PER_S

    @property
    def least_s(self) -> float:
        return max(self.bytes / HBM_BYTES_PER_S, self.ops / OPS_PER_S[self.kind])


def block_tokens(d: Dims, token_filter: Optional[Tuple[int, float]]) -> List[int]:
    """The token count each block runs at: 1 + P, and after a fused
    single-stage filter at (layer, keep) 1 + k + 1 from that layer on."""
    n = 1 + d.patches
    if token_filter is None:
        return [n] * d.layers
    layer, keep = token_filter
    k = max(1, int(round(keep * d.patches)))
    return [n] * layer + [1 + k + 1] * (d.layers - layer)


def units(d: Dims, batch: int, token_filter=None) -> List[Unit]:
    """The forward's units of kernel work, for ``batch`` images."""
    D, Fh, B = d.hidden, d.mlp, batch
    out: List[Unit] = []
    for n in block_tokens(d, token_filter):
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
    P, M5 = d.patches, B * d.patches
    for _ in range(d.num_iterations):
        out += [
            Unit("int8_block", "K5", P, 4 * M5 * D * 2 + 3 * D * D + 24 * D,
                 2 * M5 * D * 3 * D, "int8"),
            Unit("focal_attention", "K6", P, 4 * M5 * D * 2 + 3 * M5 * 4,
                 4 * B * P * P * D, "bf16"),
        ]
    return out


def family_least_s(d: Dims, batch: int, token_filter=None) -> Dict[str, float]:
    """Family -> least seconds of its work in one forward."""
    fam: Dict[str, float] = {}
    for u in units(d, batch, token_filter):
        fam[u.family] = fam.get(u.family, 0.0) + u.least_s
    return fam


def matmul_ops(d: Dims, batch: int, token_filter=None) -> Dict[str, float]:
    """Operations of the forward's matrix products by type."""
    ops = {"int8": 0.0, "bf16": 0.0, "f32": 0.0}
    for u in units(d, batch, token_filter):
        ops[u.kind] += u.ops
    D = d.hidden
    ops["bf16"] += 2 * batch * d.patches * (d.patch * d.patch * 3) * D  # patch embedding
    if token_filter is not None:  # the next block's keys, the CLS query and scores
        n = 1 + d.patches
        ops["f32"] += 2 * batch * (n * D * D + D * D + n * D)
    return ops


def matmul_least_s(d: Dims, batch: int, token_filter=None) -> float:
    return sum(n / OPS_PER_S[k] for k, n in matmul_ops(d, batch, token_filter).items())
