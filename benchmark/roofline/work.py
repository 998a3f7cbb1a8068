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

The units are the configuration's reference module's (``ref.units``): its
blocks' own, then the focal iterations' (``focal_units``), which every
block kind shares. ``matmul_least_s`` is the numerator of the whole
forward's mfu: every matrix product of the forward at the peak of the type
the configuration computes it in, the units' and those outside them
(``ref.outside_ops``: the patch embedding in bfloat16, the token filter's
float32 key projection; ``outside_ops`` here). The heads' products on the
CLS token (under 0.01% of the operations) are left out.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from benchmark.reference.layout import Dims
from benchmark.roofline.peaks import HBM_BYTES_PER_S, OPS_PER_S


@dataclasses.dataclass(frozen=True)
class Unit:
    family: str  # the kernel family, as a roofline_pct reader names it
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


def focal_units(d: Dims, batch: int) -> List[Unit]:
    """The focal iterations' units: K5 (the fused q/k/v projection) and K6
    (the focal attention) over the P patch tokens, each iteration."""
    D, P = d.hidden, d.patches
    M5 = batch * P
    out: List[Unit] = []
    for _ in range(d.num_iterations):
        out += [
            Unit("int8_block", "K5", P, 4 * M5 * D * 2 + 3 * D * D + 24 * D,
                 2 * M5 * D * 3 * D, "int8"),
            Unit("focal_attention", "K6", P, 4 * M5 * D * 2 + 3 * M5 * 4,
                 4 * batch * P * P * D, "bf16"),
        ]
    return out


def outside_ops(d: Dims, batch: int, token_filter=None) -> Dict[str, float]:
    """Operations of the matrix products outside the units, by type: the
    patch embedding, and with a filter the next block's keys, the CLS
    query and its scores."""
    D = d.hidden
    ops = {"bf16": 2 * batch * d.patches * (d.patch * d.patch * 3) * D}
    if token_filter is not None:
        n = 1 + d.patches
        ops["f32"] = 2 * batch * (n * D * D + D * D + n * D)
    return ops


def family_least_s(ref, d: Dims, batch: int, token_filter=None) -> Dict[str, float]:
    """Family -> least seconds of its work in one forward of the reference
    module ``ref``'s model."""
    fam: Dict[str, float] = {}
    for u in ref.units(d, batch, token_filter):
        fam[u.family] = fam.get(u.family, 0.0) + u.least_s
    return fam


def matmul_ops(ref, d: Dims, batch: int, token_filter=None) -> Dict[str, float]:
    """Operations of the forward's matrix products by type."""
    ops = {"int8": 0.0, "bf16": 0.0, "f32": 0.0}
    for u in ref.units(d, batch, token_filter):
        ops[u.kind] += u.ops
    for kind, n in ref.outside_ops(d, batch, token_filter).items():
        ops[kind] = ops.get(kind, 0.0) + n
    return ops


def matmul_least_s(ref, d: Dims, batch: int, token_filter=None) -> float:
    return sum(n / OPS_PER_S[k] for k, n in matmul_ops(ref, d, batch, token_filter).items())
