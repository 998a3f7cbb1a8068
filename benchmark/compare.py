"""The numbers that decide ``correct``: the widest gaps between what the
timed path produced and the plain reference's outputs for the same inputs.

  * ``depth_rel``: max |depth - ref| / |ref|;
  * ``confidence_abs``: max |confidence - ref| (a value in (0, 1));
  * ``curiosity_rel``: max |reward - ref| / |ref|;
  * ``attention_rel``: the focal attention that the attention map carries.
    A guided map is softmax((0.7 m + 0.3 a) / 0.05) of the instruction's
    mask m and the last focal iteration's attention a (rows summing to 1),
    so the map's log gives a back up to a constant per row: the gap in a is
    (0.05 / 0.3) (log map - log ref_map) less its row mean, taken at its
    largest and over the largest value of the reference's a. (The mask's
    share of the logits is 14-70 against a's 0.3 / 0.05 / P, so the map's
    own gap would hide the focal streams.)
"""

from __future__ import annotations

from typing import Dict

import torch


def _max(t: torch.Tensor) -> float:
    return float(t.max()) if t.numel() else 0.0


def rel(p: torch.Tensor, r: torch.Tensor) -> float:
    return _max((p.double() - r.double()).abs() / r.double().abs())


def absolute(p: torch.Tensor, r: torch.Tensor) -> float:
    return _max((p.double() - r.double()).abs())


def attention_rel(m: torch.Tensor, ref_map: torch.Tensor, ref_focal: torch.Tensor) -> float:
    gap = (0.05 / 0.3) * (torch.log(m.double()) - torch.log(ref_map.double()))
    gap = gap - gap.mean(dim=-1, keepdim=True)
    return _max(gap.abs().amax(-1) / ref_focal.double().amax(-1))


def numbers(out: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The numbers of the outputs ``out`` holds (depth and confidence always;
    curiosity and the attention map where the cell returns them)."""
    got = {"depth_rel": rel(out["depth"], ref["depth"]),
           "confidence_abs": absolute(out["confidence"], ref["confidence"])}
    if "curiosity" in out:
        got["curiosity_rel"] = rel(out["curiosity"], ref["curiosity"])
    if "attention" in out:
        got["attention_rel"] = attention_rel(out["attention"], ref["attention"],
                                             ref["focal_attention"])
    return got


def against_reference(ctx, flat, cases, control_bits: int = 0) -> Dict[str, float]:
    """The widest of each number over ``cases``: (inputs, outputs) pairs of
    one batch each, inputs {images, exif, guidance} as the program was
    given them, outputs as it produced them. The configuration's reference
    module (``ctx.ref``) runs on the run's device, from the flat weights,
    with the configuration's int8 projections. With ``control_bits`` the
    control takes the program's place: the reference at those bits (4:
    int4) on the same inputs."""
    from benchmark import inputs

    ref, dev = ctx.ref, ctx.device
    params = inputs.on_device(flat, dev)
    worst: Dict[str, float] = {}
    for inp, out in cases:
        args = (params, ctx.dims, inp["images"].to(dev),
                {k: v.to(dev) for k, v in inp["exif"].items()}, inp["guidance"].to(dev))
        r = ref.forward(*args, token_filter=ctx.token_filter)
        if control_bits:
            low = ref.forward(*args, token_filter=ctx.token_filter, bits=control_bits)
            out = {k: low[k] for k in out}
        for k, v in numbers({k: v.to(dev) for k, v in out.items()}, r).items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst
