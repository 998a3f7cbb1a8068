"""A kernel family's share of its roofline in a traced stretch: the least
time of the family's work in the stretch's forwards (``work``, through the
records' reference module) over the device time of the family's kernels
there."""

from __future__ import annotations

from typing import Optional, Sequence

from benchmark.roofline import work


def family_seconds(kernels, names: Sequence[str]) -> float:
    """Device seconds of the port's kernels (``caim``) whose function name is
    one of ``names``."""
    return sum(s for n, s in kernels if "caim" in n and any(k in n for k in names))


def roofline_pct(rec: dict, family: str, names: Sequence[str]) -> Optional[float]:
    stretch, forwards = rec.get("stretch"), rec.get("forwards")
    if stretch is None or not forwards:
        return None
    t = family_seconds(stretch.kernels, names)
    if t <= 0.0:
        return None
    least = work.family_least_s(rec["ref"], rec["dims"], rec["batch"],
                                rec["token_filter"])[family]
    return 100.0 * least * forwards / t
