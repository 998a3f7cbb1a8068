"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` (host and
card) over a piece of the cell's own loop, run after the measured window,
bounded on the device by two marker kernels (``torch.cuda._sleep``) that
the host launches after synchronising.

The profiler places device records early by an offset that grows with the
process's age, and drops those it places before it started; so the stretch
waits ``settle_s`` before its first marker, and a trace that lacks a marker
is taken again with twice the wait.

From the device records between the markers: ``busy_s`` (the union of the
device's operations, kernels and copies), ``window_s`` (the markers' gap),
each kernel's name and time for the per-layer readers, and the breakdown
the result line carries: the device operations that took most time, and
the longest idle gaps by the host operation that covered each gap's middle
(the host's clock and the device's aligned by the first marker's launch).
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Callable, Dict, List, Tuple

STRETCH_S = 2.0  # seconds of the cell's loop that a traced run profiles
MARKER = "spin_kernel"  # the kernel of torch.cuda._sleep
ANNOTATION = "bench."  # the prefix of the benchmark's record_function labels
MIN_GAP_NS = 5_000  # idle gaps shorter than this are launch spacing, not named


@dataclasses.dataclass
class Stretch:
    busy_s: float
    window_s: float
    kernels: List[Tuple[str, float]]  # (name, seconds), every device op between the markers
    breakdown: Dict[str, list]
    result: object  # what the traced loop returned
    skew_s: float  # device clock minus host clock at the first marker


def short_name(name: str) -> str:
    """A kernel's name without ``void``, anonymous namespaces and its
    arguments: ``caim::int8_gemm_tma_kernel<1, 128>``; a long template's
    arguments as ``<...>``."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:  # cut at the argument list, outside template brackets
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        out.append(ch)
    name = "".join(out).strip()
    return name if len(name) <= 80 else name.split("<")[0] + "<...>"


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def take(loop: Callable[[], object], settle_s: float = 0.5, tries: int = 3) -> Stretch:
    import warnings

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*Profiler clears events")
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                time.sleep(settle_s)
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
                result = loop()
                torch.cuda.synchronize()
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
                time.sleep(settle_s)
        events = prof.profiler.kineto_results.events()
        # device operations, not the profiler's mirror of the host's annotations
        dev = [e for e in events if e.device_type() == DeviceType.CUDA
               and not e.name().startswith(ANNOTATION)]
        marks = sorted((e for e in dev if MARKER in e.name()), key=lambda e: e.start_ns())
        if len(marks) == 2:
            break
        settle_s *= 2
    else:
        raise RuntimeError(f"none of {tries} traces held both markers (the last waited "
                           f"{settle_s / 2} s)")
    t0, t1 = marks[0].end_ns(), marks[1].start_ns()
    inside = [e for e in dev if e.start_ns() >= t0 and e.end_ns() <= t1
              and MARKER not in e.name()]
    busy = _union([(e.start_ns(), e.end_ns()) for e in inside])
    kernels = [(short_name(e.name()), e.duration_ns() / 1e9) for e in inside]
    # the device clock minus the host's: the first marker against its launch
    launch = [e for e in events if e.device_type() == DeviceType.CPU
              and e.name().startswith("cuda") and e.correlation_id() == marks[0].correlation_id()]
    skew = marks[0].start_ns() - launch[0].end_ns() if launch else 0
    host = [e for e in events if e.device_type() == DeviceType.CPU]
    return Stretch(busy_s=sum(b - a for a, b in busy) / 1e9, window_s=(t1 - t0) / 1e9,
                   kernels=kernels, breakdown=_breakdown(kernels, busy, t0, t1, host, skew),
                   result=result, skew_s=skew / 1e9)


def _breakdown(kernels, busy, t0, t1, host, skew) -> Dict[str, list]:
    import numpy as np

    ops: Dict[str, float] = {}
    for name, s in kernels:
        ops[name] = ops.get(name, 0.0) + s
    starts = np.array([e.start_ns() for e in host], np.int64)
    ends = np.array([e.end_ns() for e in host], np.int64)
    names = [e.name() for e in host]
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps: Dict[str, float] = {}
    for a, b in zip(edges[::2], edges[1::2]):
        if b - a < MIN_GAP_NS:
            continue
        mid = (a + b) // 2 - skew  # on the host's clock
        cover = np.flatnonzero((starts <= mid) & (ends >= mid))
        cover = sorted(cover, key=lambda i: ends[i] - starts[i])  # innermost first
        ours = [i for i in cover if names[i].startswith(ANNOTATION)]
        if not cover:
            label = "no traced host operation (Python, numpy, waits)"
        elif ours and ours[0] != cover[0]:
            label = f"{names[ours[0]]} > {names[cover[0]]}"
        else:
            label = names[cover[0]]
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e9
    return {"device_ops": _top(ops), "idle_gaps": _top(gaps)}


def _top(d: Dict[str, float]) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
