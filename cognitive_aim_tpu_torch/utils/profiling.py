"""Profiling and tracing (counterpart of cognitive_aim_tpu/utils/profiling.py).

- ``StepTimer``: wall-clock per-step statistics with warmup exclusion; honest
  through asynchronous launches when the body synchronises or fetches.
- ``trace``: context manager over ``torch.profiler`` that writes a trace
  TensorBoard's profile plugin reads.
- ``traced_kernels``: the port's own kernels that the device ran under each
  of some calls, in order, read from one ``torch.profiler`` trace between
  marker kernels: how what a CUDA graph's replay ran, which no Python
  counter sees, is read.
- ``chain_throughput``: the chain-slope method of the JAX package's bench as
  a measurement primitive: k chained calls of a step, one scalar fetched at
  the end, at two lengths; the fixed launch and fetch costs cancel in the
  slope.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch


class StepTimer:
    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self.times: List[float] = []
        self._t0 = None
        self._n = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._n += 1
        if self._n > self.warmup:
            self.times.append(dt)

    def stats(self) -> Dict[str, float]:
        if not self.times:
            return {"mean_s": 0.0, "p50_s": 0.0, "p95_s": 0.0, "steps": 0}
        t = np.asarray(self.times)
        return {
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p95_s": float(np.percentile(t, 95)),
            "steps": int(t.size),
        }


@contextlib.contextmanager
def trace(logdir: str = ""):
    """``torch.profiler`` over the body (host and, where there is one, the
    card), written to ``logdir`` (default: a directory under the system's
    temporary directory) for TensorBoard's profile plugin. Yields the
    directory."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    logdir = logdir or os.path.join(tempfile.gettempdir(), "torch-trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield logdir


MARKER = "spin_kernel"  # the kernel of torch.cuda._sleep, which bounds a traced call
# the waits before and after the traced call that the last trace needed
_SETTLE = {"before": 0.0, "after": 0.0}


def traced_kernels(*fns: Callable[[], Any], namespace: str = "caim", settle_s: float = 0.05,
                   tries: int = 8) -> List[Tuple[Any, List[str]]]:
    """Each of ``fns`` called in turn under one ``torch.profiler`` window
    (host and card): for each, its result and the names of the kernels of
    ``namespace`` (the port's hand-written kernels) that the device ran
    under it, in the order they started; launched by a wrapper or replayed
    by a CUDA graph alike.

    The profiler drops device records that it places before its window
    opens, and on an H100 it placed kernels further too early the longer
    the process had run (seconds, late in a long process; up to half of an
    eager forward's kernels were gone when the call followed the step at
    once). So the active step waits, runs a marker kernel
    (``torch.cuda._sleep``) before, between and after the calls and waits
    again; a call's kernels are those between its two markers. A trace that
    lacks a marker is taken again (the calls run again) with twice the wait
    on the lost marker's side, up to ``tries`` times (the first is lost when
    no marker is found or ``namespace`` kernels precede the first found).
    Each wait starts at the larger of ``settle_s`` and what the process's
    last trace needed, so one window for several calls pays it once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    prefix = namespace + "::"
    wait = {side: max(settle_s, s) for side, s in _SETTLE.items()}
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            torch.zeros(1, device="cuda").add_(1)  # the warm-up step, not kept
            torch.cuda.synchronize()
            prof.step()
            time.sleep(wait["before"])
            results = []
            for fn in fns:
                torch.cuda._sleep(1)
                torch.cuda.synchronize()
                results.append(fn())
                torch.cuda.synchronize()
            torch.cuda._sleep(1)
            torch.cuda.synchronize()
            time.sleep(wait["after"])
            prof.step()
        kernels = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                         key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(kernels) if MARKER in e.name]
        if len(marks) == len(fns) + 1:
            _SETTLE.update(wait)
            return [(r, [e.name for e in kernels[a + 1:b] if prefix in e.name])
                    for r, a, b in zip(results, marks, marks[1:])]
        ours = [i for i, e in enumerate(kernels) if prefix in e.name]
        if not marks or (ours and ours[0] < marks[0]):
            lost = ("before",)
        elif ours and ours[-1] > marks[-1]:
            lost = ("after",)
        else:
            lost = ("before", "after")
        for side in lost:
            wait[side] *= 2
    raise RuntimeError(f"none of {tries} traces held the {len(fns) + 1} markers around the "
                       f"traced calls (the last waited {wait} s and held {len(marks)} markers "
                       f"among {len(kernels)} device records)")


def _leaves(carry):
    if isinstance(carry, dict):
        return list(carry.values())
    return list(carry) if isinstance(carry, (list, tuple)) else [carry]


def chain_throughput(
    step_fn: Callable, init_carry, *, k_short: int = 2, k_long: int = 10,
    repeats: int = 3,
) -> float:
    """Per-step seconds by the chain-slope method: ``k`` chained calls of
    ``step_fn`` (carry -> carry; a tensor, or a tuple, list or dict of them)
    at two lengths, one scalar fetched at the end, best of ``repeats`` each;
    the slope cancels the fixed launch and fetch costs. On the card each
    chain is captured once as a CUDA graph and replayed, so host launch
    costs leave the chain too (``step_fn`` must then be capturable: no host
    sync, no allocation that outlives the graph)."""
    cuda = any(t.is_cuda for t in _leaves(init_carry))

    def chain(k):
        c = init_carry
        for _ in range(k):
            c = step_fn(c)
        return sum(t.reshape(-1)[0].float() for t in _leaves(c))

    times = {}
    for k in (k_short, k_long):
        run = lambda: chain(k)  # noqa: E731
        if cuda:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                chain(k)  # warm-up outside the graph: lazy kernel builds, allocator
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = chain(k)

            def run(graph=graph, out=out):
                graph.replay()
                return out
        float(run())  # first call
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            float(run())
            best = min(best, time.perf_counter() - t0)
        times[k] = best
    return (times[k_long] - times[k_short]) / (k_long - k_short)
