"""Profiling and tracing (counterpart of cognitive_aim_tpu/utils/profiling.py).

- ``StepTimer``: wall-clock per-step statistics with warmup exclusion; honest
  through asynchronous launches when the body synchronises or fetches.
- ``trace``: context manager over ``torch.profiler`` that writes a trace
  TensorBoard's profile plugin reads.
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
from typing import Callable, Dict, List

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
