"""Offline cells: one client in a closed loop through the engine's forward,
``CognitiveAimInference._forward``, one replay of the CUDA graph of its
signature a batch (guided, uint8, ``batch`` x 518 x 518).

Set-up builds the engine with the seeded weights, makes ``POOL_BATCHES``
distinct batches (uint8 NHWC images, each image its own EXIF scalars and
an instruction drawn uniformly from the 9) staged in pinned host memory,
as ``predict_paths_batched`` stages them, and runs ``WARM_BATCHES`` of the
loop (the graph's capture and first replays). The window then runs the
loop with one batch in flight: dispatch batch i+1, then drain batch i's
depth, confidence, curiosity and attention map to the host, in the order of
``predict_paths_batched``'s ``_dispatch`` / ``_drain``, cycling through the
pool in an order drawn from the seed. The drain copies on a stream of its
own after batch i's forward, so it waits for batch i alone; ``.cpu()`` on
the forward's stream, as ``predict_paths_batched`` drains, would wait for
batch i+1 too and leave the card idle while the host dispatches i+2, and
the rate would follow the host's speed from run to run.

``images_per_s``: the images whose outputs reached the host by the window's
close, over the time from its start to the last of those drains.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np

from benchmark import compare, inputs, system
from benchmark.harness import Outcome

POOL_BATCHES = 8  # distinct batches the window cycles through
WARM_BATCHES = 4  # the graph's capture and first replays


class Loop:
    """The client: on the card each batch's outputs are copied to the host on
    a copy stream, after an event recorded behind the batch's forward, so
    that a drain waits for its own batch and not for the one dispatched
    after it."""

    def __init__(self, eng, pool, order, device):
        import torch

        self.eng, self.pool, self.order = eng, pool, order
        self.copies = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.pos = 0
        self.host_ms = []

    def _dispatch(self, b):
        import torch
        from torch.profiler import record_function

        x = self.pool[b]
        t0 = time.perf_counter()
        with record_function("bench.dispatch"):
            out = self.eng._forward(x["images"], x["exif"], x["guidance"])
        self.host_ms.append((time.perf_counter() - t0) * 1e3)
        done = None
        if self.copies is not None:
            done = torch.cuda.Event()
            done.record()
        return b, out, done

    def _drain(self, pending):
        import torch
        from torch.profiler import record_function

        b, out, done = pending
        with record_function("bench.drain"):
            copies = (torch.cuda.stream(self.copies) if self.copies is not None
                      else contextlib.nullcontext())
            with copies:
                if done is not None:
                    self.copies.wait_event(done)
                # .cpu() synchronises the current stream: here the copy stream
                got = {"depth": out.depth[:, 0].cpu(), "confidence": out.confidence[:, 0].cpu(),
                       "curiosity": out.curiosity.cpu(), "attention": out.attention.cpu()}
        return b, got, time.perf_counter()

    def run(self, n=None, until=None):
        """``n`` batches, or batches dispatched until the host clock passes
        ``until``; returns [(pool index, outputs, drained at)]."""
        done, pending, i = [], None, 0
        while (n is None or i < n) and (until is None or time.perf_counter() < until):
            cur = self._dispatch(self.order[self.pos % len(self.order)])
            self.pos += 1
            i += 1
            if pending is not None:
                done.append(self._drain(pending))
            pending = cur
        if pending is not None:
            done.append(self._drain(pending))
        return done


def make_pool(ctx, B, n_batches):
    """``n_batches`` batches of ``B`` images: uint8 images, EXIF, guidance,
    on the host (pinned with a card)."""
    import torch

    d = ctx.dims
    imgs = inputs.images_u8(n_batches * B, d.image, ctx.seed, "offline.images", ctx.device).cpu()
    ex = inputs.exif(n_batches * B, ctx.seed, "offline.exif", d.num_cameras)
    gi = inputs.instructions(n_batches * B, ctx.seed, "offline.instructions")
    pin = ctx.device.type == "cuda"

    def host(t):
        return t.pin_memory() if pin else t

    pool = []
    for b in range(n_batches):
        s = slice(b * B, (b + 1) * B)
        pool.append({"images": host(imgs[s].contiguous()),
                     "exif": {k: host(torch.from_numpy(v[s].copy())) for k, v in ex.items()},
                     "guidance": host(torch.from_numpy(gi[s].astype(np.int64)))})
    return pool


def run(ctx) -> Outcome:
    import torch

    t = ctx.traffic
    B = int(t["batch"])
    cuda = ctx.device.type == "cuda"
    eng, flat = system.build(ctx, t.get("token_filter", ""))
    pool = make_pool(ctx, B, POOL_BATCHES)
    rng = np.random.default_rng(inputs.sub_seed(ctx.seed, "offline.order"))
    loop = Loop(eng, pool, rng.permutation(len(pool)), ctx.device)
    loop.run(n=WARM_BATCHES)
    if cuda:
        torch.cuda.synchronize()
    loop.host_ms.clear()
    setup_s = ctx.setup_s()
    ctx.log(f"set-up {setup_s:.2f} s; window of {ctx.seconds} s")

    start = time.perf_counter()
    done = loop.run(until=start + ctx.seconds)
    close = start + ctx.seconds
    inside = [x for x in done if x[2] <= close]
    images = B * len(inside)
    rate = images / (inside[-1][2] - start)
    host_ms = list(loop.host_ms)
    mem = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    ctx.log(f"window: {len(done)} batches dispatched, {len(inside)} drained by its close, "
            f"{rate:.2f} images/s, host {np.mean(host_ms):.3f} ms a forward")

    stretch, forwards = None, 0
    if ctx.trace and cuda:
        from benchmark import trace

        n = max(8, int(round(trace.STRETCH_S * rate / B)))
        stretch = trace.take(lambda: loop.run(n=n))
        forwards = n
        ctx.log(f"traced stretch: {n} forwards, {stretch.window_s:.3f} s, busy "
                f"{stretch.busy_s:.3f} s, device clock - host clock {stretch.skew_s * 1e3:.3f} ms")

    # the reference on a sample of the window's batches, drawn from the seed
    pick = rng.choice(len(inside), size=min(int(t["check_batches"]), len(inside)),
                      replace=False)
    cases = [(pool[inside[i][0]], inside[i][1]) for i in sorted(pick)]
    del eng, loop
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = compare.against_reference(ctx, flat, cases)
    ctx.log(f"reference over {len(cases)} batches of the window: {time.perf_counter() - t0:.1f} s")
    records = {"ref": ctx.ref, "dims": ctx.dims, "batch": B, "token_filter": ctx.token_filter,
               "host_ms": host_ms, "stretch": stretch, "forwards": forwards}
    return Outcome(e2e={"images_per_s": rate}, setup_s=setup_s,
                   attempted=B * len(done), failed=0, numbers=numbers,
                   memory_peak_bytes=mem, records=records, stretch=stretch,
                   cases=cases, flat=flat)
