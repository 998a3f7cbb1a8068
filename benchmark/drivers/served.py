"""Served cells: an open loop of single requests into
``serve.BatchingServer.submit``, in process (no HTTP, no decode).

Set-up builds the engine with the seeded weights and the server
(``max_batch``, ``max_delay_ms``; its own warm-up captures the graph of its
one padded forward), makes ``POOL_IMAGES`` float32 normalised images, and
sends ``WARM_REQUESTS`` through the same clients. The window's requests
are ``round(rate_per_s * seconds)``, each one image of the pool, its own
EXIF scalars and an instruction drawn uniformly from the 9. Their arrival
gaps are the quantiles of the exponential distribution of that rate,
scaled to fill the window and put in an order drawn from the seed: every
seed offers the same gaps, Poisson-like, in another order.

One generator thread (the caller's) hands each request at its due time to
a pool of ``clients`` threads that call ``submit``. A request's latency
runs from its due time to its answer in the client thread; one that fails,
or gets no answer within a minute of the window's close, counts as missing
``latency_p95_ms`` and as failed. The generator's lateness is logged.
"""

from __future__ import annotations

import concurrent.futures
import gc
import math
import threading
import time

import numpy as np

from benchmark import compare, inputs, system
from benchmark.harness import Outcome
from benchmark.reference.model import INSTRUCTIONS, normalize_u8

POOL_IMAGES = 128  # distinct images the requests draw from
WARM_REQUESTS = 64  # the server's graph replays and the client threads' first calls


def arrivals(rate: float, seconds: float, seed: int, tag: str) -> np.ndarray:
    """Due times (s from the window's start) of round(rate * seconds)
    requests."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log(1.0 - (np.arange(n) + 0.5) / n) / rate
    gaps *= seconds / gaps.sum()
    gaps = np.random.default_rng(inputs.sub_seed(seed, tag)).permutation(gaps)
    return np.cumsum(gaps) - gaps[0]


class Requests:
    """Requests drawn from the seed: an image of the pool, EXIF, instruction."""

    def __init__(self, ctx, pool, n, tag):
        rng = np.random.default_rng(inputs.sub_seed(ctx.seed, tag + ".images"))
        self.pool = pool
        self.image = rng.integers(0, len(pool), n)
        self.exif = inputs.exif(n, ctx.seed, tag + ".exif", ctx.dims.num_cameras)
        self.guidance = inputs.instructions(n, ctx.seed, tag + ".instructions")

    def scalars(self, i):
        return {"camera_idx": int(self.exif["camera_idx"][i]),
                **{k: float(self.exif[k][i]) for k in ("focal_length", "aperture", "iso")}}

    def batch(self, idx):
        """The inputs of requests ``idx`` as one batch, for the reference."""
        import torch

        return {"images": torch.from_numpy(np.stack([self.pool[self.image[i]] for i in idx])),
                "exif": {k: torch.from_numpy(v[idx]) for k, v in self.exif.items()},
                "guidance": torch.from_numpy(self.guidance[idx].astype(np.int64))}


def client_pool(n: int) -> concurrent.futures.ThreadPoolExecutor:
    """``n`` client threads, all started before the first request."""
    ex = concurrent.futures.ThreadPoolExecutor(n)
    started = threading.Barrier(n + 1)
    for _ in range(n):
        ex.submit(started.wait)
    started.wait()
    return ex


def open_loop(server, req: Requests, due: np.ndarray, clients, seconds: float):
    """Latencies (s; inf where no answer came), answers, the generator's
    lateness and the failures of one open loop through the client pool
    ``clients``."""
    from torch.profiler import record_function

    n = len(due)
    lat = np.full(n, np.inf)
    answers = [None] * n
    start = time.perf_counter() + 0.01
    give_up = start + seconds + 60.0

    def client(i):
        with record_function("bench.client"):
            answers[i] = server.submit(req.pool[req.image[i]], req.scalars(i),
                                       INSTRUCTIONS[req.guidance[i]],
                                       timeout=max(0.1, give_up - time.perf_counter()))
        lat[i] = time.perf_counter() - (start + due[i])

    late = np.empty(n)
    futures = []
    for i in range(n):
        wait = start + due[i] - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late[i] = time.perf_counter() - (start + due[i])
        futures.append(clients.submit(client, i))
    failed = sum(f.exception() is not None for f in futures)
    return lat, answers, late, failed


def run(ctx) -> Outcome:
    import torch

    from cognitive_aim_tpu_torch.serve import BatchingServer

    t, d = ctx.traffic, ctx.dims
    cuda = ctx.device.type == "cuda"
    rate = float(t["rate_per_s"])
    eng, flat = system.build(ctx, t.get("token_filter", ""))
    server = BatchingServer(eng, max_batch=int(t["max_batch"]),
                            max_delay_ms=float(t["max_delay_ms"]))
    u8 = inputs.images_u8(POOL_IMAGES, d.image, ctx.seed, "served.images", ctx.device)
    pool = list(normalize_u8(u8).cpu().numpy())
    del u8
    clients = client_pool(int(t["clients"]))
    warm = Requests(ctx, pool, WARM_REQUESTS, "served.warm")
    open_loop(server, warm, arrivals(rate, len(warm.image) / rate, ctx.seed, "served.warm"),
              clients, len(warm.image) / rate)
    if cuda:
        torch.cuda.synchronize()
    setup_s = ctx.setup_s()
    ctx.log(f"set-up {setup_s:.2f} s; window of {ctx.seconds} s at {rate} requests/s")

    due = arrivals(rate, ctx.seconds, ctx.seed, "served.window")
    req = Requests(ctx, pool, len(due), "served.window")
    k0 = len(server.batches)
    lat, answers, late, failed = open_loop(server, req, due, clients, ctx.seconds)
    batches = list(server.batches)[k0:]
    mem = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    order = np.sort(lat)
    p95 = order[math.ceil(0.95 * len(order)) - 1]
    if not math.isfinite(p95):  # more than 5% lost: the wait they got
        p95 = ctx.seconds + 60.0
    ctx.log(f"window: {len(due)} requests, {failed} failed, p50 "
            f"{np.median(lat) * 1e3:.2f} ms, p95 {p95 * 1e3:.2f} ms, {len(batches)} batches "
            f"of {np.mean([b['n'] for b in batches]):.2f}; generator late by median "
            f"{np.median(late) * 1e3:.3f} ms, p99 {np.percentile(late, 99) * 1e3:.3f} ms, "
            f"max {late.max() * 1e3:.3f} ms")

    stretch = None
    if ctx.trace and cuda:
        from benchmark import trace

        ts = trace.STRETCH_S
        tdue = arrivals(rate, ts, ctx.seed, "served.trace")
        treq = Requests(ctx, pool, len(tdue), "served.trace")
        stretch = trace.take(lambda: open_loop(server, treq, tdue, clients, ts))
        ctx.log(f"traced stretch: {len(tdue)} requests, {stretch.window_s:.3f} s, busy "
                f"{stretch.busy_s:.3f} s, device clock - host clock {stretch.skew_s * 1e3:.3f} ms")
    clients.shutdown()
    server.stop()
    if server.dispatcher.is_alive():
        raise RuntimeError("the server's dispatcher did not stop")

    # the reference on a sample of the answered requests, drawn from the seed
    answered = [i for i in range(len(due)) if answers[i] is not None]
    rng = np.random.default_rng(inputs.sub_seed(ctx.seed, "served.check"))
    pick = np.sort(rng.choice(answered, size=min(int(t["check_requests"]), len(answered)),
                              replace=False))
    rows = int(t["max_batch"])
    cases = []
    for a in range(0, len(pick), rows):
        idx = pick[a:a + rows]
        out = {"depth": torch.tensor([answers[i][0] for i in idx], dtype=torch.float64),
               "confidence": torch.tensor([answers[i][1] for i in idx], dtype=torch.float64)}
        cases.append((req.batch(idx), out))
    del eng, server
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = compare.against_reference(ctx, flat, cases)
    ctx.log(f"reference over {len(pick)} requests of the window: {time.perf_counter() - t0:.1f} s")
    records = {"ref": ctx.ref, "dims": d, "batch": int(t["max_batch"]),
               "token_filter": ctx.token_filter, "batches": batches,
               "max_batch": int(t["max_batch"]), "stretch": stretch}
    return Outcome(e2e={"latency_p95_ms": p95 * 1e3}, setup_s=setup_s, attempted=len(due),
                   failed=failed, numbers=numbers, memory_peak_bytes=mem, records=records,
                   stretch=stretch, cases=cases, flat=flat)
