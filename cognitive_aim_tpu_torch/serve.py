"""Micro-batching HTTP server for guided depth inference (counterpart of
cognitive_aim_tpu/serve.py). Standard library only (http.server + threads):

  * POST /predict        {"image_b64": ... | "path": ..., "instruction": "center"}
                         -> {"depth": float, "confidence": float}
  * POST /predict_batch  {"paths": [...], "instruction": ... |
                          "instructions": [...]} -> {"results": [[d, c], ...]}
  * GET  /healthz        -> model/config summary

/predict requests queue up; one dispatcher thread drains up to
``max_batch`` of them within ``max_delay_ms``, pads the batch to exactly
``max_batch`` (one forward shape for every load) and runs ONE guided forward
for the mixed instruction set (the guidance index is a per-image vector).
Before the server accepts traffic, ``BatchingServer`` runs one padded
``max_batch`` forward: on the card that captures the engine's one guided
``max_batch`` graph (core/compiled.py: one eager forward builds and loads the
kernel library and sets each launcher's attributes, then the capture), as the
JAX server compiles its one graph, so every batch after is one graph replay.
The dispatcher stages every batch in one host buffer it keeps for its
lifetime, ``[max_batch, image_size, image_size, 3]`` float32, page-locked
when the engine runs on the card: each request's image is copied into its
row and the pad rows take the batch's last image, so the engine's copy into
its graph's input is an asynchronous DMA that the host only enqueues. The
warm-up forward reads the same buffer. A batch with an image of another
shape or dtype is stacked into fresh arrays instead.
``/predict_batch`` runs ``predict_paths_batched`` at the server's
``max_batch`` (its uint8 graph, captured at its first request); a client
``batch_size`` is ignored.

**The records.** ``BatchingServer.batches`` keeps, in memory, one record
for each of the last 4096 batches the dispatcher ran. Every time in it is
a ``time.perf_counter_ns()`` reading, and every span a (start, end) pair
of them:

  * ``id``, ``n`` (its requests) and ``requests``, one entry a request:
    its ``id``, ``submitted`` (``submit`` entered), ``taken`` (the
    dispatcher dequeued it), ``answered`` (its result and event set) and
    ``returned`` (``submit`` returns; the caller's thread writes it, None
    if the caller timed out);
  * the dispatcher's spans, which tile its time: ``wait`` (in
    ``queue.get`` with no request, from the previous batch's last answer
    to this batch's first take), ``fill`` (first take to the batch closed:
    the ``max_delay_ms`` wait for more), ``stack`` (closed to the engine
    call: the copies of the images into the kept buffer, the pad rows, the
    EXIF arrays), ``engine``
    (the engine's ``_forward``), ``drain`` (the ``.cpu()`` wait for the
    outputs) and ``reply`` (setting the results and events);
  * inside ``engine``, the engine's host split
    (``CognitiveAimInference.last_call()``): ``lock_wait``, ``copy_in``
    (on the card the copies into the graph's static inputs: the host's
    enqueue of the page-locked batch's copy, whose device time lands in
    ``drain``, and the EXIF and guidance vectors' few bytes), ``launch``
    (the replay), ``copy_out`` (the outputs' clone), and ``captured`` (the
    call captured its graph first);
  * ``dispatch_ms`` (the EXIF arrays' ``from_numpy`` and the engine call)
    and ``drain_ms`` (``drain``), in milliseconds;
  * ``staged``: True where the batch's images went through the kept buffer,
    False where one of them did not fit it and the batch was stacked into
    fresh arrays: the count of how often the buffer serves.

A request's stages tile its time in the server: its queue wait (taken -
submitted), the rest of its batch's fill (closed - taken), the batch's
stack, engine and drain, its own reply (answered - drain's end) and its
thread's wake (returned - answered). ``stage_ms(batches)`` averages them.
A record joins ``batches`` before its waiters wake; its ``reply`` and
its answers are written after, so read whole records after ``stop()``.

To place a span against a ``torch.profiler`` trace: ``clock`` holds one
reading of ``perf_counter_ns`` and one of ``time.time_ns()``, taken when
the server starts, and ``epoch_ns(t)`` moves a reading onto the Unix-epoch
nanoseconds the profiler's host events carry; the trace's skew between
the host's and the device's clocks (``benchmark/trace.py``) then places it
against the device's work. The server opens no profiler range: the
profiler records ranges only from the thread that started it, and one
around a copy or a launch would count as device work. Each request's
host decode is kept in ``decode_ms``.

Run: python -m cognitive_aim_tpu_torch.serve --config configs/experiment_B.yaml \\
         [--checkpoint ckpt.pth] [--port 8321] [--policy int8]
         [--token-filter 2:0.35] [--max-batch 16] [--max-delay-ms 5]
"""

from __future__ import annotations

import argparse
import base64
import collections
import io as _io
import itertools
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch


class _Pending:
    __slots__ = ("image", "exif", "gidx", "event", "result", "abandoned", "entry")

    def __init__(self, image, exif, gidx, entry):
        self.image = image      # [H, W, 3] float32 normalized
        self.exif = exif        # dict of scalars
        self.gidx = int(gidx)
        self.event = threading.Event()
        self.result = None      # (depth, confidence) | Exception
        self.abandoned = False  # waiter timed out; don't spend device time
        self.entry = entry      # the request's entry in its batch's record


# a batch's spans in the order they run, each a (start, end) pair of
# time.perf_counter_ns() readings; the engine's split lies inside ``engine``
BATCH_SPANS = ("wait", "fill", "stack", "engine", "lock_wait", "copy_in", "launch",
               "copy_out", "drain", "reply")


def stage_ms(batches) -> dict:
    """Mean milliseconds of each of ``BATCH_SPANS`` and of ``dispatch_ms``
    over the batch records ``batches`` (``BatchingServer.batches``, read
    after ``stop()``), and of each answered request's ``queue_wait``
    (submitted to taken) and ``wake`` (answered to returned); keys end in
    ``_ms``."""
    reqs = [r for b in batches for r in b["requests"] if r["returned"] is not None]
    spans = {f"{k}_ms": [(b[k][1] - b[k][0]) / 1e6 for b in batches] for k in BATCH_SPANS}
    spans["dispatch_ms"] = [b["dispatch_ms"] for b in batches]
    spans["queue_wait_ms"] = [(r["taken"] - r["submitted"]) / 1e6 for r in reqs]
    spans["wake_ms"] = [(r["returned"] - r["answered"]) / 1e6 for r in reqs]
    return {k: float(np.mean(v)) if v else float("nan") for k, v in spans.items()}


class BatchingServer:
    """Owns the engine and the micro-batching dispatcher thread, and the
    records of each batch it ran (``batches``; see the module docstring)."""

    def __init__(self, engine, max_batch: int = 16, max_delay_ms: float = 5.0,
                 request_timeout: float = 120.0, warmup: bool = True):
        self.engine = engine
        self.max_batch = max_batch
        self.max_delay = max_delay_ms / 1e3
        self.request_timeout = request_timeout
        self.queue: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self.batches: collections.deque = collections.deque(maxlen=4096)
        self.decode_ms: collections.deque = collections.deque(maxlen=4096)
        # one reading of both clocks: epoch_ns() moves a record's time onto
        # the Unix-epoch clock of the profiler's host events
        self.clock = (time.perf_counter_ns(), time.time_ns())
        self._request_ids = itertools.count()  # next() is one atomic call
        self._batch_ids = itertools.count()
        # every batch's images, padded; page-locked where the engine is on the
        # card (pinning needs one), so its copy into the graph is an async DMA
        size = engine.image_size
        self._staging = torch.zeros((max_batch, size, size, 3), dtype=torch.float32,
                                    pin_memory=engine.device.type == "cuda")
        self.warmed_up = False
        if warmup:
            # the dispatcher's exact shape and dtypes, so nothing one-time is
            # left for the first real batch (on the card: its graph's capture)
            self._forward(
                self._staging,
                {"camera_idx": np.zeros((max_batch,), np.int32),
                 "focal_length": np.full((max_batch,), 50.0, np.float32),
                 "aperture": np.full((max_batch,), 2.8, np.float32),
                 "iso": np.full((max_batch,), 100.0, np.float32)},
                np.zeros((max_batch,), np.int64), max_batch)
            self.warmed_up = True
        self.dispatcher = threading.Thread(target=self._run, daemon=True)
        self.dispatcher.start()

    def epoch_ns(self, t: int) -> int:
        """A record's ``time.perf_counter_ns()`` reading on the Unix-epoch
        clock (``time.time_ns()``) that ``torch.profiler``'s host events
        carry."""
        return t - self.clock[0] + self.clock[1]

    # ------------------------------------------------------------ intake ----
    def submit(self, image_np, exif_scalars, instruction: str, timeout=None):
        from cognitive_aim_tpu_torch.models import guidance as G

        entry = {"id": next(self._request_ids), "submitted": time.perf_counter_ns(),
                 "taken": None, "answered": None, "returned": None}
        p = _Pending(image_np, exif_scalars, G.instruction_index(instruction), entry)
        self.queue.put(p)
        if not p.event.wait(timeout or self.request_timeout):
            p.abandoned = True  # dispatcher drops it instead of computing
            raise TimeoutError("inference timed out")
        entry["returned"] = time.perf_counter_ns()
        if isinstance(p.result, Exception):
            raise p.result
        return p.result

    # -------------------------------------------------------- dispatcher ----
    def _stage(self, batch):
        """The batch's images padded to ``max_batch`` with its last one, as
        one host tensor, and whether that is the kept buffer (each image of
        its shape and dtype) or a fresh stack."""
        buf = self._staging.numpy()
        n = len(batch)
        if not all(isinstance(p.image, np.ndarray) and p.image.shape == buf.shape[1:]
                   and p.image.dtype == buf.dtype for p in batch):
            imgs = np.stack([p.image for p in batch])
            if n < self.max_batch:
                imgs = np.concatenate([imgs, np.repeat(imgs[-1:], self.max_batch - n, axis=0)])
            return torch.from_numpy(imgs), False
        for row, p in zip(buf, batch):
            row[...] = p.image
        buf[n:] = buf[n - 1]
        return self._staging, True

    def _forward(self, x, exif, gidx, n, rec=None):
        """One padded forward of the host images ``x``; returns (depths,
        confidences) of the first n. ``rec``: the batch's record, which gets
        its ``stack`` end, the engine's spans and ``drain``, ``dispatch_ms``
        and ``drain_ms``."""
        eng = self.engine
        t_np = time.perf_counter_ns()
        # host tensors: the engine copies them into its graph's inputs
        e = {k: torch.from_numpy(v) for k, v in exif.items()}
        g = torch.from_numpy(gidx)
        t_call = time.perf_counter_ns()
        try:
            out = eng._forward(x, e, g)
            split = eng.last_call()
            t_back = time.perf_counter_ns()
            # the drain waits for the stream: the copy out of ``x`` has landed
            depths = out.depth[:n, 0].cpu().numpy()
            confs = out.confidence[:n, 0].cpu().numpy()
        except Exception:
            if x.is_pinned():  # a copy out of it may be in flight: let it land before a refill
                torch.cuda.synchronize(eng.device)
            raise
        t_drained = time.perf_counter_ns()
        if rec is not None:
            rec.update(split, stack=(rec["fill"][1], t_call), engine=(t_call, t_back),
                       drain=(t_back, t_drained), dispatch_ms=(t_back - t_np) / 1e6,
                       drain_ms=(t_drained - t_back) / 1e6)
        return depths, confs

    def _run(self):
        idle = time.perf_counter_ns()  # the last batch's last answer set
        while not self._stop.is_set():
            try:
                first = self.queue.get(timeout=0.1)
            except queue.Empty:
                continue
            t_first = first.entry["taken"] = time.perf_counter_ns()
            batch = [] if first.abandoned else [first]
            deadline = time.perf_counter() + self.max_delay
            while len(batch) < self.max_batch:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    p = self.queue.get(timeout=left)
                except queue.Empty:
                    break
                p.entry["taken"] = time.perf_counter_ns()
                if not p.abandoned:  # no device time for dead waiters
                    batch.append(p)
            if not batch:
                continue
            n = len(batch)
            rec = {"id": next(self._batch_ids), "n": n, "requests": [p.entry for p in batch],
                   "wait": (idle, t_first), "fill": (t_first, time.perf_counter_ns())}
            try:
                # pad to the one forward shape
                pad = self.max_batch - n
                x, rec["staged"] = self._stage(batch)
                exif = {
                    k: np.asarray([p.exif[k] for p in batch] + [batch[-1].exif[k]] * pad)
                    for k in batch[0].exif
                }
                exif = {
                    k: (v.astype(np.int32) if k == "camera_idx" else v.astype(np.float32))
                    for k, v in exif.items()
                }
                gidx = np.asarray([p.gidx for p in batch] + [0] * pad, np.int64)
                depths, confs = self._forward(x, exif, gidx, n, rec)
                self.batches.append(rec)  # before any waiter wakes and reads it
                for p, d, c in zip(batch, depths, confs):
                    p.result = (float(d), float(c))
                    p.entry["answered"] = time.perf_counter_ns()
                    p.event.set()
                idle = time.perf_counter_ns()
                rec["reply"] = (rec["drain"][1], idle)
            except Exception as e:  # surface to every waiter
                for p in batch:
                    p.result = e
                    p.event.set()
                idle = time.perf_counter_ns()

    def stop(self):
        self._stop.set()
        self.dispatcher.join(timeout=2.0)


def _check_path_allowed(path: str, data_root):
    """Server-local file access is an oracle/DoS surface for any network
    client; restrict it to an explicit --data-root (None = disabled)."""
    import os

    if data_root is None:
        raise ValueError(
            "path-based requests are disabled (start the server with "
            "--data-root to allow them); send image_b64 instead")
    real = os.path.realpath(path)
    root = os.path.realpath(str(data_root))
    if os.path.commonpath([real, root]) != root:
        raise ValueError("path outside the allowed data root")
    return real


def _decode_request_image(payload, engine, data_root=None):
    """'image_b64' (PNG/JPEG bytes) or server-local 'path' (gated by
    data_root) -> normalized [H, W, 3] float32 + host EXIF scalars (same
    ranges as ``predict``)."""
    from PIL import Image

    from cognitive_aim_tpu_torch.io import exif as exif_io
    from cognitive_aim_tpu_torch.io.preprocess import normalize_np, pil_resize_host

    size = engine.image_size
    if "image_b64" in payload:
        raw = base64.b64decode(payload["image_b64"])
        with Image.open(_io.BytesIO(raw)) as im:
            exif_raw = exif_io.extract_exif_from_pil(im)
            u8 = np.asarray(im.convert("RGB"), np.uint8)
    elif "path" in payload:
        from cognitive_aim_tpu_torch.io.preprocess import load_image_uint8

        path = _check_path_allowed(payload["path"], data_root)
        u8 = load_image_uint8(path)
        exif_raw = exif_io.extract_exif(path)
    else:
        raise ValueError("request needs 'image_b64' or 'path'")
    img = normalize_np(pil_resize_host(u8, size, size)).astype(np.float32)
    arrs = exif_io.exif_arrays_for_model(exif_raw, engine.camera_to_id)
    exif = {k: np.asarray(v).reshape(-1)[0] for k, v in arrs.items()}
    return img, exif


def make_handler(server: BatchingServer, data_root=None):
    engine = server.engine

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet by default
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                a = engine.arch
                self._json(200, {
                    "status": "ok",
                    "image_size": engine.image_size,
                    "policy": type(engine.model.policy).__name__,
                    "token_filter": (
                        [list(s) for s in a.token_filter_schedule]
                        if a.token_filter_schedule
                        else [a.token_filter_layer, a.token_filter_keep]),
                    "max_batch": server.max_batch,
                })
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                if self.path == "/predict":
                    t0 = time.perf_counter()
                    img, exif = _decode_request_image(payload, engine, data_root)
                    server.decode_ms.append((time.perf_counter() - t0) * 1e3)
                    d, c = server.submit(img, exif, payload.get("instruction", "center"))
                    self._json(200, {"depth": d, "confidence": c})
                elif self.path == "/predict_batch":
                    paths = [_check_path_allowed(p, data_root)
                             for p in payload["paths"]]
                    # the device batch size is the server's decision (one
                    # forward shape per process), never a client knob
                    res = engine.predict_paths_batched(
                        paths,
                        instruction=payload.get("instruction"),
                        instructions=payload.get("instructions"),
                        batch_size=server.max_batch,
                    )
                    self._json(200, {"results": [
                        [None if np.isnan(d) else float(d),
                         None if np.isnan(c) else float(c)] for d, c in res
                    ]})
                else:
                    self._json(404, {"error": "unknown path"})
            except (ValueError, KeyError, json.JSONDecodeError) as e:
                # malformed request: the client's fault
                self._json(400, {"error": f"{type(e).__name__}: {e}"})
            except TimeoutError:
                self._json(504, {"error": "inference timed out"})
            except Exception:
                # server-side failure: don't leak internals to clients
                self._json(500, {"error": "internal error"})

    return Handler


def serve(engine, port: int = 8321, max_batch: int = 16,
          max_delay_ms: float = 5.0, request_timeout: float = 120.0,
          warmup: bool = True, host: str = "127.0.0.1", data_root=None):
    """Build the server, warming the padded-batch forward first so no request
    pays the one-time work; returns (httpd, batcher): call
    httpd.serve_forever() or drive it from a thread. Binds loopback unless
    ``host`` says otherwise; server-local file requests need ``data_root``."""
    batcher = BatchingServer(engine, max_batch, max_delay_ms,
                             request_timeout, warmup)
    httpd = ThreadingHTTPServer((host, port), make_handler(batcher, data_root))
    return httpd, batcher


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=str, default="configs/experiment_B.yaml")
    ap.add_argument("--checkpoint", type=str, default=None)
    ap.add_argument("--port", type=int, default=8321)
    ap.add_argument("--policy", type=str, default="int8")
    ap.add_argument("--attn", type=str, default="pallas_packed")
    ap.add_argument("--token-filter", type=str, default="")
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-delay-ms", type=float, default=5.0)
    ap.add_argument("--host", type=str, default="127.0.0.1",
                    help="bind address (default loopback; 0.0.0.0 to expose)")
    ap.add_argument("--data-root", type=str, default=None,
                    help="allow 'path'/'paths' requests under this directory "
                         "only (default: path requests disabled)")
    ap.add_argument("--device", type=str, default="auto",
                    help="auto (the CUDA device; raises without one) or cpu")
    args = ap.parse_args()

    from cognitive_aim_tpu_torch.api import CognitiveAimInference

    engine = CognitiveAimInference(
        args.config, args.checkpoint, args.device, policy=args.policy,
        attn_impl=args.attn, noise_mode="zeros", save_images=False,
        token_filter=args.token_filter,
    )
    httpd, _ = serve(engine, args.port, args.max_batch, args.max_delay_ms,
                     host=args.host, data_root=args.data_root)
    print(f"serving on {args.host}:{args.port} (max_batch={args.max_batch}, "
          f"policy={args.policy}, token_filter={args.token_filter or 'off'})",
          flush=True)
    httpd.serve_forever()


if __name__ == "__main__":
    main()
