"""Captured CUDA graphs: the engine's compiled forward, one graph per forward
signature (the port's counterpart of the JAX engine's ``jax.jit`` cache,
cognitive_aim_tpu/api.py, which keeps one jitted forward per batch shape and
guided / unguided, with uint8 normalisation inside the uint8 ones), and,
through the same ``GraphCache``, the trainer's compiled micro-steps and eval
forward (train/trainer.py).

``GraphCache.run`` is the general form: a key, the call's inputs, the
function captured at the key's first call, one seed a noise stream (one
generator each, registered with the graph), and whether the function is
stateful. A stateful function (a training step, which updates the
parameters and the optimizer in place) runs eagerly at its first call, as
the warm-up, and is captured then without running; every later call
replays it. Nothing below differs for it otherwise.

``CompiledForward`` maps a key (the engine's ``Signature``: guided or not,
float or uint8 input, batch, image size, and the batch shard the forward
runs under) and the layout of the call's inputs (names, shapes, dtypes: a
call that passes other inputs is another forward, as it is to ``jax.jit``)
to one ``Captured`` forward:

  * the first call of a key and layout makes the static inputs (on the device, the
    shapes and dtypes of this call's inputs, filled with them), runs one
    eager forward on a side stream (they build the kernel
    library, set each kernel's attributes, and fill every ``lru_cache``d
    device table, which capture cannot create), then captures one forward
    with ``torch.cuda.graph`` into the cache's one memory pool;
  * every call copies its inputs into the static ones (host tensors are
    copied straight from the host), seeds the graph's generator, replays
    the graph and copies the outputs out of the graph's buffers, all under
    one lock: the server's dispatcher and its handler threads both reach
    the engine, and serialised replays let every graph share one pool. A
    call enqueues after the previous call's copies out, whatever stream it
    runs on: it waits for an event the previous call recorded.

Each call keeps its clock readings per thread; ``GraphCache.last_call()``
turns them into its host split (``call_record``: the lock's wait, the
copies in, the replay's launch and the copies out, whether it captured
first) for the caller on the same thread, so two threads calling at once
cannot mix their records. A call pays a few clock reads for it and opens
no profiler range: a range around a copy or a launch would count as
device work in a trace.

What the captured forward reads from Python (``CAIM_FUSE_AOMLP``, the model's
modules, the batch shard's rows) is read while capturing, as JAX reads it
while tracing: a later change does not reach a graph already captured.

Noise: a sampling forward draws from one device generator per graph,
registered with it; ``manual_seed(seed)`` before a replay resets its offset,
so the replay draws what an eager forward with a fresh generator seeded
``seed`` draws.

Launch counts: each kernel wrapper counts its launches in Python where it
launches (``kernels.counters()``), and this module touches no count. The
warm-up forward counts what it ran; the capture counts the launches it
recorded into the graph; a replay runs no Python and counts nothing. What a
replay ran shows on the device: ``utils.profiling.traced_kernels`` reads it
from a profiler trace.

A capture that breaks raises ``CaptureError`` naming the operation, found by
``HostSyncGuard``, which the capture runs under: it refuses an operation that
would synchronise the host with the device or carry host data into the
forward. Nothing carries on eagerly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import threading
import time
from typing import Any, Callable, Dict, Hashable, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode


class CaptureError(RuntimeError):
    """A forward that cannot be captured, with the operation that broke it."""


class Signature(NamedTuple):
    """What a compiled forward is specialised on, as the JAX engine's jitted
    forwards are: guided or unguided, float or uint8 images, batch and image
    size; ``shard`` is the batch shard the forward runs under
    (``parallel.comm.current_shard()``), whose rows the graph bakes in."""
    guided: bool
    uint8: bool
    batch: int
    height: int
    width: int
    shard: Hashable = None


# ------------------------------------------------------------ the guard ----
# Operations that return a value to the host (every Python conversion of a
# tensor, ``item``, ``bool``, ``if t``, goes through _local_scalar_dense) or
# whose output shape depends on the values (the host waits for them)
_SYNC_OPS = frozenset({
    "_local_scalar_dense", "item", "is_nonzero", "equal", "allclose",
    "nonzero", "nonzero_numpy", "argwhere", "masked_select", "_unique", "_unique2",
    "unique_dim", "unique_consecutive", "unique_dim_consecutive", "bincount", "histc",
    "_assert_scalar",
})
# indexing by a boolean mask runs nonzero inside
_MASK_INDEX_OPS = frozenset({"index", "index_put", "index_put_", "_index_put_impl_",
                             "_unsafe_index", "_unsafe_index_put"})
# a tensor made from host data by torch.tensor / torch.as_tensor of a list
_HOST_DATA_OPS = frozenset({"lift_fresh", "lift_fresh_copy"})


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)


class HostSyncGuard(TorchDispatchMode):
    """Raises ``CaptureError`` on an operation that would synchronise the
    host with the device or carry host data into the forward:

      * ``_SYNC_OPS``: a value back to the host (``_local_scalar_dense``,
        which every Python conversion of a tensor reaches) or an output
        whose shape depends on the values (``nonzero`` and what is built on
        it);
      * indexing by a boolean mask (``nonzero`` inside);
      * a copy between the host and a device (``_to_copy``, ``copy_``);
      * ``lift_fresh``: a tensor made from host data (``torch.tensor``).

    An operation that fails under the guard raises ``CaptureError`` naming
    it. The guard holds no tensor: a capture's pool reuses what the forward
    frees."""

    def _refuse(self, name: str, why: str):
        raise CaptureError(f"{name}: {why}; a captured forward may not synchronise the "
                           f"host with the device or read host data")

    def _check(self, func, args, kwargs):
        name = func._schema.name
        packet = name.split("::")[-1]
        if packet in _SYNC_OPS:
            self._refuse(name, "a host synchronisation (a value or an output shape the "
                               "host must wait for)")
        if packet in _HOST_DATA_OPS:
            self._refuse(name, "a tensor made from host data (torch.tensor)")
        if packet in _MASK_INDEX_OPS:
            idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
            if any(t.dtype in (torch.bool, torch.uint8) for t in _tensors(idx)):
                self._refuse(name, "indexing by a boolean mask (nonzero inside)")
        if packet == "_to_copy":
            dst = kwargs.get("device")
            if dst is not None and torch.device(dst).type != args[0].device.type:
                self._refuse(name, f"a copy from {args[0].device} to {dst}")
        if packet == "copy_" and args[0].device.type != args[1].device.type:
            self._refuse(name, f"a copy from {args[1].device} to {args[0].device}")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self._check(func, args, kwargs)
        try:
            return func(*args, **kwargs)
        except CaptureError:
            raise
        except Exception as e:
            raise CaptureError(f"{func._schema.name} failed while capturing: {e}") from e


# ------------------------------------------------------------ the graphs ----
class CudaGraphs:
    """How the cache captures and replays on the card. A stand-in with the
    same methods runs the cache's logic on the CPU (the tests)."""

    def pool(self, device):
        return torch.cuda.graph_pool_handle()

    def graph(self):
        return torch.cuda.CUDAGraph()

    def generator(self, device):
        return torch.Generator(device=device)

    @contextlib.contextmanager
    def side_stream(self, device):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            yield
        torch.cuda.current_stream(device).wait_stream(side)

    def capture(self, graph, pool, fn: Callable[[], Any]):
        """``fn()`` captured into ``graph``: its outputs, the graph's buffers.
        Python's cyclic collector stays off meanwhile: an object it frees
        could destroy another graph, which a capture does not permit."""
        gc_was_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                return fn()
        finally:
            if gc_was_on:
                gc.enable()

    def reserved(self, device) -> int:
        """The device memory the caching allocator holds, its free cached
        blocks released first (a graph's pool keeps its own)."""
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved(device)

    def fence(self, device):
        """An event recorded on the current stream after what it has queued."""
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        return event

    def wait(self, event, device):
        """The current stream waits for ``event`` before what it queues next."""
        torch.cuda.current_stream(device).wait_event(event)


@dataclasses.dataclass
class Captured:
    """One captured function: its graph, static inputs and outputs, the
    generators registered with it (stream -> generator; none without
    noise), and what the capture cost."""
    graph: Any
    inputs: Dict[str, torch.Tensor]
    outputs: Any
    generators: Dict[Hashable, torch.Generator]
    capture_s: float
    pool_bytes: int
    replays: int = 0

    @property
    def generator(self) -> Optional[torch.Generator]:
        """The one generator of a forward that samples noise, else None."""
        return next(iter(self.generators.values()), None)


def _clone(obj):
    """The outputs copied out of the graph's buffers (tensors cloned,
    containers rebuilt, anything else as it is)."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _clone(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, dict):
        return {k: _clone(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_clone(v) for v in obj)
    return obj


def _layout(inputs: Dict[str, torch.Tensor]) -> tuple:
    """The names, shapes and dtypes of a call's inputs."""
    return tuple((n, tuple(t.shape), t.dtype) for n, t in sorted(inputs.items()))


def call_record(entered: int, locked: int, copy_in: int, launch: int, copy_out: int,
                done: int, captured: bool = False) -> Dict[str, Any]:
    """One call's host split from its ``time.perf_counter_ns()`` readings,
    each span a (start, end) pair: ``lock_wait`` (entered to locked),
    ``copy_in`` (the copies into the graph's static inputs), ``launch``
    (the generators' seeds and the replay's launch), ``copy_out`` (the clone
    of the outputs out of the graph's buffers); ``captured``: the call
    captured its graph first, between ``lock_wait`` and ``copy_in``."""
    return {"lock_wait": (entered, locked), "copy_in": (copy_in, launch),
            "launch": (launch, copy_out), "copy_out": (copy_out, done), "captured": captured}


class GraphCache:
    """Captured functions on one device, in one memory pool, replayed under
    one lock (see the module docstring). ``graphs`` maps (key, the inputs'
    layout) to its ``Captured``; ``backend``: ``CudaGraphs`` on the card.

    ``run`` takes the function of a key, ``fn(inputs, generators)`` on a
    dict of device tensors and a dict stream -> generator. A function is
    pure (a forward: its warm-up is thrown away and every call, the first
    too, replays the graph) or ``stateful`` (a training step, which updates
    tensors in place: the first call of a key runs it eagerly, as the
    warm-up, then captures it; every later call replays it)."""

    def __init__(self, device, *, backend=None):
        self.device = torch.device(device)
        self.backend = backend or CudaGraphs()
        self.graphs: Dict[Hashable, Captured] = {}
        self.lock = threading.Lock()
        self._pool = None
        self._done = None  # the last call's event, after its copies out
        self._calls = threading.local()  # each thread's last call's readings

    def last_call(self) -> Optional[Dict[str, Any]]:
        """The host split of this thread's last ``run`` (``call_record``),
        or None: none yet, or the last one raised or ran a stateful key's
        warm-up. Another thread's calls do not touch it."""
        return call_record(*self._calls.last) if getattr(self._calls, "last", None) else None

    def run(self, key: Hashable, inputs: Dict[str, torch.Tensor], fn: Callable,
            seeds: Optional[Dict[Hashable, int]] = None, *, stateful: bool = False,
            grad: bool = False, what: str = "the function"):
        """``fn`` of ``inputs`` (name -> tensor, on any device) through the
        graph of ``key`` and the inputs' names, shapes and dtypes. ``seeds``
        (stream -> seed; the key decides which streams there are): each
        stream's generator is seeded so before the call, and draws what a
        fresh generator seeded so draws. ``fn`` is read only when the graph
        is captured. ``grad``: autograd on (a step's backward). ``what``
        names the function in a ``CaptureError``. Returns the outputs,
        copied; ``last_call()`` then holds the call's host split."""
        be, dev = self.backend, self.device
        seeds = dict(seeds or {})
        full = (key, _layout(inputs))
        self._calls.last = None
        t_enter = time.perf_counter_ns()
        with self.lock, torch.enable_grad() if grad else torch.no_grad():
            t_locked = time.perf_counter_ns()
            if self._done is not None:
                be.wait(self._done, dev)
            entry = self.graphs.get(full)
            captured = entry is None
            if captured:
                entry, warm = self._capture(full, inputs, fn, seeds, stateful, what)
                self.graphs[full] = entry
                if stateful:  # the warm-up was this call
                    self._done = be.fence(dev)
                    return warm
            t_copy = time.perf_counter_ns()
            for name, t in inputs.items():
                entry.inputs[name].copy_(t, non_blocking=True)
            t_launch = time.perf_counter_ns()
            for stream, gen in entry.generators.items():
                gen.manual_seed(int(seeds[stream]))
            entry.graph.replay()
            entry.replays += 1
            t_out = time.perf_counter_ns()
            out = _clone(entry.outputs)
            t_end = time.perf_counter_ns()
            self._done = be.fence(dev)
            # the readings alone: the record is built when it is read
            self._calls.last = (t_enter, t_locked, t_copy, t_launch, t_out, t_end, captured)
            return out

    def _capture(self, key, inputs, fn, seeds, stateful, what):
        """(the ``Captured`` of ``key``, the warm-up's outputs)."""
        be, dev = self.backend, self.device
        t0 = time.perf_counter()
        static = {n: torch.empty(t.shape, dtype=t.dtype, device=dev) for n, t in inputs.items()}
        for n, t in inputs.items():
            static[n].copy_(t)
        # one eager run: what capture cannot do (kernel builds, lazy tables);
        # a stateful function's is the call itself, with the call's seeds
        warm_gens = {s: be.generator(dev).manual_seed(int(seeds[s]) if stateful else 0)
                     for s in seeds}
        with be.side_stream(dev):
            warm = fn(static, warm_gens)
        if not self.graphs:  # a pool whose graphs are all gone is released: a new one
            self._pool = be.pool(dev)
        gens = {s: be.generator(dev) for s in seeds}
        graph = be.graph()
        for gen in gens.values():
            graph.register_generator_state(gen)
        reserved = be.reserved(dev)

        def run():
            with HostSyncGuard():
                return fn(static, gens)

        try:
            outputs = be.capture(graph, self._pool, run)
        except CaptureError as e:
            raise CaptureError(f"capturing {what} of {key[0]} broke at {e}") from None
        return Captured(graph, static, outputs, gens, time.perf_counter() - t0,
                        be.reserved(dev) - reserved), warm

    def pool_bytes(self) -> int:
        """The bytes the captures added to the pool, all graphs together."""
        return sum(e.pool_bytes for e in self.graphs.values())

    def describe(self) -> Dict[str, Any]:
        """Graphs held, pool bytes and, per graph, its capture seconds, pool
        bytes and replays (for logs)."""
        return {"graphs": len(self.graphs), "pool_bytes": self.pool_bytes(),
                "each": [{"key": str(k), "inputs": [n for n, _, _ in layout],
                          "capture_s": e.capture_s, "pool_bytes": e.pool_bytes,
                          "replays": e.replays}
                         for (k, layout), e in self.graphs.items()]}


class CompiledForward(GraphCache):
    """The engine's cache of captured forwards (see the module docstring).
    ``fn(inputs, generator)`` is the eager forward on a dict of device
    tensors; ``sample_noise``: it draws from ``generator`` (else it gets
    None); ``backend``: ``CudaGraphs`` on the card."""

    def __init__(self, fn: Callable, device, *, sample_noise: bool = False, backend=None):
        super().__init__(device, backend=backend)
        self.fn = fn
        self.sample_noise = sample_noise

    def __call__(self, key: Hashable, inputs: Dict[str, torch.Tensor],
                 seed: Optional[int] = None):
        """The forward of ``inputs`` (name -> tensor, on any device) through
        the graph of ``key`` and the inputs' names, shapes and dtypes,
        captured at its first call; ``seed`` seeds the noise. Returns the
        outputs, copied."""
        seeds = {"noise": int(seed or 0)} if self.sample_noise else None
        return self.run(key, inputs, self._forward, seeds, what="the forward")

    def _forward(self, inputs, generators):
        return self.fn(inputs, generators.get("noise"))
