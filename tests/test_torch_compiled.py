"""The engine's compiled forward (``cognitive_aim_tpu_torch/core/compiled.py``)
on the CPU: capture hygiene, the cache, and the engine's routing.

There is no CUDA graph here, so the tests hold what capture needs and what
the cache does to a stand-in graph; the card's tests (tests/test_torch_cuda.py,
marker ``cuda``) replay real graphs against ``engine.model(...)``.

  * **Capture hygiene.** Each serving configuration (the default policy,
    int8 exact, ``2:0.35``, ``2:0.35@p`` with ``pallas_packed_i8qk``,
    ``2:0.35@m@p``, ``2:0.35@d``, folded adapters under ``2:0.35``), guided
    and unguided, on float and uint8 images, with sampled noise: after one
    warm forward, the next must neither synchronise with the host nor read
    host data. It runs under ``HostDataGuard(known=...)``: the capture's
    ``HostSyncGuard``, which refuses ``_local_scalar_dense`` (every Python
    conversion of a tensor reaches it), the ops whose output shape depends
    on the values (``nonzero``, ``masked_select``, ``unique``, ``bincount``,
    ``histc``, indexing by a boolean mask), copies between devices and
    ``lift_fresh`` (``torch.tensor``), and besides any tensor that neither
    the warm forward read or made nor an operation of this forward made
    (``torch.from_numpy``: on the card its host-to-device copy shows, here
    nothing would). That list is complete for what a forward can do: a
    value reaches the host only as a scalar or through a data-dependent
    shape, and host data enters only by a copy, by ``torch.tensor`` or by a
    tensor made outside the dispatcher.
  * **The cache**, against a stand-in graph that re-runs the captured
    function at replay and runs no Python counter: the key, one capture a
    key, static inputs refilled at each call, replays equal to the eager
    forward bit for bit (the noise seeded as ``_next_key`` seeds it),
    serialised replays from two threads, each call ordered after the last
    one's copies out, another graph for other inputs, and the launch counts
    left to the wrappers (a replay counts nothing).
  * **The engine on the CPU** runs eagerly, as before; through a stand-in
    cache, every entry point reaches one graph a signature and answers as
    the eager engine.
"""

import contextlib
import json
import threading
import time

import numpy as np
import pytest
import torch

from cognitive_aim_tpu_torch.api import CognitiveAimInference
from cognitive_aim_tpu_torch.core import compiled as CF
from cognitive_aim_tpu_torch.core.rng import NoiseMode
from cognitive_aim_tpu_torch.nn.dinov2 import DinoV2Config

# hidden 128 as 2 heads of 64, 4 layers (a filter at layer 2 has blocks
# after it), 56x56 images: 16 patch tokens, 2:0.35 keeps 6
VIT = dict(hidden_size=128, num_layers=4, num_heads=2, patch_size=14, pretrain_image_size=56)
S = 56
B = 3
CFG = {"cognitive_modules": ["ambient_stream", "iterative_focal_stream", "exif_prior_database"],
       "dataset": {"image_size": S}, "exif_config": {"num_cameras": 5},
       "focal_config": {"num_iterations": 2}}
# name: (policy, attn_impl, token filter, fold adapters)
SERVING = {
    "default": ("default", "pallas_packed", "", False),
    "int8_exact": ("int8", "pallas_packed", "", False),
    "int8_2:0.35": ("int8", "pallas_packed", "2:0.35", False),
    "int8_2:0.35@p_i8qk": ("int8", "pallas_packed_i8qk", "2:0.35@p", False),
    "int8_2:0.35@m@p": ("int8", "pallas_packed", "2:0.35@m@p", False),
    "int8_2:0.35@d": ("int8", "pallas_packed", "2:0.35@d", False),
    "int8_folded_2:0.35": ("int8", "pallas_packed", "2:0.35", True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfg_path(tmp_path_factory):
    p = tmp_path_factory.mktemp("cfg") / "cfg.json"
    p.write_text(json.dumps(CFG))
    return str(p)


def _engine(cfg_path, name, noise="sample", seed=0):
    policy, impl, spec, fold = SERVING[name]
    eng = CognitiveAimInference(cfg_path, None, "cpu", vit_cfg=DinoV2Config(**VIT),
                                policy=policy, attn_impl=impl, token_filter=spec,
                                noise_mode=noise, seed=seed, save_images=False)
    if fold:  # adapters with a non-zero B folded into the dense weights
        rng = np.random.RandomState(3)
        L, D, r = VIT["num_layers"], VIT["hidden_size"], 4
        eng._materialize(None, {"backbone/layers/lora_A": rng.randn(L, r, D).astype(np.float32)
                                * 0.1,
                                "backbone/layers/lora_B": rng.randn(L, D, r).astype(np.float32)
                                * 0.1}, (r, r))
    return eng


def _inputs(seed, uint8, guided, b=B):
    rng = np.random.RandomState(seed)
    if uint8:
        images = torch.from_numpy(rng.randint(0, 256, (b, S, S, 3)).astype(np.uint8))
    else:
        images = torch.from_numpy(rng.randn(b, S, S, 3).astype(np.float32))
    inputs = {"images": images,
              "exif/camera_idx": torch.from_numpy(rng.randint(0, 5, b).astype(np.int32)),
              "exif/focal_length": torch.from_numpy(rng.uniform(20, 80, b).astype(np.float32)),
              "exif/aperture": torch.from_numpy(rng.uniform(1.4, 8, b).astype(np.float32)),
              "exif/iso": torch.from_numpy(rng.uniform(100, 800, b).astype(np.float32))}
    if guided:
        inputs["guidance"] = torch.from_numpy(rng.randint(0, 9, b).astype(np.int64))
    return inputs


class HostDataGuard(CF.HostSyncGuard):
    """The capture's guard, and besides, with ``known`` (a set of storages,
    ``record``'s ``seen``), a refusal of any tensor that neither existed then
    nor was made by an operation under this guard: one made from host data
    outside the dispatcher (``torch.from_numpy``), which on the card shows
    as a host-to-device copy and here would not show. With ``record=True``
    it checks nothing and collects into ``seen`` the storages of every
    tensor an operation reads or makes. Either way it keeps those tensors
    alive, so that no address is reused while it lives."""

    def __init__(self, known=None, record=False):
        super().__init__()
        self.known, self.record = known, record
        self.seen, self._alive = set(), []

    def _track(self, tensors):
        for t in tensors:
            s = t.untyped_storage().data_ptr() if t.numel() else None
            if s is not None and s not in self.seen:
                self.seen.add(s)
                self._alive.append(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.record:
            out = func(*args, **kwargs)
            self._track(CF._tensors((args, kwargs, out)))
            return out
        for t in CF._tensors((args, kwargs)):
            s = t.untyped_storage().data_ptr() if t.numel() else None
            if s is not None and s not in self.known and s not in self.seen:
                self._refuse(func._schema.name, f"reads a {tuple(t.shape)} {t.dtype} tensor "
                                                f"made from host data outside the dispatcher")
        out = super().__torch_dispatch__(func, types, args, kwargs)
        self._track(CF._tensors(out))
        return out


# ------------------------------------------------------- capture hygiene ----
@pytest.mark.parametrize("uint8", [False, True], ids=["float", "uint8"])
@pytest.mark.parametrize("guided", [True, False], ids=["guided", "unguided"])
@pytest.mark.parametrize("name", list(SERVING))
def test_warm_forward_neither_syncs_nor_reads_host_data(cfg_path, name, guided, uint8):
    eng = _engine(cfg_path, name)
    assert eng.noise_mode == NoiseMode.SAMPLE
    inputs = _inputs(0, uint8, guided)
    with HostDataGuard(record=True) as warm:
        eng._compiled_fn(inputs, torch.Generator().manual_seed(1))
    known = warm.seen | _storages(eng.model, inputs)
    with HostDataGuard(known=known):
        out = eng._compiled_fn(inputs, torch.Generator().manual_seed(2))
    assert out.depth.shape == (B, 1) and torch.isfinite(out.depth).all()


def _storages(model, inputs):
    """The storages of the model's parameters and buffers and of the inputs."""
    ts = [*model.parameters(), *model.buffers(), *inputs.values()]
    return {t.untyped_storage().data_ptr() for t in ts if t.numel()}


def _offends(kind):
    x = torch.arange(6, dtype=torch.float32)
    if kind == "item":
        return float(x.sum())
    if kind == "bool":
        return bool(x[0] > 0)
    if kind == "nonzero":
        return torch.nonzero(x)
    if kind == "mask_index":
        return x[x > 2]
    if kind == "unique":
        return torch.unique(x)
    if kind == "tensor":
        return x + torch.tensor(1.0)
    if kind == "from_numpy":
        return x + torch.from_numpy(np.ones(6, np.float32))


@pytest.mark.parametrize("kind", ["item", "bool", "nonzero", "mask_index", "unique", "tensor",
                                  "from_numpy"])
def test_guard_refuses_syncs_and_host_data(kind):
    with pytest.raises(CF.CaptureError, match="aten::"):
        with HostDataGuard(known=set()):
            _offends(kind)


def test_guard_lets_device_arithmetic_through():
    with HostDataGuard(known=set()):
        x = torch.arange(6, dtype=torch.float32)
        y = (x[:, None] == torch.arange(4)).float().sum(0) + torch.full((), 1e-9)
        torch.sort(x, descending=True, stable=True)
    assert y.shape == (4,)


# ----------------------------------------------------------- the cache ----
class _Counter:
    def __init__(self, name):
        self.__name__, self.launches = name, 0


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif hasattr(dst, "__dataclass_fields__"):
        for k in dst.__dataclass_fields__:
            _copy_into(getattr(dst, k), getattr(src, k))


class StandInGraph:
    """A graph whose replay re-runs the captured function into the captured
    outputs and, like a CUDA graph, runs no Python counter."""

    def __init__(self, backend):
        self.backend, self.generators = backend, []

    def register_generator_state(self, gen):
        self.generators.append(gen)

    def replay(self):
        be = self.backend
        if be.replaying:
            be.overlaps += 1
        be.replaying = True
        try:
            time.sleep(be.delay)
            before = [c.launches for c in be.counters]
            new = self.fn()
            for c, n in zip(be.counters, before):
                c.launches = n
            _copy_into(self.out, new)
        finally:
            be.replaying = False


class StandInGraphs:
    """``CudaGraphs``' methods on the CPU."""

    def __init__(self, counters=(), delay=0.0):
        self.counters, self.delay = counters, delay
        self.replaying, self.overlaps, self.pools = False, 0, 0
        self.fences, self.waits = 0, []

    def pool(self, device):
        self.pools += 1
        return "pool"

    def graph(self):
        return StandInGraph(self)

    def generator(self, device):
        return torch.Generator(device=device)

    def side_stream(self, device):
        return contextlib.nullcontext()

    def capture(self, graph, pool, fn):
        assert pool == "pool"
        graph.fn, graph.out = fn, fn()
        return graph.out

    def reserved(self, device):
        return 0

    def fence(self, device):
        self.fences += 1
        return self.fences

    def wait(self, event, device):
        self.waits.append(event)


FIELDS = ("depth", "confidence", "attention", "curiosity", "fused_features")


def _entry(cache, key):
    """The one graph the cache holds for ``key`` (any inputs' layout)."""
    (entry,) = [e for (k, _), e in cache.graphs.items() if k == key]
    return entry


def _assert_same(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def _eager(eng, inputs, seed):
    exif = {k[5:]: v for k, v in inputs.items() if k.startswith("exif/")}
    return eng._eager(inputs["images"], exif, inputs.get("guidance"),
                      torch.Generator().manual_seed(seed))


def test_replays_equal_the_eager_forward_with_the_same_seed(cfg_path):
    eng = _engine(cfg_path, "int8_2:0.35")
    cache = CF.CompiledForward(eng._compiled_fn, "cpu", sample_noise=True,
                               backend=StandInGraphs())
    key = CF.Signature(True, False, B, S, S)
    outs = []
    for seed, s in ((0, 11), (1, 12), (2, 12)):
        inputs = _inputs(seed, False, True)
        got = cache(key, inputs, seed=s)
        _assert_same(got, _eager(eng, inputs, s))
        outs.append(got)
    assert len(cache.graphs) == 1 and _entry(cache, key).replays == 3
    assert cache.backend.pools == 1
    entry = _entry(cache, key)
    assert len(entry.graph.generators) == 1 and entry.generator is entry.graph.generators[0]
    # the static inputs were refilled, and each call's outputs are its own copies
    assert not torch.equal(outs[0].depth, outs[1].depth)
    assert outs[2].depth.data_ptr() != entry.outputs.depth.data_ptr()


def test_graphs_share_one_pool_and_a_pool_left_empty_is_not_reused():
    """Every graph of a cache captures into one pool; once they are all
    dropped the pool is released (CUDA's allocator refuses to capture into
    it again), so the next capture takes a new one."""
    cache = CF.CompiledForward(lambda inp, gen: {"y": inp["x"] + 1}, "cpu",
                               backend=StandInGraphs())
    for n in (2, 3, 2):
        cache(n, {"x": torch.zeros(n)})
    assert len(cache.graphs) == 2 and cache.backend.pools == 1
    cache.graphs.clear()
    assert torch.equal(cache(2, {"x": torch.zeros(2)})["y"], torch.ones(2))
    assert cache.backend.pools == 2


def test_noise_free_engine_registers_no_generator(cfg_path):
    eng = _engine(cfg_path, "int8_exact", noise="zeros")
    cache = CF.CompiledForward(eng._compiled_fn, "cpu", backend=StandInGraphs())
    inputs = _inputs(0, True, False)
    got = cache(CF.Signature(False, True, B, S, S), inputs)
    entry = next(iter(cache.graphs.values()))
    assert entry.generator is None and entry.graph.generators == []
    _assert_same(got, _eager(eng, inputs, 0))


def test_replays_leave_the_launch_counts_to_the_wrappers():
    """The cache touches no count: the warm-up's launches ran and count, the
    capture's were recorded into the graph and count where the wrapper made
    them, and a replay, which runs no Python, counts nothing."""
    c1, c2 = _Counter("k1"), _Counter("k2")

    def fn(inputs, gen):
        c1.launches += 2
        c2.launches += 1
        return {"y": inputs["x"] * 2}

    cache = CF.CompiledForward(fn, "cpu", backend=StandInGraphs((c1, c2)))
    x = torch.ones(4)
    assert torch.equal(cache("k", {"x": x})["y"], x * 2)  # warm-up, capture, replay
    assert (c1.launches, c2.launches) == (2 + 2, 1 + 1)
    for _ in range(3):
        assert torch.equal(cache("k", {"x": x + 1})["y"], (x + 1) * 2)
    assert (c1.launches, c2.launches) == (4, 2)
    assert not hasattr(_entry(cache, "k"), "tallies")


def test_inputs_of_another_layout_get_their_own_graph(cfg_path):
    """A call without EXIF after one with it (or with EXIF of another dtype)
    is another forward: it never replays the previous request's EXIF, and
    it answers as the eager forward of its own inputs."""
    eng = _engine(cfg_path, "int8_exact", noise="zeros")
    cache = CF.CompiledForward(eng._compiled_fn, "cpu", backend=StandInGraphs())
    key = CF.Signature(True, False, B, S, S)
    with_exif = _inputs(0, False, True)
    no_exif = {k: v for k, v in _inputs(1, False, True).items() if not k.startswith("exif/")}
    inputs = _inputs(2, False, True)
    int64 = {**inputs, "exif/camera_idx": inputs["exif/camera_idx"].long()}
    cache(key, with_exif)
    got = cache(key, no_exif)
    _assert_same(got, eng._eager(no_exif["images"], None, no_exif["guidance"], None))
    _assert_same(cache(key, int64), _eager(eng, inputs, 0))
    assert len(cache.graphs) == 3
    assert [sorted(e["inputs"]) for e in cache.describe()["each"]] == [
        sorted(with_exif), sorted(no_exif), sorted(int64)]
    _assert_same(cache(key, with_exif), _eager(eng, with_exif, 0))


def test_each_call_waits_for_the_previous_copies_out():
    """A call's stream waits for the event the previous call recorded after
    its copies out, so a caller on another stream cannot overwrite the
    graph's inputs or outputs before they are read."""
    cache = CF.CompiledForward(lambda inp, gen: {"y": inp["x"] + 1}, "cpu",
                               backend=StandInGraphs())
    for n in (2, 2, 3, 2):
        cache(n, {"x": torch.zeros(n)})
    assert cache.backend.fences == 4 and cache.backend.waits == [1, 2, 3]


def _spans_in_order(rec, t0, t1):
    spans = [rec[k] for k in ("lock_wait", "copy_in", "launch", "copy_out")]
    assert t0 <= spans[0][0] and spans[-1][1] <= t1
    assert all(a <= b for a, b in spans)
    assert all(b <= c for (_, b), (c, _) in zip(spans, spans[1:]))
    assert spans[1][1] == spans[2][0] and spans[2][1] == spans[3][0]


def test_each_thread_reads_its_own_last_call(cfg_path):
    """``last_call()``: the lock's wait, the copies in, the launch and the
    copies out of this thread's last call, in order on the host's clock,
    its capture flagged; another thread's calls made between a call and its
    read leave that thread's record as it was. The engine hands the cache's
    record on, and its eager forward on the CPU fills the same one."""
    cache = CF.CompiledForward(lambda inp, gen: {"y": inp["x"] + 1}, "cpu",
                               backend=StandInGraphs())
    assert cache.last_call() is None
    called, other_done, seen = threading.Event(), threading.Event(), {}

    def first():
        t0 = time.perf_counter_ns()
        cache(2, {"x": torch.zeros(2)})  # warm-up, capture, replay
        t1 = time.perf_counter_ns()
        called.set()
        other_done.wait(timeout=60)
        seen["first"] = (t0, t1, cache.last_call())

    def second():
        called.wait(timeout=60)
        for _ in range(3):
            cache(2, {"x": torch.ones(2)})
        seen["second"] = cache.last_call()
        other_done.set()

    threads = [threading.Thread(target=first), threading.Thread(target=second)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    t0, t1, rec = seen["first"]
    assert rec["captured"] is True and seen["second"]["captured"] is False
    _spans_in_order(rec, t0, t1)
    assert cache.last_call() is None  # this thread called nothing

    eng = _engine(cfg_path, "int8_exact", noise="zeros")
    inputs = _inputs(0, False, True)
    exif = {k[5:]: v for k, v in inputs.items() if k.startswith("exif/")}
    for compiled in (None, CF.CompiledForward(eng._compiled_fn, "cpu", backend=StandInGraphs())):
        eng.compiled = compiled
        for captured in ((False,) if compiled is None else (True, False)):
            t0 = time.perf_counter_ns()
            eng._forward(inputs["images"], exif, inputs["guidance"])
            rec = eng.last_call()
            _spans_in_order(rec, t0, time.perf_counter_ns())
            assert rec["captured"] is captured
            if compiled is None:  # no lock and no copies out: the eager forward
                assert rec["lock_wait"][1] == rec["lock_wait"][0]
                assert rec["copy_out"][1] == rec["copy_out"][0]
            else:
                assert rec == compiled.last_call()


def test_replays_are_serialised_across_threads(cfg_path):
    """More threads than cores through one cache, the interpreter switching
    threads every microsecond: no two replays overlap, and each thread gets
    the answer of its own inputs and seed."""
    import os
    import sys

    eng = _engine(cfg_path, "int8_exact")
    cache = CF.CompiledForward(eng._compiled_fn, "cpu", sample_noise=True,
                               backend=StandInGraphs(delay=0.002))
    key = CF.Signature(True, False, B, S, S)
    n = (os.cpu_count() or 4) + 2
    inputs = [_inputs(10 + i, False, True) for i in range(n)]
    got = [None] * n

    def worker(i):
        for _ in range(3):
            got[i] = cache(key, inputs[i], seed=100 + i)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert cache.backend.overlaps == 0 and len(cache.graphs) == 1
    assert _entry(cache, key).replays == 3 * n
    for i in range(n):
        _assert_same(got[i], _eager(eng, inputs[i], 100 + i))


def test_a_capture_that_syncs_raises_naming_the_operation():
    def fn(inputs, gen):
        return {"y": inputs["x"] * float(inputs["x"].sum())}

    cache = CF.CompiledForward(fn, "cpu", backend=StandInGraphs())
    with pytest.raises(CF.CaptureError, match=r"forward of .*'k'.* aten::_local_scalar_dense"):
        cache(("k",), {"x": torch.ones(3)})
    assert not cache.graphs and cache.last_call() is None


# ------------------------------------------------------ the engine's route ----
def _image_files(tmp_path, n):
    from PIL import Image

    rng = np.random.RandomState(9)
    paths = []
    for i in range(n):
        p = tmp_path / f"im{i}.png"
        Image.fromarray(rng.randint(0, 256, (40 + 6 * i, 64, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))
    return paths


def test_every_entry_point_runs_one_graph_a_signature(cfg_path, tmp_path):
    """An engine whose cache captures on a stand-in graph against an eager
    engine of the same seed: the same answers (the noise too: both draw the
    same seeds in the same order), and the graphs the JAX engine's jit cache
    would hold."""
    paths = _image_files(tmp_path, 5)
    eager, graphs = (_engine(cfg_path, "int8_2:0.35", seed=4) for _ in range(2))
    graphs.compiled = CF.CompiledForward(graphs._compiled_fn, "cpu", sample_noise=True,
                                         backend=StandInGraphs())
    assert eager.compiled is None  # on the CPU the engine runs eagerly
    for eng in (eager, graphs):
        eng.results = [
            eng.predict(paths[0], "top-left")[:2], eng.predict(paths[1])[:2],
            eng.predict_batch(paths[:2], ["center", None]),
            eng.predict_all_instructions(paths[2]),
            eng.predict_all_instructions_batch(paths[:2]),
            eng.predict_paths_batched(paths, instruction="left", batch_size=4),
            eng.predict_paths_batched(paths, batch_size=4),
            eng.predict_paths_batched(paths, instructions=["right"] * 5, batch_size=4)]
    for a, b in zip(eager.results, graphs.results):
        if isinstance(a, list) and a and isinstance(a[0], tuple) and len(a[0]) == 3:
            a, b = [r[:2] for r in a], [r[:2] for r in b]
        assert a == b
    want = {CF.Signature(True, False, 1, S, S), CF.Signature(False, False, 1, S, S),
            CF.Signature(True, False, 9, S, S), CF.Signature(True, False, 18, S, S),
            CF.Signature(True, True, 4, S, S), CF.Signature(False, True, 4, S, S)}
    assert {k for k, _ in graphs.compiled.graphs} == want
    assert graphs.batch_sizes == eager.batch_sizes


def test_a_new_model_gets_new_graphs(cfg_path):
    eng = _engine(cfg_path, "int8_exact")
    assert eng.compiled is None
    eng.compiled = CF.CompiledForward(eng._compiled_fn, "cpu",
                                      backend=StandInGraphs())
    eng.params = eng.params  # rebuilds the model from the same interchange
    assert eng.compiled is None  # the CPU engine: eager again, nothing stale


def test_a_batch_shard_is_its_own_signature(cfg_path):
    from cognitive_aim_tpu_torch.parallel import comm

    eng = _engine(cfg_path, "int8_exact", noise="zeros")
    eng.compiled = CF.CompiledForward(eng._compiled_fn, "cpu",
                                      backend=StandInGraphs())
    inputs = _inputs(0, False, True)
    exif = {k[5:]: v for k, v in inputs.items() if k.startswith("exif/")}
    eng._forward(inputs["images"], exif, inputs["guidance"])
    with comm.batch_shard(None, 0, B, 2 * B):
        eng._forward(inputs["images"], exif, inputs["guidance"])
    shards = {k.shard for k, _ in eng.compiled.graphs}
    assert shards == {None, comm.BatchShard(0, B, 2 * B)}
