"""The trainer's compiled step (``Trainer.graphs``, core/compiled.py's
``GraphCache``) on the CPU, at tests/test_torch_train.py's tiny width
(2 layers, D 64, image 28, ``STRICT_F32``).

There is no CUDA graph here. The card's tests (tests/test_torch_cuda.py,
marker ``cuda``) replay real graphs against the eager step; these hold what
capture needs and what the cache does to a stand-in graph:

  * **Capture hygiene.** After one warm micro-step, the next runs under
    tests/test_torch_compiled.py's ``HostDataGuard``: no host
    synchronisation, no host data (no tensor made from host values outside
    the dispatcher), through the loss, the backward with its recompute of
    K1 and K6, the MultiSteps mean, the clipped AdamW of every group. Cases:
    plain (per-block recompute on), accumulation 2 (both micro-step kinds),
    ``train_only_lora`` with ``sandwich_heads``, ``freeze_backbone``, guided
    sampling, recompute off, ``alt_model``.
  * **The cache**, through a stand-in graph: a capture records without
    running (the trainer's state is put back after the function ran), a
    replay re-runs the captured function with the registered generators as
    the cache seeded them. N micro-steps through it equal the eager step's
    bit for bit (losses and parameters), and two generator seeds draw
    different dropout masks.
  * ``reset_params`` and ``load_checkpoint`` keep the graphs and load in
    place: the second run from the same weights repeats the first's.
  * The eval forward: one graph a batch shape.
  * The JAX trainer: a run across the warm-up boundary under accumulation 2
    through the stand-in graphs, against the JAX ``Trainer``
    (``test_torch_train.py``'s step tolerance).
"""

import numpy as np
import pytest
import torch

import test_torch_train as TT
from cognitive_aim_tpu.api import flatten_tree
from cognitive_aim_tpu.train.trainer import TrainConfig as JTrainConfig
from cognitive_aim_tpu.train.trainer import Trainer as JTrainer
from cognitive_aim_tpu_torch.convert import flat_params
from cognitive_aim_tpu_torch.core import compiled as CF
from cognitive_aim_tpu_torch.core import precision as TP
from cognitive_aim_tpu_torch.models import config as TCfg
from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel as TModel
from cognitive_aim_tpu_torch.nn.dinov2 import DinoV2Config as TVit
from cognitive_aim_tpu_torch.train import losses as TLS
from cognitive_aim_tpu_torch.train.trainer import TrainConfig, Trainer
from test_torch_compiled import HostDataGuard, StandInGraphs

BASE = dict(TT.BASE, guided_training=False)
# name: (TrainConfig overrides, arch overrides, CAIM_TRAIN_REMAT, alt_model);
# "plain" recomputes each block in the backward, "remat_0" keeps them
CASES = {
    "plain": ({}, {}, "1", False),
    "accumulation_2": (dict(accumulation_steps=2), {}, "1", False),
    "lora_sandwich": (dict(train_only_lora=True, sandwich_heads=True, heads_lr=1e-3),
                      TT.LORA, "1", False),
    "freeze_backbone": (dict(freeze_backbone=True), TT.LORA, "1", False),
    "guided": (dict(guided_training=True), {}, "1", False),
    "remat_0": ({}, {}, "0", False),
    "alt_model": ({}, TT.FILTER, "1", True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(arch_kw, seed=0):
    arch = TCfg.ModelArchConfig(**{**TT.ARCH, **arch_kw})
    m = TModel(arch, policy=TP.STRICT_F32, vit_cfg=TVit(**TT.VIT), device="cpu",
               attn_impl="pallas_packed")
    m.init(torch.Generator().manual_seed(seed))
    with torch.no_grad():  # lora_B's init (0) would leave lora_A's gradient 0
        for name, p in m.named_parameters():
            if "lora" in name and name.endswith("B"):
                p.normal_(0.0, 0.02, generator=torch.Generator().manual_seed(seed + 1))
    return m


def _trainer(case, tmp_path, graphs=False, seed=0, name="t"):
    over, arch_kw, _, alt = CASES[case]
    model = _model(arch_kw, seed)
    alt_model = None
    if alt:  # the filter off on the same parameters
        alt_arch = {k: v for k, v in {**TT.ARCH, **arch_kw}.items()
                    if not k.startswith("token_filter")}
        alt_model = TModel(TCfg.ModelArchConfig(**alt_arch), policy=TP.STRICT_F32,
                           vit_cfg=TVit(**TT.VIT), device="cpu", attn_impl="pallas_packed")
    tr = Trainer(model, TrainConfig(**{**BASE, **over}), output_dir=str(tmp_path / name),
                 alt_model=alt_model)
    if graphs:
        tr.graphs = CF.GraphCache("cpu", backend=StepStandIn(lambda: _state(tr)))
    return tr


def _state(tr):
    """Every tensor a step writes: parameters, moments, counts, the mean."""
    out = [p for p in tr.model.parameters()]
    for g in tr._groups.values():
        out += [*g.mu, *g.nu, g.count]
    return out + list(tr._acc or [])


class StepStandIn(StandInGraphs):
    """``CudaGraphs`` on the CPU for a stateful function: the capture runs
    the function for its outputs and puts back every tensor of ``state()``
    (a CUDA graph's capture records and runs nothing); a replay re-runs it
    (tests/test_torch_compiled.py's ``StandInGraph``)."""

    def __init__(self, state):
        super().__init__()
        self.state = state

    def capture(self, graph, pool, fn):
        held = [t.detach().clone() for t in self.state()]
        graph.fn, graph.out = fn, fn()
        with torch.no_grad():
            for t, h in zip(self.state(), held):
                t.copy_(h)
        return graph.out


def _flat(model):
    """The flat parameters, copied (on the CPU flat_params views some)."""
    return {k: v.copy() for k, v in flat_params(model).items()}


def _seeded(i):
    return torch.Generator().manual_seed(100 + i)


@pytest.fixture
def remat(monkeypatch):
    def set_(value):
        monkeypatch.setenv("CAIM_TRAIN_REMAT", value)
    return set_


# ------------------------------------------------------- capture hygiene ----
@pytest.mark.parametrize("case", list(CASES))
def test_warm_step_neither_syncs_nor_reads_host_data(case, remat, tmp_path):
    remat(CASES[case][2])
    tr = _trainer(case, tmp_path)
    batch = TT.synth_batch()
    kinds = [False, True] if tr.cfg.accumulation_steps > 1 else [True]
    models = [tr.model] + ([tr.alt_model] if tr.alt_model is not None else [])
    for model in models:
        for update in kinds:
            inputs = tr._step_inputs(batch, update)
            seeds = tr._streams(batch, _seeded(0))

            def gens():
                return {s: torch.Generator().manual_seed(v) for s, v in seeds.items()}

            with torch.enable_grad(), HostDataGuard(record=True) as warm:
                tr._step_body(model, inputs, gens(), update)
            ts = [*_state(tr), *model.buffers(), *inputs.values()]
            known = warm.seen | {t.untyped_storage().data_ptr() for t in ts if t.numel()}
            with torch.enable_grad(), HostDataGuard(known=known):
                logs = tr._step_body(model, inputs, gens(), update)
            assert set(logs) == {"loss", "depth_loss", "curiosity_loss"}
            assert all(v.ndim == 0 and torch.isfinite(v) for v in logs.values())


def test_a_step_that_syncs_raises_naming_the_operation(monkeypatch, tmp_path):
    """A capture that breaks raises and leaves no graph; nothing carries on
    eagerly."""
    tr = _trainer("plain", tmp_path, graphs=True)
    loss = TLS.scale_invariant_loss

    def syncing(pred, target, lam):
        out = loss(pred, target, lam)
        return out * float(out.detach())

    monkeypatch.setattr(TLS, "scale_invariant_loss", syncing)
    with pytest.raises(CF.CaptureError, match=r"training step .* aten::_local_scalar_dense"):
        tr.train_step(TT.synth_batch(), _seeded(0))
    assert not tr.graphs.graphs


# -------------------------------------------------------------- the cache ----
@pytest.mark.parametrize("case", ["plain", "accumulation_2", "guided", "remat_0", "alt_model",
                                  "lora_sandwich"])
def test_replayed_steps_are_the_eager_steps(case, remat, tmp_path):
    """Six micro-steps with a generator each (dropout and noise on), through
    the stand-in graphs and eagerly, from the same weights: each step's
    logs and the parameters after bit for bit; one graph a micro-step kind,
    each captured at its first call and replayed after."""
    remat(CASES[case][2])
    a = _trainer(case, tmp_path, graphs=True, name="a")
    b = _trainer(case, tmp_path, name="b")
    batches = [TT.synth_batch(seed=i % 3) for i in range(6)]
    for i, batch in enumerate(batches):
        got = a.train_step(batch, _seeded(i), fetch_logs=False)
        want = b.train_step(batch, _seeded(i), fetch_logs=False)
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
    pa, pb = _flat(a.model), _flat(b.model)
    for k in pb:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
    kinds = (1 + (a.cfg.accumulation_steps > 1)) * (1 + (a.alt_model is not None))
    assert len(a.graphs.graphs) == kinds
    assert sum(e.replays for e in a.graphs.graphs.values()) == 6 - kinds
    n_streams = 4 + (case == "guided")
    assert all(len(e.graph.generators) == n_streams for e in a.graphs.graphs.values())
    assert b.graphs is None  # the CPU trainer runs eagerly
    assert int(a._groups["train"].count) == a._groups["train"].updates == \
        6 // max(1, a.cfg.accumulation_steps)


def test_two_seeds_draw_different_masks_and_one_seed_the_same(tmp_path):
    """Replays from one state under two generator seeds: different losses
    and parameters (the dropout masks and noise differ); under one seed
    twice: the same bits."""
    tr = _trainer("plain", tmp_path, graphs=True)
    batch = TT.synth_batch()
    tr.train_step(batch, _seeded(0))  # captures
    start = _flat(tr.model)
    runs = {}
    for tag, seed in (("a", 1), ("b", 2), ("a2", 1)):
        tr.reset_params(start)
        runs[tag] = (tr.train_step(batch, _seeded(seed), fetch_logs=False)["loss"],
                     _flat(tr.model)["fusion/fc0/w"])
    assert len(tr.graphs.graphs) == 1
    assert torch.equal(runs["a"][0], runs["a2"][0])
    np.testing.assert_array_equal(runs["a"][1], runs["a2"][1])
    assert not torch.equal(runs["a"][0], runs["b"][0])
    assert np.abs(runs["a"][1] - runs["b"][1]).max() > 0


@pytest.mark.parametrize("tensor_parallel", [False, True], ids=["no_tp", "tp_world1"])
@pytest.mark.parametrize("how", ["reset_params", "load_checkpoint"])
def test_reloads_keep_the_graphs_and_their_results(how, tensor_parallel, tmp_path):
    """Four micro-steps (accumulation 2) through the graphs, a reload of the
    starting weights, the same four again: the same graphs, replayed only,
    the same bits; every parameter and optimizer buffer kept its storage
    (a tensor-parallel mesh reshards through new tensors, copied back)."""
    tr = _trainer("accumulation_2", tmp_path, graphs=True)
    tr.cfg.tensor_parallel = tensor_parallel
    tr._place()
    tr._reset_optimizer()
    tr.save_checkpoint(False, "start.npz")
    start = _flat(tr.model)
    ptrs = [t.data_ptr() for t in _state(tr)]
    batches = [TT.synth_batch(seed=i) for i in range(4)]

    def run():
        return [tr.train_step(b, _seeded(i))["loss"] for i, b in enumerate(batches)]

    first = run()
    after = _flat(tr.model)
    entries = dict(tr.graphs.graphs)
    if how == "reset_params":
        tr.reset_params(start)
    else:
        tr.load_checkpoint(str(tmp_path / "t" / "start.npz"))
        assert tr.epoch == 1
        tr.epoch = 0  # the epoch after the checkpoint's: the first run's KL weight again
    assert [t.data_ptr() for t in _state(tr)] == ptrs
    assert int(tr._groups["train"].count) == 0 and tr._mini_step == 0
    assert not any(bool(t.abs().max() > 0) for t in tr._acc)
    assert run() == first
    assert len(tr.graphs.graphs) == len(entries)
    assert all(tr.graphs.graphs[k] is e and e.replays == 3 for k, e in entries.items())
    for k, v in _flat(tr.model).items():
        np.testing.assert_array_equal(v, after[k], err_msg=k)


def test_eval_forward_is_one_graph_a_batch_shape(tmp_path):
    tr = _trainer("plain", tmp_path, graphs=True)
    rng = np.random.RandomState(5)
    for B in (4, 4, 3, 4):  # a last partial batch gets its own graph
        x = torch.from_numpy(rng.randn(B, 28, 28, 3).astype(np.float32))
        exif = {k: torch.from_numpy(v[:B]) for k, v in TT.synth_batch()["exif"].items()}
        got = tr.eval_forward(x, exif)
        want = tr.eval_forward(x, exif, eager=True)
        for f in ("depth", "confidence", "attention", "curiosity"):
            assert torch.equal(getattr(got, f), getattr(want, f)), (B, f)
    assert sorted(e.replays for e in tr.graphs.graphs.values()) == [1, 3]


# ------------------------------------------------------- the JAX trainer ----
def test_warmup_boundary_under_accumulation_matches_jax_trainer(tmp_path):
    """warmup_cosine with one warm-up update (lr 0 at update 0, the peak at
    update 1) under accumulation 2: four micro-steps through the stand-in
    graphs against the JAX Trainer's jitted steps; nothing moves at the
    first micro-step, the tolerance is test_torch_train.py's."""
    kw = dict(TT.BASE, scheduler="warmup_cosine", warmup_epochs=1, steps_per_epoch=2,
              epochs=3, accumulation_steps=2)
    jm, params, tm = TT.tiny_pair()
    # one batch: update 0 (lr 0) leaves the weights, so update 1 averages
    # the first micro-step's gradient again, which picks the elements held
    # to the tight tolerance
    batches = [TT.synth_batch()] * 4
    _, jgrad = TT._jax_loss_and_grads(jm, params, batches[0], JTrainConfig(**kw), 0.05)
    jt = JTrainer(jm, params, JTrainConfig(**kw), output_dir=str(tmp_path / "j"))
    tt = Trainer(tm, TrainConfig(**kw), output_dir=str(tmp_path / "t"))
    tt.graphs = CF.GraphCache("cpu", backend=StepStandIn(lambda: _state(tt)))
    before = _flat(tm)
    for i, batch in enumerate(batches):
        lj = jt.train_step(batch, None)
        lt = tt.train_step(batch, None)
        np.testing.assert_allclose(lt["loss"], lj["loss"], **TT.GRAD_TOL)
        if i == 0:
            for k, v in _flat(tm).items():
                np.testing.assert_array_equal(v, before[k])
    assert len(tt.graphs.graphs) == 2 and tt._groups["train"].updates == 2
    TT._assert_step_equal(flatten_tree(jt.params), _flat(tm), jgrad,
                          2.0 * 2 * kw["learning_rate"])
