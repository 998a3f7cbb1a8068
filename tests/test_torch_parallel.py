"""The port's parallel layer (core/mesh.py, parallel/, the trainer's mesh, the
engine's data-parallel path, utils/profiling.py) against the JAX package's,
restating tests/test_utils_and_mesh.py and ``__graft_entry__.dryrun_multichip``.

Multi-rank cases run in spawned gloo ranks on the CPU (tests/
torch_parallel_ranks.py), one spawn per world shape: world 4 for the meshes,
the TP 2 x DP 2 step and the pipeline, world 2 for the engine, the DCP
checkpoints and the token filter at TP 2. Each spawn writes its findings to
a job directory, and the tests here hold them against the port's world-1 run
(no process group) and against the JAX package on the 8 virtual devices of
tests/conftest.py.

Weights come from the JAX init, carried across with
``convert.load_flat_params``; batches from a numpy seed; no generator on
either side (dropout off, noise 0), as in tests/test_torch_train.py. Both
sides run float32 (``STRICT_F32``). Tolerances, with their reasons:

  * train steps: loss within 1e-4 relative; parameters within atol 1e-4,
    rtol 2e-3 (the JAX package's own bounds, test_utils_and_mesh.py). Adam's
    first step is sign-like, so the gradients are checked too: the whole
    gradients of a TP 2 x DP 2 (or pipelined) micro-step against world 1's
    within atol 1e-5 (float32 sums in another order; a collective with the
    wrong backward is off by a factor of 2 or more);
  * pipelined backbone against the sequential forward: atol 2e-5, rtol 2e-4;
    the whole model: depth and confidence 1e-5 / 1e-4, attention atol 1e-3
    (the temperature-0.05 softmax magnifies the backbone's rounding);
    gradients through the schedule: atol 5e-5, rtol 2e-4 (JAX's bounds);
  * the data-parallel engine: a rank runs 2 of 4 rows, and a matmul of
    another height may round otherwise: within 1e-5 relative of
    ``mesh=None``;
  * DCP: bit for bit;
  * the token filter on tensor-parallel blocks (TP 2, world 2, ``2:0.35`` and
    ``2:0.35@p``): identical kept indices on both ranks and against world 1,
    outputs within 1e-5 of world 1's, the whole gradients of a probe of the
    output within 1e-5 of each parameter's largest (float32 sums in another
    order, at the scale of gradients up to ~20); world 1 against the JAX
    backbone in strict float32 as tests/test_torch_filter.py holds it
    (identical indices, every keep boundary wider than 1e-5, outputs atol
    2e-5 / rtol 1e-4).
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_ranks as R
from cognitive_aim_tpu.api import flatten_tree
from cognitive_aim_tpu.core.mesh import make_mesh as jmake_mesh
from cognitive_aim_tpu.core.precision import STRICT_F32 as J_F32
from cognitive_aim_tpu.models.cognitive_aim import CognitiveAimModel as JModel
from cognitive_aim_tpu.models.config import ModelArchConfig as JArch
from cognitive_aim_tpu.nn import dinov2 as jdinov2
from cognitive_aim_tpu.parallel.pipeline import make_pipeline_mesh as jpipe_mesh
from cognitive_aim_tpu.parallel.sharding import _TP_RULES as J_TP_RULES
from cognitive_aim_tpu.train.trainer import TrainConfig as JTrainConfig
from cognitive_aim_tpu.train.trainer import Trainer as JTrainer
from cognitive_aim_tpu_torch.convert import flat_params
from cognitive_aim_tpu_torch.core import mesh as M
from cognitive_aim_tpu_torch.parallel import pipeline as PL
from cognitive_aim_tpu_torch.parallel import sharding as SH
from cognitive_aim_tpu_torch.train.trainer import TrainConfig, Trainer
from cognitive_aim_tpu_torch.utils.profiling import StepTimer, chain_throughput

# the tiny flagship of __graft_entry__._flagship(image_size=28, tiny=True)
TP = dict(arch=dict(num_iterations=2, image_size=28, freeze_backbone=False, use_lora=True),
          vit=dict(hidden_size=64, num_layers=2, num_heads=4, patch_size=14,
                   pretrain_image_size=28, use_lora=True, lora_rank=4),
          train=dict(epochs=1, steps_per_epoch=2, freeze_backbone=True, tensor_parallel=True,
                     accumulation_steps=1, batch_size=8))
# test_pipelined_backbone_matches_sequential / test_full_model_pipelined_matches_sequential
PP = dict(arch=dict(num_iterations=2, image_size=56),
          vit=dict(hidden_size=64, num_layers=4, num_heads=4, patch_size=14,
                   pretrain_image_size=56))
# test_pipelined_train_step_matches_sequential
PP_TRAIN = dict(arch=dict(num_iterations=2, image_size=56, freeze_backbone=False,
                          use_lora=False),
                vit=PP["vit"],
                train=dict(epochs=1, batch_size=8, steps_per_epoch=2, freeze_backbone=False))
# the token filter on tensor-parallel blocks: 4 heads of 64 (2 a rank at TP 2),
# a 112x112 image (64 patches, 2:0.35 keeps 22); guided keep weights
TP_FILTER = dict(vit=dict(hidden_size=256, num_layers=4, num_heads=4, patch_size=14,
                          pretrain_image_size=56, gelu_approx=False),
                 specs=["2:0.35", "2:0.35@p"], image=112, seed=15)
STEP_TOL = dict(atol=1e-4, rtol=2e-3)
GRAD_TOL = dict(atol=1e-5, rtol=0.0)
FILTER = "1:0.6,2:0.3@f4"  # dryrun_multichip's serving filter


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_init(arch, vit, seed=0):
    jm = JModel(JArch(**arch), policy=J_F32, vit_cfg=jdinov2.DinoV2Config(**vit))
    params = jm.init(jax.random.PRNGKey(seed))
    return jm, params, {k: np.asarray(v) for k, v in flatten_tree(params).items()}


def _batch(B, size, seed=0, maps=True):
    rng = np.random.RandomState(seed)
    depths = np.abs(rng.randn(B, size, size) if maps else rng.randn(B)).astype(np.float32)
    return {"images": rng.randn(B, size, size, 3).astype(np.float32) * 0.5,
            "depths": depths + (0.1 if maps else 0.5),
            "exif": {"camera_idx": np.zeros(B, np.int32),
                     "focal_length": np.full(B, 0.25, np.float32),
                     "aperture": np.full(B, 0.127, np.float32),
                     "iso": np.full(B, 0.016, np.float32)}}


def _flat_batch(batch):
    return {"images": batch["images"], "depths": batch["depths"],
            **{f"exif/{k}": v for k, v in batch["exif"].items()}}


def _read(job, world):
    out = [json.load(open(os.path.join(job, f"rank{r}.json"))) for r in range(world)]
    with np.load(os.path.join(job, "rank0.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    return out, arrays


def _world1_grads(model, cfg_kw, batch, tmp, generator=None):
    tr = Trainer(model, TrainConfig(**cfg_kw), output_dir=str(tmp))
    total, _ = tr.loss(tr.model, tr.device_batch(batch), generator, *tr.step_inputs())
    params = [p for _, p in tr._trainable]
    got = torch.autograd.grad(total, params, allow_unused=True)
    return float(total.detach()), {n: (torch.zeros_like(p) if g is None else g).numpy()
                                   for (n, p), g in zip(tr._trainable, got)}


def _world1_step(model, cfg_kw, batch, tmp):
    tr = Trainer(model, TrainConfig(**cfg_kw), output_dir=str(tmp))
    loss = tr.train_step(batch, None)["loss"]
    return loss, flat_params(tr.model)


# ---------------------------------------------------------------- world 4 ----
@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """One spawn of 4 ranks; the JAX and world-1 references computed here."""
    job = str(tmp_path_factory.mktemp("world4"))
    ref = {}
    jm, jp, flat = _jax_init(TP["arch"], TP["vit"])
    batch = _batch(8, 28)
    np.savez(os.path.join(job, "tp_inputs.npz"), **{f"p/{k}": v for k, v in flat.items()},
             **{f"b/{k}": v for k, v in _flat_batch(batch).items()})
    _, _, pflat = _jax_init(PP["arch"], PP["vit"])
    rng = np.random.RandomState(1)
    images = (rng.randn(4, 56, 56, 3) * 0.5).astype(np.float32)
    gidx = np.asarray([0, 3, 5, 8], np.int32)
    exif = {"camera_idx": np.zeros(4, np.int32), "focal_length": np.full(4, 50.0, np.float32),
            "aperture": np.full(4, 2.8, np.float32), "iso": np.full(4, 100.0, np.float32)}
    np.savez(os.path.join(job, "pp_inputs.npz"), **{f"p/{k}": v for k, v in pflat.items()},
             images=images, gidx=gidx, **{f"exif/{k}": v for k, v in exif.items()})
    _, _, tflat = _jax_init(PP_TRAIN["arch"], PP_TRAIN["vit"])
    tbatch = _batch(8, 56, maps=False)
    np.savez(os.path.join(job, "pp_train_inputs.npz"),
             **{f"p/{k}": v for k, v in tflat.items()},
             **{f"b/{k}": v for k, v in _flat_batch(tbatch).items()})
    with open(os.path.join(job, "spec.json"), "w") as f:
        json.dump({"tp": TP, "pp": PP, "pp_train": PP_TRAIN}, f)
    R.spawn("world4", 4, job, env={"LOCAL_WORLD_SIZE": "2"})

    # JAX: the TP 2 x DP 2 step on 4 virtual devices
    jt = JTrainer(jm, jp, JTrainConfig(**TP["train"]),
                  mesh=jmake_mesh(jax.devices()[:4], model_parallel=2),
                  output_dir=str(tmp_path_factory.mktemp("jtp")))
    ref["jax_tp_loss"] = jt.train_step(batch, None)["loss"]
    ref["jax_tp"] = {k: np.asarray(v) for k, v in flatten_tree(jt.params).items()}
    # the port at world 1, no process group
    tmp = tmp_path_factory.mktemp("w1")
    ref["w1_tp_loss"], ref["w1_tp"] = _world1_step(
        R.tiny_model(flat, TP["arch"], TP["vit"]), TP["train"], batch, tmp)
    _, ref["w1_tp_grad"] = _world1_grads(R.tiny_model(flat, TP["arch"], TP["vit"]),
                                         dict(TP["train"], freeze_backbone=False), batch, tmp)
    _, ref["w1_pp_grad"] = _world1_grads(
        R.tiny_model(tflat, PP_TRAIN["arch"], PP_TRAIN["vit"]), PP_TRAIN["train"], tbatch, tmp)
    ref["w1_drawn_loss"], ref["w1_drawn_grad"] = _world1_grads(
        R.tiny_model(tflat, PP_TRAIN["arch"], PP_TRAIN["vit"]),
        dict(PP_TRAIN["train"], guided_training=True), tbatch, tmp,
        torch.Generator().manual_seed(7))
    # JAX's pipelined backbone and model on converted weights
    jpm, jpp, _ = _jax_init(PP["arch"], PP["vit"])
    jvit = jdinov2.DinoV2Config(**PP["vit"])
    for stages in (4, 2):
        mesh = jpipe_mesh(stages, jax.devices()[:4])
        ref[f"jax_pp{stages}_backbone"] = np.asarray(jax.jit(
            lambda p, c: jdinov2.apply_pipelined(p, c, jvit, mesh, n_micro=2)
        )(jpp["backbone"], jnp.asarray(images)))
        o = jax.jit(lambda p, x, e, g: jpm.apply(p, x, e, guidance=g, pipeline_mesh=mesh,
                                                 pipeline_n_micro=2)
                    )(jpp, jnp.asarray(images), {k: jnp.asarray(v) for k, v in exif.items()},
                      jnp.asarray(gidx))
        ref[f"jax_pp{stages}"] = {f: np.asarray(getattr(o, f))
                                  for f in ("depth", "confidence", "attention")}
    # the port's sequential forward
    tm = R.tiny_model(pflat, PP["arch"], PP["vit"])
    x = torch.from_numpy(images)
    with torch.no_grad():
        ref["seq_backbone"] = tm.backbone(x, attn_impl="pallas_packed").numpy()
        o = tm(x, {k: torch.from_numpy(v) for k, v in exif.items()},
               guidance=torch.from_numpy(gidx).long())
    ref["seq"] = {f: getattr(o, f).numpy() for f in ("depth", "confidence", "attention")}
    out, arrays = _read(job, 4)
    return out, arrays, ref


def test_mesh_shapes_world_4(world4):
    out, _, _ = world4
    for r, o in enumerate(out):
        m = o["mesh"]
        assert m["shape"] == {"data": 2, "model": 2}
        assert m["index"] == {"data": r // 2, "model": r % 2}
        assert m["pad11"] == 12
        assert m["rows"] == [4 * (r // 2), 4 * (r // 2) + 4]


def test_multihost_mesh_and_batch_sharding(world4):
    """(replica 2, data 2, model 1): replicas from LOCAL_WORLD_SIZE, the batch
    over replica x data jointly, replica-major; padding counts both."""
    out, _, _ = world4
    rows = np.arange(24, dtype=np.float32).reshape(8, 3)
    for r, o in enumerate(out):
        m = o["mesh"]
        assert m["multihost_shape"] == {"replica": 2, "data": 2, "model": 1}
        assert m["multihost_axes"] == ["replica", "data"]
        assert m["multihost_pad5"] == 8
        assert m["multihost_rows"] == [2 * r, 2 * r + 2]
        np.testing.assert_array_equal(m["multihost_local"], rows[2 * r:2 * r + 2])
        np.testing.assert_array_equal(m["multihost_gathered"], rows)
        assert m["multihost_raised"]


def test_tp_dp_train_step_matches_world_1_and_jax(world4):
    """One step of the tiny flagship (LoRA rank 4, freeze_backbone,
    tensor_parallel) at (data 2, model 2) against the port at world 1 and
    the JAX Trainer on make_mesh(devices[:4], model_parallel=2)."""
    out, arrays, ref = world4
    for o in out:
        np.testing.assert_allclose(o["tp_loss"], ref["w1_tp_loss"], rtol=1e-4)
        np.testing.assert_allclose(o["tp_loss"], ref["jax_tp_loss"], rtol=1e-4)
    assert len({o["tp_digest"] for o in out}) == 1  # every rank holds the same weights
    got = {k[len("tp/"):]: v for k, v in arrays.items() if k.startswith("tp/")}
    assert set(got) == set(ref["jax_tp"]) == set(ref["w1_tp"])
    for k in got:
        np.testing.assert_allclose(got[k], ref["w1_tp"][k], err_msg=k, **STEP_TOL)
        np.testing.assert_allclose(got[k], ref["jax_tp"][k], err_msg=k, **STEP_TOL)
    assert np.abs(got["backbone/layers/lora_B"] - ref["jax_tp"]["backbone/layers/lora_B"]
                  ).max() < 1e-6


def test_tp_dp_gradients_match_world_1(world4):
    """Every parameter trainable: the split projections' gathered gradients,
    the replicated ones' and the heads', summed over data, against world 1."""
    out, arrays, ref = world4
    got = {k[len("tp_grad/"):]: v for k, v in arrays.items() if k.startswith("tp_grad/")}
    want = ref["w1_tp_grad"]
    assert set(got) == set(want)
    assert {"backbone.layers.0.qkv.weight", "backbone.layers.1.fc2.weight",
            "backbone.layers.0.lora_A"} <= set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GRAD_TOL)
    assert np.abs(want["backbone.layers.0.qkv.weight"]).max() > 1e-3


def test_tp_rules_match_jax():
    """JAX's column rules on [L, in, out] become dim 0 of the port's [out, in]
    weights, its row rules dim 1; q, k and v become the head split of each
    third of the fused qkv."""
    axis = J_TP_RULES[("layers", "q", "w")][2]
    want = {}
    for (_, name, leaf), spec in J_TP_RULES.items():
        dims = [i for i, a in enumerate(tuple(spec)[1:]) if a == axis]
        port_dim = {"w": {1: 0, 0: 1}[dims[0]], "b": 0}[leaf]
        key = ("qkv" if name in "qkv" else name, {"w": "weight", "b": "bias"}[leaf])
        want[key] = (port_dim, 3 if name in "qkv" else 1)
    got = {k[1:]: (s.dim, s.parts) for k, s in SH._TP_RULES.items()}
    assert got == want
    _, _, flat = _jax_init(TP["arch"], TP["vit"])
    model = R.tiny_model(flat, TP["arch"], TP["vit"])
    mesh = M.make_mesh(device="cpu")
    specs = SH.param_shardings(mesh, model, tensor_parallel=True)
    assert specs["backbone.layers.1.qkv.weight"] == SH.Spec(0, ("model",), 3)
    assert specs["backbone.layers.0.fc2.weight"] == SH.Spec(1, ("model",))
    for name in ("backbone.layers.0.norm1.weight", "backbone.layers.0.lora_A",
                 "backbone.layers.0.attn_out.bias", "backbone.layers.0.ls1",
                 "backbone.pos_embed", "fusion.fc0.weight"):
        assert specs[name] == SH.REPLICATED, name
    assert all(s == SH.REPLICATED for s in SH.param_shardings(mesh, model).values())


def test_qkv_head_split_layout():
    """A rank of tp holds heads [r H / tp, (r + 1) H / tp) of q, of k and of v
    (rows of each third), and ``whole`` puts the pieces back."""

    class FakeMesh:
        shape = {"data": 1, "model": 2}

        def __init__(self, r):
            self.index = {"data": 0, "model": r}

        def group(self, axis):
            return None

    D, hd = 8, 2
    w = torch.arange(3 * D * 3, dtype=torch.float32).reshape(3 * D, 3)
    spec = SH.Spec(0, ("model",), 3)
    pieces = [SH.local_piece(FakeMesh(r), w, spec) for r in range(2)]
    for r, p in enumerate(pieces):
        assert p.shape == (3 * D // 2, 3)
        for third in range(3):
            rows = w[third * D + r * D // 2: third * D + (r + 1) * D // 2]
            torch.testing.assert_close(p[third * D // 2:(third + 1) * D // 2], rows)
    # the rank's heads are whole heads of hd rows
    assert (D // 2) % hd == 0
    stacked = torch.cat([p.view(3, D // 2, 3) for p in pieces], dim=1).reshape(3 * D, 3)
    torch.testing.assert_close(stacked, w)


def test_pipelined_backbone_matches_sequential_and_jax(world4):
    out, arrays, ref = world4
    assert out[0]["pp4_mesh"] == {"data": 1, "pipe": 4}
    assert out[0]["pp2_mesh"] == {"data": 2, "pipe": 2}
    for stages in (4, 2):
        got = arrays[f"pp{stages}/backbone"]
        np.testing.assert_allclose(got, ref["seq_backbone"], atol=2e-5, rtol=2e-4)
        np.testing.assert_allclose(got, ref[f"jax_pp{stages}_backbone"], atol=2e-5, rtol=2e-4)


def test_full_model_pipelined_matches_sequential_and_jax(world4):
    _, arrays, ref = world4
    for stages in (4, 2):
        for want in (ref["seq"], ref[f"jax_pp{stages}"]):
            for f in ("depth", "confidence"):
                np.testing.assert_allclose(arrays[f"pp{stages}/{f}"], want[f],
                                           atol=1e-5, rtol=1e-4)
            np.testing.assert_allclose(arrays[f"pp{stages}/attention"], want["attention"],
                                       atol=1e-3)


def test_pipelined_model_exclusions():
    """Token filter and int8 backbone do not compose with the pipeline."""
    mesh = PL.make_pipeline_mesh(1, device="cpu")
    x = torch.zeros(2, 56, 56, 3)
    _, _, flat = _jax_init(PP["arch"], PP["vit"])
    filtered = R.tiny_model(flat, dict(PP["arch"], token_filter_layer=2, token_filter_keep=0.5),
                            PP["vit"])
    with pytest.raises(ValueError, match="mutually exclusive"):
        filtered(x, pipeline_mesh=mesh)
    int8 = R.tiny_model(flat, PP["arch"], PP["vit"], policy="int8")
    int8.prepare_params()
    with torch.no_grad(), pytest.raises(ValueError, match="unquantized backbone"):
        int8(x, pipeline_mesh=mesh)


@pytest.mark.parametrize("remat", [False, True])
def test_pipelined_scan_grad_matches_sequential(world4, remat):
    """Gradients through the GPipe schedule (the reversed schedule's sends
    and receives) at (data 1, pipe 4), L 8, with and without remat."""
    out, _, _ = world4
    for o in out:
        assert o["grad_excess"][str(remat)] <= 5e-5
        assert o[f"grad_forward_err_{remat}"] <= 2e-5


def test_pipelined_train_step_matches_dp_step(world4):
    """TrainConfig.pipeline_stages=2 at (data 2, pipe 2) against the
    data-parallel step at (data 4, model 1): same loss, gradients and
    parameters; both against the port at world 1's gradients."""
    out, arrays, ref = world4
    for o in out:
        np.testing.assert_allclose(o["pp_train_loss"], o["dp_train_loss"], rtol=1e-4)
    for name in ("dp", "pp"):  # the replicas stay in step on every rank and stage
        assert len({o[f"{name}_digest"] for o in out}) == 1, name
    dp = {k[len("dp_train/"):]: v for k, v in arrays.items() if k.startswith("dp_train/")}
    pp = {k[len("pp_train/"):]: v for k, v in arrays.items() if k.startswith("pp_train/")}
    assert set(dp) == set(pp)
    for k in dp:
        np.testing.assert_allclose(pp[k], dp[k], err_msg=k, **STEP_TOL)
    for name in ("dp", "pp"):
        got = {k[len(name) + 6:]: v for k, v in arrays.items() if k.startswith(f"{name}_grad/")}
        assert set(got) == set(ref["w1_pp_grad"])
        for k, want in ref["w1_pp_grad"].items():
            np.testing.assert_allclose(got[k], want, err_msg=f"{name} {k}", **GRAD_TOL)


def test_dp_draws_do_not_depend_on_the_world_size(world4):
    """Dropout masks, the VAE and focal noise and guided_training's drawn
    instructions, from one generator: at (data 4, model 1) each rank draws
    the global batch's values for its rows, so the loss and the summed
    gradients are world 1's."""
    out, arrays, ref = world4
    for o in out:
        np.testing.assert_allclose(o["drawn_loss"], ref["w1_drawn_loss"], rtol=1e-5)
    got = {k[len("drawn_grad/"):]: v for k, v in arrays.items() if k.startswith("drawn_grad/")}
    assert set(got) == set(ref["w1_drawn_grad"])
    for k, want in ref["w1_drawn_grad"].items():
        np.testing.assert_allclose(got[k], want, err_msg=k, **GRAD_TOL)


def test_trainer_parallel_errors(tmp_path):
    _, _, flat = _jax_init(PP_TRAIN["arch"], PP_TRAIN["vit"])
    model = R.tiny_model(flat, PP_TRAIN["arch"], PP_TRAIN["vit"])
    with pytest.raises(ValueError, match="mutually exclusive"):
        Trainer(model, TrainConfig(pipeline_stages=4, tensor_parallel=True),
                output_dir=str(tmp_path))
    with pytest.raises(ValueError, match="'pipe' axis"):
        Trainer(model, TrainConfig(pipeline_stages=2), output_dir=str(tmp_path),
                mesh=M.make_mesh(device="cpu"))


def test_pipelined_scan_rejects_bad_shapes(world4):
    out, _, _ = world4
    for o in out:
        assert o["raised"] == {"layers": True, "micro": True, "stages": True}
    with pytest.raises(ValueError):
        PL.make_pipeline_mesh(2, device="cpu")  # 2 stages do not divide world 1


# ---------------------------------------------------------------- world 2 ----
@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The engine at mesh=None and two DCP saves here; one spawn of 2 ranks."""
    from PIL import Image

    from cognitive_aim_tpu_torch.api import CognitiveAimInference
    from cognitive_aim_tpu_torch.nn.dinov2 import DinoV2Config

    job = str(tmp_path_factory.mktemp("world2"))
    rng = np.random.RandomState(4)
    paths = []
    for i in range(6):
        p = os.path.join(job, f"im{i}.png")
        Image.fromarray(rng.randint(0, 256, (60 + 4 * i, 70, 3), dtype=np.uint8)).save(p)
        paths.append(p)
    paths.insert(3, os.path.join(job, "missing.png"))  # decodes to (nan, nan)
    cfg = os.path.join(job, "cfg.json")
    with open(cfg, "w") as f:
        json.dump({"cognitive_modules": ["ambient_stream", "iterative_focal_stream",
                                         "exif_prior_database"],
                   "dataset": {"image_size": 56}, "exif_config": {"num_cameras": 5},
                   "focal_config": {"num_iterations": 2}}, f)
    instructions = ["center", "top-left", "bottom-right", "center", "left", "top", "right"]
    eng = {"config": cfg, "paths": paths, "instructions": instructions, "batch_size": 4,
           "vit": dict(PP["vit"]),
           "kw": dict(policy="f32", noise_mode="sample", token_filter=FILTER, seed=3,
                      save_images=False)}
    engine = CognitiveAimInference(cfg, None, "cpu", vit_cfg=DinoV2Config(**eng["vit"]),
                                   **eng["kw"])
    with torch.no_grad():
        want = engine.predict_paths_batched(paths, instructions=instructions, batch_size=4)

    # DCP: the world-1 save the ranks load, and their weights (another init)
    _, _, w1 = _jax_init(TP["arch"], TP["vit"], seed=0)
    _, _, mine = _jax_init(TP["arch"], TP["vit"], seed=1)
    tr = Trainer(R.tiny_model(w1, TP["arch"], TP["vit"]), TrainConfig(**TP["train"]),
                 output_dir=os.path.join(job, "out"))
    tr.save_checkpoint_orbax(os.path.join(job, "dcp_world1"))
    np.savez(os.path.join(job, "dcp_inputs.npz"), **{f"mine/{k}": v for k, v in mine.items()})
    # the token filter at TP 2: the JAX backbone's weights, images, guided
    # keep weights and a probe of the output for the gradients
    tpf = TP_FILTER
    jvit = jdinov2.DinoV2Config(**tpf["vit"])
    jbb = jdinov2.init(jax.random.PRNGKey(1), jvit)
    rng = np.random.RandomState(tpf["seed"])
    img = rng.randn(2, tpf["image"], tpf["image"], 3).astype(np.float32)
    P = (tpf["image"] // 14) ** 2
    kw = np.ones((2, P), np.float32)
    kw[:, 18:22], kw[:, 26:30], kw[1, 40:44] = 5.0, 2.0, 3.0
    probe = rng.randn(2, 1 + P, tpf["vit"]["hidden_size"]).astype(np.float32)
    tpf_flat = {k: np.asarray(v) for k, v in flatten_tree(jbb).items()}
    np.savez(os.path.join(job, "tpf_inputs.npz"), **{f"p/{k}": v for k, v in tpf_flat.items()},
             images=img, keep_weights=kw, probe=probe)
    with open(os.path.join(job, "spec.json"), "w") as f:
        json.dump({"engine": eng, "tp": TP, "tp_filter": tpf}, f)
    R.spawn("world2", 2, job)
    out, arrays = _read(job, 2)
    with np.load(os.path.join(job, "rank1.npz")) as z:
        engine_rank1 = z["engine"]
    # the TP 2 save, loaded at world 1
    back = Trainer(R.tiny_model(w1, TP["arch"], TP["vit"]), TrainConfig(**TP["train"]),
                   output_dir=os.path.join(job, "out"))
    back.load_checkpoint_orbax(os.path.join(job, "dcp_tp2"))
    with np.load(os.path.join(job, "rank1.npz")) as z:
        tpf_rank1 = {k: z[k] for k in z.files if k.startswith("tpf/")}
    return out, arrays, {"engine": np.asarray(want, np.float64),
                         "engine_rank1": engine_rank1, "w1": w1, "mine": mine,
                         "back": flat_params(back.model), "tpf_rank1": tpf_rank1,
                         "tpf": (jvit, jbb, tpf_flat, img, kw, probe)}


def test_dp_engine_returns_mesh_none_list_on_every_rank(world2):
    """predict_paths_batched(mesh=make_mesh()) at world 2: mixed instructions,
    the progressive filter with fused groups, sampled noise (the chunk's
    global draws), a tail chunk of 3 padded to 4 rows, a missing file; every
    rank returns mesh=None's list."""
    out, arrays, ref = world2
    want = ref["engine"]
    assert want.shape == (7, 2)
    assert np.isnan(want[3]).all() and np.isfinite(np.delete(want, 3, 0)).all()
    for got in (arrays["engine"], ref["engine_rank1"]):
        assert np.array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=0)
    np.testing.assert_array_equal(arrays["engine"], ref["engine_rank1"])
    # 2 chunks of 2 rows a rank (the tail of 3 padded to 4)
    assert out[0]["engine_batch_sizes"] == {"2": 2}


def test_dcp_tp2_and_world1_round_trip(world2):
    """Saved at TP 2 (each rank its heads of qkv, its columns of fc1), loaded
    at world 1; saved at world 1, loaded at TP 2: the tensors are equal."""
    out, arrays, ref = world2
    assert out[0]["local_qkv_shape"] == [3 * 32, 64]
    loaded = {k[len("loaded/"):]: v for k, v in arrays.items() if k.startswith("loaded/")}
    assert set(loaded) == set(ref["w1"]) == set(ref["back"])
    for k in ref["w1"]:
        np.testing.assert_array_equal(loaded[k], ref["w1"][k], err_msg=k)
        np.testing.assert_array_equal(ref["back"][k], ref["mine"][k], err_msg=k)


# ---------------------------------------------------------------- world 1 ----
def test_world1_mesh_without_process_group(tmp_path):
    """No process group: make_mesh() is (data 1, model 1) with no groups and
    reads no environment; a trainer on it is the meshless trainer."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    assert M.default_mesh_shape(8, 1) == (8, 1)
    assert M.default_mesh_shape(8, 2) == (4, 2)
    with pytest.raises(ValueError):
        M.default_mesh_shape(8, 3)
    mesh = M.make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and not mesh.distributed
    assert mesh.group("data") is None and mesh.device_mesh is None
    assert M.pad_batch_to_devices(10, mesh) == 10 and M.batch_rows(mesh, 10) == (0, 10)
    batch = {"images": np.zeros((16, 4)), "exif": {"iso": np.zeros(16)}}
    out = SH.shard_batch(mesh, batch)
    assert out["images"].shape == (16, 4) and out["exif"]["iso"].shape == (16,)
    assert SH.batch_shardings(mesh, batch)["images"] == SH.Spec(0, ("data",))
    with pytest.raises(ValueError):
        M.make_mesh(model_parallel=2)
    _, _, flat = _jax_init(TP["arch"], TP["vit"])
    batch = _batch(8, 28)
    a = _world1_step(R.tiny_model(flat, TP["arch"], TP["vit"]),
                     dict(TP["train"], tensor_parallel=False), batch, tmp_path)
    b = _world1_step(R.tiny_model(flat, TP["arch"], TP["vit"]), TP["train"], batch, tmp_path)
    assert a[0] == b[0]
    for k in a[1]:
        np.testing.assert_array_equal(a[1][k], b[1][k])


def test_step_timer():
    t = StepTimer(warmup=1)
    for _ in range(4):
        with t:
            pass
    s = t.stats()
    assert s["steps"] == 3 and s["mean_s"] >= 0


def test_chain_throughput_measures_something():
    w = torch.randn(256, 256) / 16
    per_step = chain_throughput(lambda c: torch.tanh(c @ w), torch.ones(256, 256),
                                k_short=2, k_long=12, repeats=3)
    assert np.isfinite(per_step) and per_step > 0


def _jax_filtered(jvit, jbb, images, kw, spec, monkeypatch):
    """The JAX backbone in strict float32 under ``spec``, jitted: (output,
    [(priority, kept indices, k) of each stage])."""
    from cognitive_aim_tpu.models.config import parse_token_filter as jparse

    calls = []
    orig = jdinov2._keep_indices

    def wrapped(importance, keep_weights, k_keep, ctx_frac=0.0):
        idx = orig(importance, keep_weights, k_keep, ctx_frac)
        prio = importance + 10.0 * (keep_weights - 1.0)
        jax.debug.callback(lambda p, i: calls.append((np.asarray(p), np.asarray(i), k_keep)),
                           prio, idx, ordered=True)
        return idx

    monkeypatch.setattr(jdinov2, "_keep_indices", wrapped)
    fkw = {k.replace("token_filter_", "filter_"): v for k, v in jparse(spec).items()}
    fn = jax.jit(lambda p, im, w: jdinov2.apply(p, im, jvit, attn_impl="xla", keep_weights=w,
                                                **fkw))
    out = np.asarray(fn(jbb, jnp.asarray(images), jnp.asarray(kw)))
    jax.effects_barrier()
    return out, calls


@pytest.mark.parametrize("spec", TP_FILTER["specs"])
def test_token_filter_on_tensor_parallel_blocks(world2, spec, monkeypatch):
    """TP 2 (each rank 2 of the 4 heads of q and k: the CLS rows of its heads
    summed, all-reduced over ``model``) keeps world 1's indices on both ranks,
    with outputs within 1e-5 and the whole gradients of a probe of them
    within 1e-5 of each parameter's largest (at least 1);
    world 1 keeps the JAX model's indices in strict float32, every keep
    boundary wider than 1e-5, with outputs within its backbone tolerance."""
    from cognitive_aim_tpu_torch.nn import dinov2 as TD

    out, arrays, ref = world2
    jvit, jbb, flat, images, kw, probe = ref["tpf"]
    assert out[0]["tpf_local_qkv_rows"] == 3 * TP_FILTER["vit"]["hidden_size"] // 2
    want_j, jcalls = _jax_filtered(jvit, jbb, images, kw, spec, monkeypatch)
    tprio = []
    orig = TD._keep_indices

    def spy(importance, keep_weights, k_keep, ctx_frac=0.0):
        tprio.append((importance + 10.0 * (keep_weights - 1.0)).detach().numpy())
        return orig(importance, keep_weights, k_keep, ctx_frac)

    monkeypatch.setattr(TD, "_keep_indices", spy)
    w1, idx, grads = R.filter_forward(R.filtered_backbone(flat, TP_FILTER["vit"]), spec,
                                      torch.from_numpy(images), torch.from_numpy(kw),
                                      torch.from_numpy(probe))
    assert len(jcalls) == len(tprio) == 1
    jprio, jidx, k = jcalls[0]
    gap = -np.sort(-tprio[0], axis=1)
    assert float((gap[:, k - 1] - gap[:, k]).min()) > 1e-5, "pick another seed"
    np.testing.assert_allclose(tprio[0], jprio, atol=2e-6)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_allclose(w1.numpy(), want_j, atol=2e-5, rtol=1e-4)
    for got in (arrays, ref["tpf_rank1"]):  # both ranks
        np.testing.assert_array_equal(got[f"tpf/{spec}/idx"], idx.numpy())
        np.testing.assert_allclose(got[f"tpf/{spec}/out"], w1.numpy(), atol=1e-5, rtol=0)
    tp_grads = {k[len(f"tpf/{spec}/grad/"):]: v for k, v in arrays.items()
                if k.startswith(f"tpf/{spec}/grad/")}
    assert set(tp_grads) == set(grads)
    assert np.abs(grads["backbone.layers.1.qkv.weight"]).max() > 1e-3
    for name, g in grads.items():  # float32 sums in another order, at the gradient's scale
        np.testing.assert_allclose(tp_grads[name], g, atol=1e-5 * max(1.0, np.abs(g).max()),
                                   rtol=0, err_msg=name)
