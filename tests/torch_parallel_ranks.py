"""The rank programs of tests/test_torch_parallel.py: each runs in a spawned
process of a gloo world on the CPU and writes what it found to its job
directory (``rank<r>.npz``, ``rank<r>.json``); the test file compares.

This module imports no jax: the spawned ranks import only torch and the
port. Inputs come from the test process as npz files in the job directory.
"""

from __future__ import annotations

import json
import os
import sys
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spawn(program: str, world: int, job: str, env=None) -> None:
    """Run ``program`` in ``world`` spawned ranks (gloo, file rendezvous in
    ``job``); raises if a rank fails, with its traceback."""
    import torch.multiprocessing as mp

    try:
        mp.spawn(_entry, args=(world, job, program, env or {}), nprocs=world, join=True)
    except Exception as e:
        tb = [open(os.path.join(job, f)).read() for f in sorted(os.listdir(job))
              if f.endswith(".err")]
        raise RuntimeError(f"{program} at world {world} failed: {e}\n" + "\n".join(tb)) from e


def _entry(rank, world, job, program, env):
    import faulthandler

    # a rank that waits on a collective its peers never reach fails the test
    # with its stack instead of hanging the run
    faulthandler.dump_traceback_later(240, exit=True,
                                      file=open(os.path.join(job, f"rank{rank}.err"), "w"))
    os.environ.update(env)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from cognitive_aim_tpu_torch.core.mesh import initialize_distributed

    initialize_distributed("cpu", init_method=f"file://{job}/rendezvous", rank=rank,
                           world_size=world)
    out, arrays = {}, {}
    try:
        globals()[program](rank, world, job, out, arrays)
        dist.barrier()
    except Exception:
        with open(os.path.join(job, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        with open(os.path.join(job, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        np.savez(os.path.join(job, f"rank{rank}.npz"), **arrays)
        dist.destroy_process_group()


# ------------------------------------------------------------------ models ----
def tiny_model(flat, arch_kw, vit_kw, policy="f32", attn_impl="pallas_packed"):
    """The port's model on the CPU with the JAX flat interchange ``flat``."""
    from cognitive_aim_tpu_torch.convert import load_flat_params
    from cognitive_aim_tpu_torch.core.precision import policy_from_name
    from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel
    from cognitive_aim_tpu_torch.models.config import ModelArchConfig
    from cognitive_aim_tpu_torch.nn.dinov2 import DinoV2Config

    m = CognitiveAimModel(ModelArchConfig(**arch_kw), policy_from_name(policy), attn_impl,
                          vit_cfg=DinoV2Config(**vit_kw), device="cpu")
    load_flat_params(m, flat)
    return m


def load_inputs(job, name):
    with np.load(os.path.join(job, name), allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def unflatten_batch(z):
    """npz keys ``images``, ``depths``, ``exif/<k>`` -> the trainer's batch."""
    batch = {k: v for k, v in z.items() if "/" not in k}
    batch["exif"] = {k.split("/", 1)[1]: v for k, v in z.items() if k.startswith("exif/")}
    return batch


def step_grads(tr, batch, generator=None):
    """The whole gradients of one micro-step of ``tr``, as the optimiser
    sees them: summed over the mesh, split ones gathered."""
    import torch

    from cognitive_aim_tpu_torch.parallel import pipeline as PL
    from cognitive_aim_tpu_torch.parallel.sharding import param_shardings, whole

    with PL.grad_anchors() as anchors:
        total, _ = tr.loss(tr.model, tr.device_batch(batch), generator, *tr.step_inputs())
    params = [p for _, p in tr._trainable]
    got = torch.autograd.grad(total, params + anchors, allow_unused=True)[:len(params)]
    got = tr._reduce([torch.zeros_like(p) if g is None else g for p, g in zip(params, got)])
    specs = param_shardings(tr.mesh, tr.model, tr.cfg.tensor_parallel)
    return float(total.detach()), {n: whole(tr.mesh, g, specs[n]).numpy()
                          for (n, _), g in zip(tr._trainable, got)}


def train_one_step(model, cfg_kw, batch, job, mesh=None):
    """(loss, whole parameters as the flat interchange) after one
    ``Trainer.train_step`` without a generator."""
    from cognitive_aim_tpu_torch.convert import flat_params
    from cognitive_aim_tpu_torch.parallel.sharding import unsharded
    from cognitive_aim_tpu_torch.train.trainer import TrainConfig, Trainer

    tr = Trainer(model, TrainConfig(**cfg_kw), output_dir=os.path.join(job, "out"), mesh=mesh)
    loss = tr.train_step(batch, None)["loss"]
    with unsharded(tr.model):
        flat = flat_params(tr.model)
    return loss, flat


def digest(flat) -> str:
    """sha256 of the whole parameters: equal on every rank when the replicas
    stayed in step."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(np.ascontiguousarray(flat[k]).tobytes())
    return h.hexdigest()


def filtered_backbone(flat, vit_kw):
    """The port's float32 DinoV2 on the CPU with the JAX flat backbone
    interchange ``flat`` (keys without the ``backbone/`` prefix), inside a
    module whose ``backbone`` it is (the layout ``shard_params`` reads)."""
    import torch

    from cognitive_aim_tpu_torch.convert import load_flat_params
    from cognitive_aim_tpu_torch.nn.dinov2 import DinoV2, DinoV2Config

    class Wrap(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.backbone = DinoV2(DinoV2Config(**vit_kw), device="cpu")

    return load_flat_params(Wrap(), {f"backbone/{k}": v for k, v in flat.items()})


def filter_forward(wrap, spec, images, keep_weights, probe, mesh=None):
    """The filtered backbone forward of ``spec`` with ``keep_weights``, and
    the gradients of ``(out * probe).sum()`` by parameter (the whole ones
    under tensor parallelism): (out, kept indices, {name: gradient})."""
    import torch

    from cognitive_aim_tpu_torch.models.config import parse_token_filter
    from cognitive_aim_tpu_torch.parallel.sharding import param_shardings, whole

    fkw = {k.replace("token_filter_", "filter_"): v
           for k, v in parse_token_filter(spec).items()}
    names, params = zip(*wrap.named_parameters())
    with torch.enable_grad():
        out, idx = wrap.backbone.forward_with_kept(
            images, compute_dtype=torch.float32, attn_impl="pallas_packed",
            keep_weights=keep_weights, **fkw)
        grads = torch.autograd.grad((out * probe).sum(), params, allow_unused=True)
    specs = param_shardings(mesh, wrap, mesh is not None)
    grads = {n: (torch.zeros_like(p) if g is None else g) for n, p, g in zip(names, params, grads)}
    if mesh is not None:
        grads = {n: whole(mesh, g, specs[n]) for n, g in grads.items()}
    return out.detach(), idx, {n: g.numpy() for n, g in grads.items()}


# ---------------------------------------------------------- world 4 ----
def world4(rank, world, job, out, arrays):
    """Mesh shapes; the TP 2 x DP 2 step; the pipelined backbone, model,
    gradients and train step; pipelined_scan's shape errors."""
    import torch

    from cognitive_aim_tpu_torch.core import mesh as M
    from cognitive_aim_tpu_torch.parallel import comm
    from cognitive_aim_tpu_torch.parallel import pipeline as PL
    from cognitive_aim_tpu_torch.parallel.sharding import shard_batch
    from cognitive_aim_tpu_torch.train.trainer import TrainConfig, Trainer

    spec = json.load(open(os.path.join(job, "spec.json")))

    # -- meshes
    m = M.make_mesh(model_parallel=2)
    mh = M.make_multihost_mesh(model_parallel=1)  # replicas from LOCAL_WORLD_SIZE
    rows = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    local = shard_batch(mh, {"x": torch.from_numpy(rows)})["x"]
    out["mesh"] = {
        "shape": m.shape, "index": m.index, "pad11": M.pad_batch_to_devices(11, m),
        "rows": M.batch_rows(m, 8),
        "multihost_shape": mh.shape, "multihost_axes": list(M.batch_axes(mh)),
        "multihost_pad5": M.pad_batch_to_devices(5, mh),
        "multihost_rows": M.batch_rows(mh, 8),
        "multihost_local": local.tolist(),
        "multihost_gathered": comm.gather_batch(local, mh, M.batch_axes(mh)).tolist(),
    }
    try:
        M.make_multihost_mesh(model_parallel=3, replicas=2)
        out["mesh"]["multihost_raised"] = False
    except ValueError:
        out["mesh"]["multihost_raised"] = True

    # -- TP 2 x DP 2 train step of the tiny flagship
    tp = spec["tp"]
    z = load_inputs(job, "tp_inputs.npz")
    flat = {k[len("p/"):]: v for k, v in z.items() if k.startswith("p/")}
    batch = unflatten_batch({k[len("b/"):]: v for k, v in z.items() if k.startswith("b/")})
    tr = Trainer(tiny_model(flat, tp["arch"], tp["vit"]),
                 TrainConfig(**dict(tp["train"], freeze_backbone=False)),
                 output_dir=os.path.join(job, "out"), mesh=m)
    out["tp_grad_loss"], grads = step_grads(tr, batch)
    loss, got = train_one_step(tiny_model(flat, tp["arch"], tp["vit"]), tp["train"], batch,
                               job, mesh=m)
    out["tp_loss"], out["tp_digest"] = loss, digest(got)
    if rank == 0:
        arrays.update({f"tp/{k}": v for k, v in got.items()})
        arrays.update({f"tp_grad/{k}": v for k, v in grads.items()})

    # -- pipelined backbone and model, (data 1, pipe 4) and (data 2, pipe 2)
    pp = spec["pp"]
    z = load_inputs(job, "pp_inputs.npz")
    flat = {k[len("p/"):]: v for k, v in z.items() if k.startswith("p/")}
    model = tiny_model(flat, pp["arch"], pp["vit"])
    images = torch.from_numpy(z["images"])
    exif = {k[len("exif/"):]: torch.from_numpy(v) for k, v in z.items() if k.startswith("exif/")}
    gidx = torch.from_numpy(z["gidx"]).long()
    for stages in (4, 2):
        pm = PL.make_pipeline_mesh(stages)
        lo, hi = M.batch_rows(pm, images.shape[0])
        with torch.no_grad(), comm.batch_shard(pm, lo, hi, images.shape[0], M.DATA_AXIS):
            hs = model.backbone.apply_pipelined(images[lo:hi], pm, n_micro=2,
                                                attn_impl="pallas_packed")
            hs = comm.gather_batch(hs, pm, M.batch_axes(pm))
            o = model(images[lo:hi], {k: v[lo:hi] for k, v in exif.items()},
                      guidance=gidx[lo:hi], pipeline_mesh=pm, pipeline_n_micro=2)
        got = {f: comm.gather_batch(getattr(o, f), pm, M.batch_axes(pm)).numpy()
               for f in ("depth", "confidence", "attention")}
        if rank == 0:
            arrays[f"pp{stages}/backbone"] = hs.numpy()
            arrays.update({f"pp{stages}/{f}": v for f, v in got.items()})
        out[f"pp{stages}_mesh"] = pm.shape

    # -- gradients through the schedule, with and without remat
    g = np.random.RandomState(0)
    L_, D_, B_ = 8, 16, 4
    w = torch.from_numpy(g.randn(L_, D_, D_).astype(np.float32) * 0.1)
    b = torch.from_numpy(g.randn(L_, D_).astype(np.float32) * 0.1)
    x = torch.from_numpy(g.randn(B_, 5, D_).astype(np.float32))

    def block(lp, c):
        return c + torch.tanh(c @ lp["w"] + lp["b"])

    def leaves():
        ws = [w[i].clone().requires_grad_(True) for i in range(L_)]
        bs = [b[i].clone().requires_grad_(True) for i in range(L_)]
        return ws, bs, x.clone().requires_grad_(True)

    ws, bs, xx = leaves()
    c = xx
    for i in range(L_):
        c = block({"w": ws[i], "b": bs[i]}, c)
    want = torch.autograd.grad((c ** 2).sum(), ws + bs + [xx])
    pm = PL.make_pipeline_mesh(4)
    errs = {}
    for remat in (False, True):
        ws, bs, xx = leaves()
        layers = [{"w": ws[i], "b": bs[i]} for i in range(L_)]
        with PL.grad_anchors() as anchors:
            y = PL.pipelined_scan(pm, layers, xx, block, n_micro=2, remat=remat)
        inputs = ws + bs + [xx]
        got = torch.autograd.grad((y ** 2).sum(), inputs + anchors,
                                  allow_unused=True)[:len(inputs)]
        flat_g = torch.cat([(torch.zeros_like(t) if gg is None else gg).reshape(-1)
                            for t, gg in zip(inputs, got)])
        comm.all_reduce_(flat_g, pm.group(PL.PIPE_AXIS))  # whole on the stage that ran it
        ref = torch.cat([t.reshape(-1) for t in want])
        errs[str(remat)] = float(((flat_g - ref).abs() - 2e-4 * ref.abs()).max())
        out[f"grad_forward_err_{remat}"] = float((y - c).detach().abs().max())
    out["grad_excess"] = errs  # max |got - want| - rtol |want|, to hold against atol

    # -- pipelined train step against the data-parallel step on the same world
    z = load_inputs(job, "pp_train_inputs.npz")
    flat = {k[len("p/"):]: v for k, v in z.items() if k.startswith("p/")}
    batch = unflatten_batch({k[len("b/"):]: v for k, v in z.items() if k.startswith("b/")})
    pt = spec["pp_train"]
    for name, over, mesh in (("dp", {}, M.make_mesh()),
                             ("pp", dict(pipeline_stages=2, pipeline_n_micro=2),
                              PL.make_pipeline_mesh(2))):
        cfg = TrainConfig(**dict(pt["train"], **over))
        tr = Trainer(tiny_model(flat, pt["arch"], pt["vit"]), cfg,
                     output_dir=os.path.join(job, "out"), mesh=mesh)
        _, grads = step_grads(tr, batch)
        loss, got = train_one_step(tiny_model(flat, pt["arch"], pt["vit"]),
                                   dict(pt["train"], **over), batch, job, mesh=mesh)
        out[f"{name}_train_loss"], out[f"{name}_digest"] = loss, digest(got)
        if rank == 0:
            arrays.update({f"{name}_train/{k}": v for k, v in got.items()})
            arrays.update({f"{name}_grad/{k}": v for k, v in grads.items()})

    # -- data parallel with dropout, sampled noise and drawn instructions
    tr = Trainer(tiny_model(flat, pt["arch"], pt["vit"]),
                 TrainConfig(**dict(pt["train"], guided_training=True)),
                 output_dir=os.path.join(job, "out"), mesh=M.make_mesh())
    out["drawn_loss"], grads = step_grads(tr, batch, torch.Generator().manual_seed(7))
    if rank == 0:
        arrays.update({f"drawn_grad/{k}": v for k, v in grads.items()})

    # -- pipelined_scan's shape errors
    raised = {}
    for name, call in (
            ("layers", lambda: PL.pipelined_scan(pm, [None] * 6, torch.zeros(4, 3),
                                                 lambda lp, c: c, 2)),
            ("micro", lambda: PL.pipelined_scan(pm, [None] * 4, torch.zeros(3, 3),
                                                lambda lp, c: c, 2)),
            ("stages", lambda: PL.make_pipeline_mesh(3))):
        try:
            call()
            raised[name] = False
        except ValueError:
            raised[name] = True
    out["raised"] = raised


# ---------------------------------------------------------- world 2 ----
def world2(rank, world, job, out, arrays):
    """The data-parallel engine; DCP checkpoints at TP 2."""
    import torch

    from cognitive_aim_tpu_torch.api import CognitiveAimInference
    from cognitive_aim_tpu_torch.core import mesh as M
    from cognitive_aim_tpu_torch.nn.dinov2 import DinoV2Config
    from cognitive_aim_tpu_torch.parallel.sharding import unsharded
    from cognitive_aim_tpu_torch.train.trainer import TrainConfig, Trainer
    from cognitive_aim_tpu_torch.convert import flat_params

    spec = json.load(open(os.path.join(job, "spec.json")))
    eng = spec["engine"]
    engine = CognitiveAimInference(eng["config"], None, "cpu", vit_cfg=DinoV2Config(**eng["vit"]),
                                   **eng["kw"])
    with torch.no_grad():
        res = engine.predict_paths_batched(eng["paths"], instructions=eng["instructions"],
                                           batch_size=eng["batch_size"], mesh=M.make_mesh())
    arrays["engine"] = np.asarray(res, np.float64)
    out["engine_batch_sizes"] = dict(engine.batch_sizes)

    # DCP: save at TP 2, load the world-1 save
    tp = spec["tp"]
    z = load_inputs(job, "dcp_inputs.npz")
    mine = {k[len("mine/"):]: v for k, v in z.items() if k.startswith("mine/")}
    mesh = M.make_mesh(model_parallel=2)
    tr = Trainer(tiny_model(mine, tp["arch"], tp["vit"]),
                 TrainConfig(**tp["train"]), output_dir=os.path.join(job, "out"), mesh=mesh)
    out["local_qkv_shape"] = list(tr.model.backbone.layers[0].qkv.weight.shape)
    tr.save_checkpoint_orbax(os.path.join(job, "dcp_tp2"))
    tr.load_checkpoint_orbax(os.path.join(job, "dcp_world1"))
    with unsharded(tr.model):
        loaded = flat_params(tr.model)
    if rank == 0:
        arrays.update({f"loaded/{k}": v for k, v in loaded.items()})

    # the token filter on tensor-parallel blocks: TP 2, each rank half the heads
    from cognitive_aim_tpu_torch.parallel.sharding import shard_params

    tpf = spec["tp_filter"]
    z = load_inputs(job, "tpf_inputs.npz")
    flat = {k[len("p/"):]: v for k, v in z.items() if k.startswith("p/")}
    for name in tpf["specs"]:
        wrap = shard_params(mesh, filtered_backbone(flat, tpf["vit"]), tensor_parallel=True)
        out["tpf_local_qkv_rows"] = wrap.backbone.layers[0].qkv.weight.shape[0]
        got, idx, grads = filter_forward(wrap, name, torch.from_numpy(z["images"]),
                                         torch.from_numpy(z["keep_weights"]),
                                         torch.from_numpy(z["probe"]), mesh)
        arrays[f"tpf/{name}/out"] = got.numpy()
        arrays[f"tpf/{name}/idx"] = idx.numpy()
        if rank == 0:
            arrays.update({f"tpf/{name}/grad/{k}": v for k, v in grads.items()})
