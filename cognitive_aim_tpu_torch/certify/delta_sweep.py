"""The token filter's worst-case delta over a grid of trained cells
(counterpart of scripts/delta_sweep.py).

For each (seed, depth law) cell it trains the full model (backbone
unfrozen), or with ``--measure-only`` loads the cell's checkpoint, and then
measures each candidate filter spec, int8 + filter, against the strict
float32 exact path on the same weights: the prediction-parity table
(worst-instruction AbsRel of depth) and, against the law's ground truth,
the gt-metric table (each path's AbsRel, whose gap is what a user sees). It
reports the MAX over cells against the 1% budget.

    python -m cognitive_aim_tpu_torch.certify.delta_sweep \\
        [--seeds 0,1,2] [--laws center,ring] [--steps 400] \\
        [--filters "2:0.25;2:0.35;1:0.5,3:0.35,5:0.25"] [--image-size 224] \\
        [--measure-only --laws procg --ckpt-dir DIR] [--out sweep.json] [--device cpu]

Decided differently from the script:

  * each variant is prepared under its own policy. The script prepared the
    int8 variants' weights with the training model's ``prepare_params``,
    which under the default policy returns the tree unchanged, so its int8
    variants found no int8 weights and ran the bf16 backbone: its "int8 +
    filter" rows measured bf16 + filter;
  * the f32 reference runs ``pallas_packed`` (K1's and K6's f32 programs on
    the card), where the script ran the XLA attention;
  * the models are built one at a time, each loads the flat float32 tree
    and folds adapters before ``prepare_params``, and is freed before the
    next: one copy of the weights on the device at a time;
  * a cell that fails (``--cell-subprocess``) or whose checkpoint is
    missing under ``--measure-only`` is reported and the run exits non-zero
    after writing the cells that ran; the script carried on to exit 0.
"""

import argparse
import gc
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from cognitive_aim_tpu_torch.certify import procedural as P
from cognitive_aim_tpu_torch.certify.common import (
    BUILD, ROOT, arch, depths, load_flat, load_into, save_flat, vit_config)
from cognitive_aim_tpu_torch.certify.policy_delta import synth_images
from cognitive_aim_tpu_torch.certify.synth_train import LAWS, run_training, stage_batches
from cognitive_aim_tpu_torch.convert import flat_params
from cognitive_aim_tpu_torch.core.device import resolve_device
from cognitive_aim_tpu_torch.core.precision import policy_from_name
from cognitive_aim_tpu_torch.io.preprocess import normalize_np
from cognitive_aim_tpu_torch.models import guidance as G
from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel
from cognitive_aim_tpu_torch.models.config import parse_token_filter
from cognitive_aim_tpu_torch.train.trainer import TrainConfig, Trainer

EVAL_SEED = 12345  # eval images fixed across runs for comparability


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=str, default="0,1,2")
    ap.add_argument("--laws", type=str, default="center,ring")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--eval-size", type=int, default=0,
                    help="measure at this resolution (0 = --image-size); the "
                         "interpolated position embedding keeps the weights valid")
    ap.add_argument("--n-train", type=int, default=512)
    ap.add_argument("--n-eval", type=int, default=32)
    ap.add_argument("--eval-batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--filters", type=str, default="2:0.25;2:0.35;1:0.5,3:0.35,5:0.25")
    ap.add_argument("--train-filter", type=str, default="",
                    help="train WITH this token-filter schedule active (filter-aware "
                         "finetuning); checkpoints carry a spec suffix")
    ap.add_argument("--train-filter-mode", type=str, default="always",
                    choices=["always", "alternate"],
                    help="'always' keeps the filter on every step; 'alternate' "
                         "interleaves filtered and exact steps (the sandwich)")
    ap.add_argument("--train-guided", action="store_true",
                    help="a random guidance instruction per sample per train step")
    ap.add_argument("--adapter-rank", type=int, default=0,
                    help="measure the adapter-gated sandwich: checkpoints carry _ad<rank> "
                         "(pretrain --adapter-rank); the filtered variants fold the "
                         "adapters, the f32 exact path runs the original base")
    ap.add_argument("--adapter-heads", action="store_true",
                    help="checkpoints carry _adh<rank> and a filterpath/ overlay, "
                         "applied to the filtered variants only")
    ap.add_argument("--adapter-targets", type=str, default="qkv,attn_out,fc1,fc2")
    ap.add_argument("--adapter-alpha", type=int, default=0,
                    help="0 = rank (scaling 1), matching the trainer")
    ap.add_argument("--exact-from", type=str, default="",
                    help="the f32 EXACT reference's weights from this checkpoint "
                         "instead of the cell's own (the assembled deployment delta)")
    ap.add_argument("--out", type=str, default=os.path.join(BUILD, "delta_sweep.json"))
    ap.add_argument("--layers", type=int, default=0,
                    help="override backbone depth (0 = full ViT-B); with --tiny also "
                         "shrinks width for CPU smoke tests")
    ap.add_argument("--backbone", type=str, default="base", choices=["base", "large"],
                    help="'large' measures ViT-L (checkpoints carry _L)")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", type=str, default=os.path.join(BUILD, "delta_sweep_ckpts"),
                    help="each cell's trained weights; with --measure-only, loaded "
                         "instead of trained")
    ap.add_argument("--measure-only", action="store_true")
    ap.add_argument("--include-unguided", action="store_true",
                    help="also measure the unguided path as pseudo-instruction "
                         "'unguided' (scored against the 'center' label)")
    ap.add_argument("--eval-on-train", action="store_true",
                    help="evaluate on the first n_eval TRAIN images of each cell")
    ap.add_argument("--cell-subprocess", action="store_true",
                    help="run each (seed, law) cell in its own process and merge the "
                         "per-cell JSONs (bounds the host memory of long grids)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA device)")
    return ap.parse_args(argv)


def checkpoint_paths(args, seed, law):
    """(the cell's checkpoint, the size-less name of older 224 grids)."""
    tf_tag = ""
    if args.train_filter:
        tf_tag = "_tf" + args.train_filter.replace(":", "-") \
            .replace(",", "_").replace("@", "r")
    if args.adapter_rank and args.train_filter:
        tf_tag += ("_adh" if args.adapter_heads else "_ad") + str(args.adapter_rank)
    elif args.train_filter_mode == "alternate" and args.train_filter:
        tf_tag += "_alt"
    elif args.train_filter_mode == "always" and args.train_filter:
        tf_tag += "_fa"  # pretrain --filter-always's tag
    if args.train_guided:
        tf_tag += "_g"
    if args.backbone == "large":
        tf_tag += "_L"  # pretrain's backbone suffix
    ckpt = os.path.join(args.ckpt_dir,
                        f"s{seed}_{law}_{args.steps}_i{args.image_size}{tf_tag}.npz")
    legacy = os.path.join(args.ckpt_dir, f"s{seed}_{law}_{args.steps}{tf_tag}.npz")
    return ckpt, legacy


def _run_cells_in_subprocesses(args, argv):
    """Re-invoke this module once per (seed, law) cell and merge the outputs."""
    argv = list(sys.argv[1:] if argv is None else argv)
    fwd, skip = [], False
    for a in argv:  # argv minus the flags set per cell
        if skip:
            skip = False
            continue
        if a in ("--seeds", "--laws", "--out"):
            skip = True
            continue
        if a == "--cell-subprocess" or a.startswith(("--seeds=", "--laws=", "--out=")):
            continue
        fwd.append(a)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    runs, failed = [], []
    for seed, law in itertools.product(args.seeds.split(","), args.laws.split(",")):
        cell_out = f"{args.out}.s{seed}_{law}.json"
        cmd = [sys.executable, "-m", "cognitive_aim_tpu_torch.certify.delta_sweep", *fwd,
               "--seeds", seed, "--laws", law, "--out", cell_out]
        print(f"=== subprocess cell seed={seed} law={law} ===", flush=True)
        rc = subprocess.call(cmd, env=env)
        if rc != 0:
            print(f"  cell FAILED (rc={rc})", flush=True)
            failed.append((seed, law, rc))
            continue
        with open(cell_out) as f:
            runs.extend(json.load(f)["runs"])
        with open(args.out, "w") as f:
            json.dump({"runs": runs}, f, indent=1)
    print(f"\n=== worst-case over {len(runs)} subprocess cells ===")
    for spec in [s for s in args.filters.split(";") if s]:
        vals = [max(r["table"][spec].values()) for r in runs if spec in r.get("table", {})]
        if vals:
            worst = max(vals)
            print(f"  {spec:>24s}: max worst-instruction AbsRel {worst * 100:.3f}%  "
                  f"{'WITHIN' if worst < 0.01 else 'EXCEEDS'} 1% budget")
    print(f"wrote {args.out}")
    if failed:
        raise SystemExit(f"cells failed: {failed}")
    return {"runs": runs}


# ----------------------------------------------------------- eval sets ----
def eval_batches(norm, batch, device):
    return [torch.from_numpy(norm[s:s + batch]).to(device)
            for s in range(0, norm.shape[0], batch)]


def build_eval(n, size, seed, batch, device):
    """(images in [0, 1], device batches) of ``synth_images``."""
    e01 = synth_images(n, size, seed)
    return e01, eval_batches(normalize_np(e01), batch, device)


def build_eval_proc(law, n, size, batch, device):
    """(device batches, gt) of the procedural laws at EVAL_SEED: [n] depths,
    or [n, 9] per-instruction depths for 'proca'."""
    gen = P.gen_procedural_aimed if law == "proca" else P.gen_procedural
    e01, gt = gen(n, size, EVAL_SEED)
    return eval_batches(normalize_np(e01), batch, device), gt


def instruction_names(include_unguided=False):
    return list(G.INSTRUCTIONS) + (["unguided"] if include_unguided else [])


# -------------------------------------------------------------- models ----
def f32_model(eval_size, *, backbone="base", vit=None, attn_impl="pallas_packed",
              device=None):
    """The exact reference: strict float32, no filter, no adapters."""
    return CognitiveAimModel(arch(eval_size, backbone), policy=policy_from_name("f32"),
                             attn_impl=attn_impl, vit_cfg=vit, device=device)


def variant_model(spec, eval_size, *, backbone="base", vit=None, policy="int8",
                  attn_impl="pallas_packed", device=None):
    """One filtered variant, under ``policy``."""
    return CognitiveAimModel(arch(eval_size, backbone, **parse_token_filter(spec)),
                             policy=policy_from_name(policy), attn_impl=attn_impl,
                             vit_cfg=vit, device=device)


def loaded(model, flat, adapter=(0, 0)):
    """``model`` with the flat float32 tree, its adapters folded at
    ``adapter`` = (rank, alpha) when rank > 0, then prepared for its own
    policy."""
    load_into(model, flat)
    if adapter[0]:
        model.merge_lora_params(*adapter)
    return model.prepare_params()


def model_depths(model, batches, gnames):
    """{instruction: [n] float64 depths}, noise 0."""
    out = {}
    for g in gnames:
        gi = None if g == "unguided" else G.INSTRUCTIONS.index(g)
        out[g] = torch.cat([depths(model, xb, gi) for xb in batches])
    return {g: v.double().cpu().numpy() for g, v in out.items()}


def with_overlay(flat):
    """The filtered path's tree: the ``filterpath/`` overlay's top-level
    subtrees in place of the main tree's."""
    fp = {k[len("filterpath/"):]: v for k, v in flat.items() if k.startswith("filterpath/")}
    tops = {k.split("/")[0] for k in fp}
    out = {k: v for k, v in flat.items()
           if not k.startswith("filterpath/") and k.split("/")[0] not in tops}
    out.update(fp)
    return out


def measure(flat_f32, flat_fast, specs, batches, *, gt=None, gnames=None, eval_size,
            backbone="base", vit=None, adapter=(0, 0), policy="int8",
            attn_impl="pallas_packed", device=None):
    """-> (table {spec: {instruction: AbsRel against f32}}, gt_table {name incl.
    'f32': {instruction: AbsRel against gt}} or None, depths {name:
    {instruction: [n]}}).

    The first table is strict PREDICTION parity (the fast path's drift from
    the exact path on the same weights); the second METRIC parity (each
    path's error against the ground truth, what the user observes). Each
    model is built, measured and freed in turn."""
    gnames = gnames or instruction_names()
    kw = dict(backbone=backbone, vit=vit, attn_impl=attn_impl, device=device)
    preds = {"f32": model_depths(loaded(f32_model(eval_size, **kw), flat_f32),
                                  batches, gnames)}
    for spec in specs:
        m = loaded(variant_model(spec, eval_size, policy=policy, **kw), flat_fast, adapter)
        preds[spec] = model_depths(m, batches, gnames)
        del m
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    table = {spec: {g: float(np.mean(np.abs(preds[spec][g] - preds["f32"][g])
                                     / np.maximum(np.abs(preds["f32"][g]), 1e-6)))
                    for g in gnames} for spec in specs}
    gt_table = None
    if gt is not None:
        gt = np.asarray(gt, np.float64)

        def col(g):  # [n, 9] per-instruction labels; 'unguided' scores 'center'
            if gt.ndim == 2:
                return gt[:, 0 if g == "unguided" else G.INSTRUCTIONS.index(g)]
            return gt

        gt_table = {name: {g: float(np.mean(np.abs(d[g] - col(g))
                                            / np.maximum(np.abs(col(g)), 1e-6)))
                           for g in gnames}
                    for name, d in preds.items()}
    return table, gt_table, preds


# ---------------------------------------------------------------- main ----
def main(argv=None):
    args = parse_args(argv)
    if args.cell_subprocess:
        return _run_cells_in_subprocesses(args, argv)

    dev = resolve_device(args.device)
    seeds = [int(s) for s in args.seeds.split(",")]
    laws = args.laws.split(",")
    specs = [s for s in args.filters.split(";") if s]
    vit = vit_config(args.layers, args.tiny, args.image_size)
    eval_size = args.eval_size or args.image_size
    EB = args.eval_batch
    gnames = instruction_names(args.include_unguided)

    trainer = None
    if not args.measure_only:
        # one model and trainer for every cell: parameters reset per cell
        tf_kw = parse_token_filter(args.train_filter)
        if tf_kw:
            tf_kw["token_filter_train"] = True
        model = CognitiveAimModel(arch(args.image_size, args.backbone, **tf_kw),
                                  attn_impl="pallas_packed", vit_cfg=vit, device=dev)
        alt_model = None
        if tf_kw and args.train_filter_mode == "alternate":
            alt_model = CognitiveAimModel(arch(args.image_size, args.backbone),
                                          attn_impl="pallas_packed", vit_cfg=vit, device=dev)
        tcfg = TrainConfig(epochs=1, batch_size=args.batch, steps_per_epoch=args.steps,
                           learning_rate=args.lr, freeze_backbone=False,
                           guided_training=args.train_guided)
        trainer = Trainer(model, tcfg, output_dir=args.ckpt_dir, alt_model=alt_model)
    os.makedirs(args.ckpt_dir, exist_ok=True)

    eval01, eval_dev = (None, None) if args.eval_on_train else \
        build_eval(args.n_eval, eval_size, EVAL_SEED, EB, dev)
    eval_seed_loaded, proc_eval = None, None
    results, skipped = [], []
    for seed, law in itertools.product(seeds, laws):
        t0 = time.perf_counter()
        print(f"\n=== run seed={seed} law={law} ===", flush=True)
        ckpt, legacy = checkpoint_paths(args, seed, law)
        if not os.path.exists(ckpt) and os.path.exists(legacy) and args.image_size == 224:
            ckpt = legacy  # 224 grids written before the size suffix
        if os.path.exists(ckpt):
            print(f"  (loading {ckpt})", flush=True)
            trained = load_flat(ckpt)[0]
        elif args.measure_only:
            print(f"  SKIP: --measure-only but {ckpt} missing", flush=True)
            skipped.append(ckpt)
            continue
        else:
            if law == "proca":
                raise SystemExit("law 'proca' trains with per-sample (instruction, label) "
                                 "pairs: produce the checkpoint with certify.pretrain "
                                 "--aimed, then run this sweep with --measure-only")
            trainer.model.init(torch.Generator(dev).manual_seed(seed))
            trainer.reset_params()
            if law in ("proc", "procg"):
                # short procedural cells train here; certify.pretrain makes the
                # long ones this name matches
                imgs01, target = P.gen_procedural(args.n_train, args.image_size, seed)
            else:
                imgs01 = synth_images(args.n_train, args.image_size, seed)
                target = LAWS[law](imgs01)
            staged = stage_batches(trainer, normalize_np(imgs01), target, args.batch)
            run_training(trainer, staged, args.steps)
            trained = flat_params(trainer.model)
            save_flat(ckpt, trained)
        def main_tree(flat):  # without the filtered path's overlay
            return {k: v for k, v in flat.items() if not k.startswith("filterpath/")}

        fast = main_tree(trained)
        exact = main_tree(load_flat(args.exact_from)[0]) if args.exact_from else fast
        adapter = (0, 0)
        if args.adapter_rank:
            fast = with_overlay(trained)  # sandwich head deltas ride the filtered path
            adapter = (args.adapter_rank, args.adapter_alpha or args.adapter_rank)
        if law in ("proc", "procg", "proca"):
            if proc_eval is None or proc_eval[0] != law:
                proc_eval = (law, build_eval_proc(law, args.n_eval, eval_size, EB, dev))
            ev, gt = proc_eval[1]
        else:
            if args.eval_on_train and eval_seed_loaded != seed:
                eval01, eval_dev = build_eval(args.n_eval, eval_size, seed, EB, dev)
                eval_seed_loaded = seed
            gt, ev = LAWS[law](eval01), eval_dev
        table, gt_table, _ = measure(
            exact, fast, specs, ev, gt=gt, gnames=gnames, eval_size=eval_size,
            backbone=args.backbone, vit=vit, adapter=adapter, device=dev)
        del exact, fast, trained
        gc.collect()
        rss_gb = 0.0
        if os.path.exists("/proc/self/status"):
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS"):
                        rss_gb = int(line.split()[1]) / 1e6
        dev_gb = torch.cuda.memory_allocated(dev) / 1e9 if dev.type == "cuda" else 0.0
        print(f"  [mem] RSS {rss_gb:.1f} GB; device allocated {dev_gb:.1f} GB", flush=True)
        for spec, per in table.items():
            worst = max(per.values())
            gt_gap = max(abs(gt_table[spec][g] - gt_table["f32"][g]) for g in per)
            print(f"  {spec:>24s}: worst-instruction AbsRel {worst * 100:.3f}%  "
                  f"(gt-metric gap {gt_gap * 100:.3f}%)", flush=True)
        results.append({"seed": seed, "law": law, "table": table, "absrel_gt": gt_table,
                        "train_s": round(time.perf_counter() - t0, 1)})
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"runs": results}, f, indent=1)

    print(f"\n=== worst-case over {len(results)} runs "
          f"({len(seeds)} seeds x {len(laws)} laws, {args.steps} steps) ===")
    for spec in specs:
        worst, worst_run = 0.0, None
        for r in results:
            w = max(r["table"][spec].values())
            if w > worst or worst_run is None:
                worst, worst_run = w, (r["seed"], r["law"])
        if worst_run is not None:
            print(f"  {spec:>24s}: max worst-instruction AbsRel {worst * 100:.3f}%  "
                  f"(seed={worst_run[0]}, law={worst_run[1]})  "
                  f"{'WITHIN' if worst < 0.01 else 'EXCEEDS'} 1% budget")
    print(f"wrote {args.out}")
    if skipped:
        raise SystemExit(f"--measure-only: checkpoints missing: {skipped}")
    return {"runs": results}


if __name__ == "__main__":
    main()
