"""The long pretrain on procedural scenes: the concentrated-attention regime,
built from data the repository generates (counterpart of
scripts/pretrain_procedural.py).

Trains the full model (backbone unfrozen; AdamW + cosine, SILog +
curiosity, per-block recompute) on ``procedural.gen_procedural`` scenes,
whose depth label is the apparent size of a target the model must find.
The task generalises, so the held-out AbsRel is reported at every eval
interval (and before the first step).

The training set is staged on the device once, as uint8; each step
normalises its batch there and flips it (depth does not change under a
flip), both flips drawn for the whole batch. ``--aimed`` draws one
instruction per sample and gathers its label instead, without flips.
Random draws come from ``torch.Generator``s on the device, one per step,
seeded from ``--seed`` and the step, so a run repeats itself; they are not
the script's ``jax.random`` draws, and parity with it is by statistics.

    python -m cognitive_aim_tpu_torch.certify.pretrain --guided --seed 0 --steps 3000 \\
        [--n-images 2048] [--batch 16] [--image-size 518] [--ckpt-dir DIR]

The checkpoint is ``{ckpt-dir}/s{seed}_{law}_{steps}_i{size}{tags}.npz``, the
name ``delta_sweep --measure-only`` looks for; the scene caches lie in
``--data-cache``. Both default under ``build/certify/``.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from cognitive_aim_tpu_torch.certify import procedural as P
from cognitive_aim_tpu_torch.certify.common import (
    BUILD, absrel, arch, depths, exif_batch, load_flat, load_into, save_flat, vit_config)
from cognitive_aim_tpu_torch.certify.synth_train import check_step_inputs
from cognitive_aim_tpu_torch.convert import flat_params
from cognitive_aim_tpu_torch.core.device import resolve_device
from cognitive_aim_tpu_torch.core.rng import NoiseMode
from cognitive_aim_tpu_torch.io.preprocess import normalize_u8
from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel
from cognitive_aim_tpu_torch.models.config import parse_token_filter
from cognitive_aim_tpu_torch.train.trainer import TrainConfig, Trainer

EVAL_DATA_SEED = 90000  # held-out scenes, a seed space apart from training


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--image-size", type=int, default=518)
    ap.add_argument("--n-images", type=int, default=2048)
    ap.add_argument("--n-eval", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--ckpt-dir", type=str, default=os.path.join(BUILD, "ckpts_518"))
    ap.add_argument("--data-cache", type=str, default=os.path.join(BUILD, "proc_data"),
                    help="cache generated scenes here (~8 min for 2048 at 518² on one core)")
    ap.add_argument("--layers", type=int, default=0,
                    help="override backbone depth (0 = full ViT-B)")
    ap.add_argument("--backbone", type=str, default="base", choices=["base", "large"],
                    help="'large' pretrains ViT-L (checkpoint name gains _L)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny backbone (D 64, 4 heads) for CPU smoke tests")
    ap.add_argument("--guided", action="store_true",
                    help="guided-native pretrain: a random instruction per sample per "
                         "step (the label is instruction-invariant, so this teaches "
                         "robustness under instruction modulation); law 'procg'")
    ap.add_argument("--aimed", action="store_true",
                    help="AIMED pretrain (law 'proca'): 3 targets a scene, the label "
                         "is the depth of the target nearest the sampled instruction's "
                         "anchor; no flips (labels are not flip-invariant)")
    ap.add_argument("--train-filter", type=str, default="",
                    help="filter-aware finetune: the token filter on the filtered "
                         "steps, the exact path on the rest (the trainer's alt_model); "
                         "meant with --init-from. Name gains _tf<spec>")
    ap.add_argument("--filter-every", type=int, default=2,
                    help="with --train-filter: the FILTERED step once every N steps "
                         "(2 = the 1:1 sandwich); values != 2 add _e<N> to the name")
    ap.add_argument("--init-from", type=str, default="",
                    help="warm-start from this .npz instead of random init "
                         "(fresh optimizer state)")
    ap.add_argument("--adapter-rank", type=int, default=0,
                    help="adapter-gated sandwich: with --train-filter and --init-from, "
                         "freeze the whole base and train backbone LoRA adapters of "
                         "this rank, the filter on every step; the saved base is the "
                         "--init-from tensors verbatim. 0 = off")
    ap.add_argument("--adapter-heads", action="store_true",
                    help="with --adapter-rank, also train the non-backbone tensors for "
                         "the filtered path, saved as a filterpath/ overlay")
    ap.add_argument("--adapter-heads-lr", type=float, default=0.0,
                    help="with --adapter-heads: the non-backbone group's lr (0 = --lr)")
    ap.add_argument("--adapter-targets", type=str, default="qkv,attn_out,fc1,fc2",
                    help="comma list of the projections that carry adapters")
    ap.add_argument("--adapter-alpha", type=int, default=0,
                    help="LoRA alpha (0 = rank, i.e. scaling 1)")
    ap.add_argument("--filter-always", action="store_true",
                    help="full-weight finetune with the filter on EVERY step (the "
                         "two-checkpoint deployment's fast replica); _fa replaces _alt")
    ap.add_argument("--summary", type=str, default="",
                    help="also write the run's numbers (held-out AbsRel, every 10th "
                         "loss, seconds) as JSON here")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    if args.filter_every < 2:
        ap.error("--filter-every must be >= 2 (1 would never run the exact path; use "
                 "--filter-always for the always-on regime)")
    if args.aimed and args.guided:
        ap.error("--aimed and --guided are mutually exclusive "
                 "(aimed is guided-native by construction)")
    if args.adapter_rank and not (args.train_filter and args.init_from):
        ap.error("--adapter-rank needs --train-filter (the path the adapters are "
                 "gated to) and --init-from (the frozen base)")
    return args


def law_of(args) -> str:
    return "proca" if args.aimed else ("procg" if args.guided else "proc")


def checkpoint_name(args) -> str:
    """The script's checkpoint path, the one ``delta_sweep`` builds for the
    same cell."""
    tf_tag = ""
    if args.train_filter:
        tf_tag = "_tf" + args.train_filter.replace(":", "-").replace(",", "_") \
            .replace("@", "r") + "_alt"
        if args.filter_every != 2:
            tf_tag += f"_e{args.filter_every}"
        if args.adapter_rank:
            # the adapters replace the alternation: only filtered steps train
            ad = "adh" if args.adapter_heads else "ad"
            tf_tag = tf_tag.replace("_alt", f"_{ad}{args.adapter_rank}")
        elif args.filter_always:
            tf_tag = tf_tag.replace("_alt", "_fa")
    bb_tag = "_L" if args.backbone == "large" else ""
    return os.path.join(
        args.ckpt_dir,
        f"s{args.seed}_{law_of(args)}_{args.steps}_i{args.image_size}{tf_tag}{bb_tag}.npz")


def cache_names(args):
    """(train cache, eval cache) paths of the script."""
    tag = "aimed_" if args.aimed else ""
    S = args.image_size
    return (os.path.join(args.data_cache, f"train_{tag}s{args.seed}_n{args.n_images}_{S}.npz"),
            os.path.join(args.data_cache, f"eval_{tag}n{args.n_eval}_{S}.npz"))


def step_generator(seed: int, step: int, device, stream: int = 0):
    """A generator on the device for one step, from the run's seed, the step
    and the stream (0 the trainer's noise and dropout, 1 the batch's flips or
    instructions)."""
    state = np.random.SeedSequence([seed, step, stream]).generate_state(1, np.uint64)[0]
    return torch.Generator(device).manual_seed(int(state) >> 1)


def augment(u8b, d, generator, aimed: bool):
    """One step's batch from staged uint8 images [B, S, S, 3] and depths on
    the device: normalised images, then, unless ``aimed``, a horizontal and a
    vertical flip each with probability 1/2 for the whole batch; with
    ``aimed``, one instruction per sample and its label gathered from the
    [B, 9] depths. Returns (batch, draws): the flips [2] bool or the
    instructions [B]. No host sync."""
    x = normalize_u8(u8b)
    B = x.shape[0]
    batch = {"exif": exif_batch(B, x.device)}
    if aimed:
        g = torch.randint(0, 9, (B,), generator=generator, device=x.device)
        batch.update(images=x, guidance=g, depths=d.gather(1, g[:, None])[:, 0])
        return batch, g
    flips = torch.rand(2, generator=generator, device=x.device) < 0.5
    x = torch.where(flips[0], x.flip(2), x)
    x = torch.where(flips[1], x.flip(1), x)
    batch.update(images=x, depths=d)
    return batch, flips


def ckpt_flat(flat, args, base_flat=None):
    """The saved tree: in adapter mode the frozen base goes back verbatim
    from ``base_flat`` (so the adapter-off exact path is the --init-from
    weights bit for bit; a drift is reported), with ``--adapter-heads`` the
    trained non-backbone tensors as the ``filterpath/`` overlay; with
    ``--train-filter`` the ``__meta__/*`` provenance stamps the engines read."""
    flat = dict(flat)
    if args.adapter_rank and base_flat is not None:
        drift = 0.0
        for k, v in base_flat.items():
            if args.adapter_heads and not k.startswith("backbone/"):
                flat["filterpath/" + k] = flat[k]
                flat[k] = v
                continue
            drift = max(drift, float(np.max(np.abs(
                np.asarray(flat[k], np.float64) - np.asarray(v, np.float64)))))
        if drift != 0.0:
            print(f"  WARNING: frozen base drifted by {drift:.3e} during adapter "
                  f"training — restoring originals", flush=True)
        for k, v in base_flat.items():
            if args.adapter_heads and not k.startswith("backbone/"):
                continue
            flat[k] = v
    if args.train_filter:
        flat["__meta__/train_filter"] = np.asarray(args.train_filter)
        if args.adapter_rank:
            flat["__meta__/adapter_rank"] = np.asarray(str(args.adapter_rank))
            flat["__meta__/adapter_alpha"] = np.asarray(
                str(args.adapter_alpha or args.adapter_rank))
            flat["__meta__/adapter_targets"] = np.asarray(args.adapter_targets)
            if args.adapter_heads:
                flat["__meta__/adapter_heads"] = np.asarray("1")
    return flat


def graft_adapters(model, base_flat, seed):
    """Load ``base_flat`` into ``model`` (built with adapters), the adapter
    tensors the base lacks drawn fresh from a generator seeded ``seed``.
    Returns how many adapter tensors were grafted."""
    fresh = flat_params(model.init(torch.Generator(model.decision_head.fc0.weight.device)
                                   .manual_seed(seed)))
    new = {k: v for k, v in fresh.items()
           if k.startswith("backbone/layers/lora") and k not in base_flat}
    load_into(model, {**base_flat, **new})
    return len(new)


def held_out(model, eval_staged, ed, guided: bool):
    """(unguided AbsRel against the labels, or the 'center' column for
    aimed scenes; worst-instruction AbsRel when ``guided``, else None). Noise
    is sampled from a generator seeded 0, as the script's eval key."""
    dev = eval_staged[0].device

    def run(guidance):  # each batch's noise from a generator seeded 0
        return torch.cat([depths(model, xb, guidance, torch.Generator(dev).manual_seed(0),
                                 NoiseMode.SAMPLE)
                          for xb in eval_staged]).double().cpu().numpy()

    ar = absrel(run(None), ed[:, 0] if ed.ndim == 2 else ed)
    if not guided:
        return ar, None
    worst = max(absrel(run(gi), ed[:, gi] if ed.ndim == 2 else ed) for gi in range(9))
    return ar, worst


def main(argv=None):
    """Returns a summary: the checkpoint path, the losses, the held-out
    AbsRel before and after, the seconds, and the trained model."""
    args = parse_args(argv)

    dev = resolve_device(args.device)
    S, B = args.image_size, args.batch
    os.makedirs(args.ckpt_dir, exist_ok=True)
    out = checkpoint_name(args)

    # ------------------------------------------------------------- data ----
    gen = P.gen_procedural_aimed_u8 if args.aimed else P.gen_procedural_u8
    train_cache, eval_cache = cache_names(args)
    t0 = time.perf_counter()
    u8, labels = P.cached(train_cache, gen, args.n_images, S, args.seed)
    eu8, ed = P.cached(eval_cache, gen, args.n_eval, S, EVAL_DATA_SEED)
    data_s = time.perf_counter() - t0
    print(f"data ready in {data_s:.0f}s ({args.n_images} train + {args.n_eval} eval "
          f"@{S}²)", flush=True)

    # ------------------------------------------------------------ model ----
    vit = vit_config(args.layers, args.tiny, S)
    tf_kw = parse_token_filter(args.train_filter)
    if tf_kw:
        tf_kw["token_filter_train"] = True
    lora_kw = {}
    if args.adapter_rank:
        lora_kw = dict(use_lora=True, lora_rank=args.adapter_rank,
                       lora_alpha=args.adapter_alpha or args.adapter_rank,
                       lora_targets=tuple(args.adapter_targets.split(",")))
    model = CognitiveAimModel(arch(S, args.backbone, **tf_kw, **lora_kw),
                              attn_impl="pallas_packed", vit_cfg=vit, device=dev)
    alt_model = None
    if tf_kw and not args.adapter_rank and not args.filter_always:
        # the exact path of the sandwich, on the main model's parameters
        alt_model = CognitiveAimModel(arch(S, args.backbone), attn_impl="pallas_packed",
                                      vit_cfg=vit, device=dev)
    base_flat = None
    if args.init_from:
        base_flat = load_flat(args.init_from)[0]
        print(f"warm-start from {args.init_from}", flush=True)
        if args.adapter_rank:
            n_new = graft_adapters(model, base_flat, args.seed + 5000)
            print(f"grafted {n_new} adapter tensors (rank {args.adapter_rank}, "
                  f"targets {args.adapter_targets})", flush=True)
        else:
            load_into(model, base_flat)
    else:
        model.init(torch.Generator(dev).manual_seed(args.seed))
    cfg = TrainConfig(epochs=1, batch_size=B, steps_per_epoch=args.steps,
                      learning_rate=args.lr, freeze_backbone=False,
                      guided_training=args.guided, train_only_lora=bool(args.adapter_rank),
                      sandwich_heads=args.adapter_heads, heads_lr=args.adapter_heads_lr)
    tr = Trainer(model, cfg, output_dir=args.ckpt_dir, alt_model=alt_model)
    check_step_inputs(tr)

    # stage the whole training set on the device as uint8
    t0 = time.perf_counter()
    n_batches = args.n_images // B
    u8_dev = torch.from_numpy(u8).to(dev)
    d_dev = torch.from_numpy(np.asarray(labels, np.float32)).to(dev)
    staged = [(u8_dev[i * B:(i + 1) * B], d_dev[i * B:(i + 1) * B]) for i in range(n_batches)]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"staged {n_batches} u8 batches ({args.n_images * S * S * 3 / 1e9:.1f} GB) in "
          f"{time.perf_counter() - t0:.0f}s", flush=True)

    # held-out eval scores the EXACT path where the run has one (the filter
    # is a train-time regulariser there, not the eval subject)
    eval_model = alt_model if alt_model is not None else model
    eb = min(args.n_eval, 16)
    eval_staged = [normalize_u8(torch.from_numpy(eu8[s:s + eb]).to(dev))
                   for s in range(0, args.n_eval, eb)]
    scored = args.guided or args.aimed

    def evaluate(at):
        with torch.no_grad():  # the trainer shares the alt model's parameters
            ar, gar = held_out(eval_model, eval_staged, ed, scored)
        msg = f"  held-out AbsRel @step {at}: {ar * 100:.2f}%"
        if gar is not None:
            msg += f"  worst-instruction guided: {gar * 100:.2f}%"
        print(msg, flush=True)
        return {"step": at, "absrel": ar, "absrel_worst_instruction": gar}

    evals = [evaluate(0)]

    # ------------------------------------------------------------ train ----
    order = np.random.RandomState(args.seed + 777).permutation(
        np.tile(np.arange(n_batches), args.steps // n_batches + 1))
    losses, train_s = [], 0.0

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    seg = time.perf_counter()  # training time only: evals and saves are left out
    for step in range(args.steps):
        u8b, d = staged[order[step]]
        batch, _ = augment(u8b, d, step_generator(args.seed, step, dev, 1), args.aimed)
        logs = tr.train_step(batch, step_generator(args.seed, step, dev), fetch_logs=False,
                             alt=alt_model is not None and step % args.filter_every != 0)
        losses.append(logs["loss"])
        if step % 100 == 0 or step == args.steps - 1:
            print(f"step {step}: loss={float(logs['loss']):.4f} "
                  f"({train_s + time.perf_counter() - seg:.0f}s)", flush=True)
        if (step + 1) % args.eval_every == 0 or step == args.steps - 1:
            sync()
            train_s += time.perf_counter() - seg
            evals.append(evaluate(step + 1))
            if step < args.steps - 1:  # periodic save: a long run loses <= eval_every steps
                save_flat(out, ckpt_flat(flat_params(model), args, base_flat))
            seg = time.perf_counter()
    losses = [float(v) for v in torch.stack(losses).cpu()]
    flat = ckpt_flat(flat_params(model), args, base_flat)
    save_flat(out, flat)
    print(f"wrote {out} ({len(flat)} tensors, {train_s:.0f}s of training, "
          f"{train_s / max(args.steps, 1) * 1e3:.1f} ms a step)")
    summary = {"checkpoint": out, "law": law_of(args), "losses": losses, "evals": evals,
               "data_s": data_s, "train_s": train_s}
    if args.summary:
        with open(args.summary, "w") as f:
            json.dump({**summary, "losses": losses[::10], "loss_every": 10,
                       "step_ms": train_s / max(args.steps, 1) * 1e3,
                       "argv": list(argv) if argv is not None else None}, f, indent=1)
    return {**summary, "model": model, "trainer": tr}


if __name__ == "__main__":
    main()
