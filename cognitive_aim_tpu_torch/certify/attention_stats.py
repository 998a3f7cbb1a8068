"""Per-layer CLS-attention concentration of checkpoints (counterpart of
scripts/attention_stats.py).

The token filter ranks patch tokens by the next layer's CLS-attention row
(``nn/dinov2._cls_importance``), so its parity depends on how concentrated
that distribution is: near-uniform attention (random init, memorising
cells) makes the kept set quasi-arbitrary, attention concentrated on scene
structure keeps what matters. For each layer l, over a batch of eval images,
this takes the CLS distribution layer l's q and k give on its input stream,
renormalised over the patch columns, and reports

  * normalised entropy H / ln(P) (1 uniform, 0 one-hot),
  * the top-k mass for k = 1%, 5%, 10% of P,
  * the participation ratio exp(H) / P,

as an [L, 5] table per checkpoint, random init (seed 0) first. Everything
runs in float32: the blocks on ``pallas_packed`` (K1's f32 program on the
card), where the script ran the XLA attention.

    python -m cognitive_aim_tpu_torch.certify.attention_stats --checkpoint a.npz [b.npz ...] \\
        [--image-size 518] [--n 16] [--eval-source proc|synth] [--out stats.json]
"""

import argparse
import json
import os

import numpy as np
import torch
from torch import nn

from cognitive_aim_tpu_torch.certify.common import BUILD, arch, load_flat, vit_config
from cognitive_aim_tpu_torch.certify.policy_delta import synth_images
from cognitive_aim_tpu_torch.certify.procedural import gen_procedural
from cognitive_aim_tpu_torch.convert import load_flat_params
from cognitive_aim_tpu_torch.core.device import resolve_device
from cognitive_aim_tpu_torch.io.preprocess import normalize_np
from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel
from cognitive_aim_tpu_torch.nn import dinov2 as D
from cognitive_aim_tpu_torch.nn.dinov2 import BASE

COLUMNS = "ent/lnP top1% top5% top10% partic"


def build_stats_fn():
    """-> fn(backbone (a float32 ``DinoV2``, which carries its config),
    normalised images [B, S, S, 3]) -> [L, 5] per-layer [entropy_norm, top1%,
    top5%, top10%, participation] (float32, on the images' device)."""
    @torch.no_grad()
    def stats(backbone, images):
        x = backbone.embed(images, torch.float32)
        n_patches = x.shape[1] - 1
        ks = [max(1, round(n_patches * f)) for f in (0.01, 0.05, 0.10)]
        rows = []
        for blk in backbone.layers:
            imp = D._cls_importance(blk, x)  # [B, P], sums to < 1
            p = imp / imp.sum(dim=1, keepdim=True)
            ent = -(p * torch.log(p + 1e-12)).sum(dim=1)  # [B] nats
            ent_norm = ent / np.log(n_patches)
            srt = torch.sort(p, dim=1, descending=True).values
            masses = [srt[:, :k].sum(dim=1) for k in ks]
            part = torch.exp(ent) / n_patches
            rows.append(torch.stack([ent_norm.mean(), *[m.mean() for m in masses],
                                     part.mean()]))
            x = blk(x, "pallas_packed")
        return torch.stack(rows)  # [L, 5]

    return stats


def backbone_of(flat, image_size, vit=None, device=None):
    """A float32 backbone with the ``backbone/*`` tensors of a flat tree (or
    of a tree that holds the backbone alone)."""
    if not any(k.startswith("backbone/") for k in flat):
        flat = {"backbone/" + k: v for k, v in flat.items()}
    holder = nn.Module()
    holder.backbone = CognitiveAimModel(arch(image_size), vit_cfg=vit,
                                        device=device).backbone
    load_flat_params(holder, {k: v for k, v in flat.items() if k.startswith("backbone/")})
    return holder.backbone


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", type=str, nargs="*", default=[])
    ap.add_argument("--image-size", type=int, default=518)
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--eval-source", type=str, default="proc", choices=["proc", "synth"],
                    help="proc = procedural scenes (the concentrated-regime task); "
                         "synth = the certification grid's eval images")
    ap.add_argument("--seed", type=int, default=90001)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--out", type=str, default=os.path.join(BUILD, "attn_stats.json"))
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    # the script's blocks run ViT-B's own config: erf GELU, whatever the policy
    vit = vit_config(args.layers) or BASE
    if args.eval_source == "proc":
        imgs01, _ = gen_procedural(args.n, args.image_size, args.seed)
    else:
        imgs01 = synth_images(args.n, args.image_size, args.seed)
    norm = normalize_np(imgs01)
    batches = [torch.from_numpy(norm[s:s + args.batch]).to(dev)
               for s in range(0, args.n, args.batch)]
    stats_fn = build_stats_fn()

    def run(backbone):
        per = [stats_fn(backbone, xb).cpu().numpy() for xb in batches]
        return np.mean(per, axis=0)  # [L, 5]

    results = {}
    rnd = CognitiveAimModel(arch(args.image_size), vit_cfg=vit, device=dev)
    rnd.init(torch.Generator(dev).manual_seed(0))
    results["random_init"] = run(rnd.backbone).tolist()
    del rnd
    for path in args.checkpoint:
        bb = backbone_of(load_flat(path)[0], args.image_size, vit, dev)
        results[os.path.basename(path)] = run(bb).tolist()
        del bb

    print(f"\nCLS-attention concentration @{args.image_size}² "
          f"({args.eval_source} eval images, n={args.n})")
    for name, rows in results.items():
        rows = np.asarray(rows)
        print(f"\n== {name} ==  (per-layer; layer 2 is the shipping "
              f"filter's ranking layer)")
        print(f"   layer  {COLUMNS}")
        for i, r in enumerate(rows):
            mark = " <- 2:0.25 ranks here" if i == 2 else ""
            print(f"   {i:>5d}  {r[0]:.3f}  {r[1]:.3f} {r[2]:.3f} "
                  f"{r[3]:.3f}  {r[4]:.3f}{mark}")
        print(f"   mean   {rows[:, 0].mean():.3f}  {rows[:, 1].mean():.3f} "
              f"{rows[:, 2].mean():.3f} {rows[:, 3].mean():.3f}  "
              f"{rows[:, 4].mean():.3f}")
    out = {"image_size": args.image_size, "n": args.n, "eval_source": args.eval_source,
           "columns": COLUMNS.split(), "per_layer": results}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"\nwrote {args.out}")
    return out


if __name__ == "__main__":
    main()
