"""The fast path's accuracy cost: int8 (and int8 + token filter) against the
strict float32 path of this package, per guidance instruction (counterpart
of scripts/policy_delta.py).

Three engines share one set of float weights, so only the numeric path
differs: ``f32`` (strict policy, ``pallas_packed``: the f32 programs of K1
and K6 on the card), ``int8`` (the int8 policy, ``pallas_packed``) and, with
``--token-filter``, ``int8+tf``. On synthetic structured scenes at the
serving shape it prints each instruction's AbsRel of depth and mean |delta
confidence| against ``f32``, and the worst instruction against the 1% parity
budget. The script's f32 engine ran the XLA attention (``attn_impl="xla"``),
which this package does not have; the f32 kernels sit within 1.2e-6 of
their plain versions.

    python -m cognitive_aim_tpu_torch.certify.policy_delta [--n 64] \\
        [--image-size 518] [--batch 8] [--checkpoint w.npz] \\
        [--token-filter 2:0.35] [--out delta.json] [--device cpu]
"""

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from cognitive_aim_tpu_torch.api import CognitiveAimInference
from cognitive_aim_tpu_torch.certify.common import exif_batch, load_flat, vit_config
from cognitive_aim_tpu_torch.io.preprocess import normalize_np
from cognitive_aim_tpu_torch.models import guidance as G

BUDGET = 0.01


def synth_images(n, size, seed=0):
    """Structured scenes (gradients, blobs, occluders), not white noise —
    exercises non-uniform attention and depth-ish statistics."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float32) / size
    imgs = np.empty((n, size, size, 3), np.float32)
    for i in range(n):
        base = (
            rng.rand() * ys + rng.rand() * xs
            + 0.3 * np.sin(2 * np.pi * (rng.rand() * 3 + 1) * xs + rng.rand())
        )
        img = np.stack([base * rng.rand(), base * rng.rand(), base * rng.rand()], -1)
        for _ in range(rng.randint(2, 6)):  # elliptical "objects"
            cy, cx = rng.rand(2) * size
            ry, rx = (0.05 + 0.2 * rng.rand(2)) * size
            mask = (((np.arange(size)[:, None] - cy) / ry) ** 2
                    + ((np.arange(size)[None, :] - cx) / rx) ** 2) < 1.0
            img[mask] = rng.rand(3)
        lo, hi = img.min(), img.max()
        imgs[i] = (img - lo) / (hi - lo + 1e-9)
    return imgs


def engine_config(image_size: int) -> dict:
    """The engines' config: the demo's modules, 6 focal iterations, 71
    cameras, as train_synth's and pretrain's checkpoints were trained."""
    return {"cognitive_modules": ["ambient_stream", "iterative_focal_stream",
                                  "exif_prior_database"],
            "dataset": {"image_size": image_size},
            "exif_config": {"num_cameras": 71},
            "focal_config": {"num_iterations": 6}}


def build_engines(image_size, checkpoint=None, *, seed=0, vit=None, token_filter="",
                  device=None, attn_impl="pallas_packed"):
    """{"f32", "int8"[, "int8+tf"]} -> CognitiveAimInference, noise 0. A
    checkpoint every engine failed to load raises (the engine itself would
    carry on with its random weights)."""
    variants = {"f32": dict(policy="f32"), "int8": dict(policy="int8")}
    if token_filter:
        variants["int8+tf"] = dict(policy="int8", token_filter=token_filter)
    want = load_flat(checkpoint)[0] if checkpoint else {}
    engines = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = os.path.join(tmp, "policy_delta.json")  # JSON is YAML
        with open(cfg_path, "w") as f:
            json.dump(engine_config(image_size), f)
        for name, kw in variants.items():
            eng = CognitiveAimInference(
                cfg_path, checkpoint, device=device or "auto", attn_impl=attn_impl,
                noise_mode="zeros", save_images=False, seed=seed, vit_cfg=vit, **kw)
            common = [k for k in want if k in eng.params and not k.startswith("filterpath/")]
            if checkpoint and (not common or any(
                    not np.array_equal(eng.params[k], want[k]) for k in common)):
                raise RuntimeError(f"engine {name} did not load {checkpoint}")
            engines[name] = eng
    return engines


def predict(engines, norm, batch):
    """-> (depths, confidences): {engine: {instruction: [n] float64}}."""
    preds = {name: {} for name in engines}
    confs = {name: {} for name in engines}
    for gi, gname in enumerate(G.INSTRUCTIONS):
        for name, eng in engines.items():
            d, c = [], []
            for s in range(0, norm.shape[0], batch):
                xb = torch.from_numpy(norm[s:s + batch]).to(eng.device)
                B = xb.shape[0]
                # the eager forward: the strict-policy runs capture no graph
                out = eng._eager(xb, exif_batch(B, eng.device),
                                 torch.full((B,), gi, dtype=torch.long, device=eng.device),
                                 eng._next_key())
                d.append(out.depth[:, 0])
                c.append(out.confidence[:, 0])
            preds[name][gname] = torch.cat(d).double().cpu().numpy()
            confs[name][gname] = torch.cat(c).double().cpu().numpy()
    return preds, confs


def tables(preds, confs):
    """{engine but f32: {"absrel": {instruction: x}, "dconf": {...}, "worst": x}}."""
    out = {}
    for name in preds:
        if name == "f32":
            continue
        absrel, dconf = {}, {}
        for g in G.INSTRUCTIONS:
            a, b = preds["f32"][g], preds[name][g]
            absrel[g] = float(np.mean(np.abs(b - a) / np.maximum(np.abs(a), 1e-6)))
            dconf[g] = float(np.mean(np.abs(confs[name][g] - confs["f32"][g])))
        out[name] = {"absrel": absrel, "dconf": dconf, "worst": max(absrel.values())}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--image-size", type=int, default=518)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--layers", type=int, default=0,
                    help="override backbone depth (0 = full ViT-B)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="a flat .npz (pretrain.py, synth_train.py) or .pth loaded "
                         "into every engine: the deltas on TRAINED weights")
    ap.add_argument("--token-filter", type=str, default="",
                    help="LAYER:KEEP or 'L1:K1,L2:K2,...': also measure int8 + "
                         "token filter against f32 (on random weights a "
                         "pessimistic bound: their CLS attention is near-uniform)")
    ap.add_argument("--out", type=str, default="",
                    help="write the tables as JSON here")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    engines = build_engines(args.image_size, args.checkpoint, seed=args.seed,
                            vit=vit_config(args.layers), token_filter=args.token_filter,
                            device=args.device)
    norm = normalize_np(synth_images(args.n, args.image_size, args.seed))
    preds, confs = predict(engines, norm, args.batch)
    result = tables(preds, confs)
    for name, t in result.items():
        print(f"\n{name} fast path vs f32, n={args.n} @ {args.image_size}^2 "
              f"(per-instruction AbsRel of depth, |dconf|):")
        for g in G.INSTRUCTIONS:
            print(f"  {g:>13s}: AbsRel={t['absrel'][g]:.5f}  |dconf|={t['dconf'][g]:.5f}")
        print(f"  worst-instruction AbsRel delta: {t['worst']:.5f} "
              f"({'within' if t['worst'] < BUDGET else 'EXCEEDS'} the 1% parity budget)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"n": args.n, "image_size": args.image_size,
                       "checkpoint": args.checkpoint, "token_filter": args.token_filter,
                       "budget": BUDGET, "tables": result}, f, indent=1)
    return result


if __name__ == "__main__":
    main()
