"""Inference CLI of the PyTorch + CUDA port (counterpart of demo.py, with the
same flags).

  --config --checkpoint --image --image_dir --instruction --output --device
  --all-instructions (the nine instructions in one batched forward),
  --policy (default|bf16|f32|int8), --attn (the port's attention routes),
  --lookup (reference|nested), --deterministic (zeroed sampling),
  --instructions-json, --save-json, --seed, --token-filter.

Runs on the CUDA device unless ``--device cpu``. Single-image mode defaults
the instruction to 'center'; directory mode runs unguided unless
``--instructions-json`` names an instruction for a file.

    python demo_torch.py --config configs/experiment_B.yaml --image photo.jpg
"""

import argparse
from pathlib import Path

import numpy as np

ATTN_ROUTES = ("pallas_packed", "pallas", "pallas_packed_i8qk", "plain", "plain_i8qk",
               "plain_heads")


def main():
    parser = argparse.ArgumentParser(description="Cognitive-Aim inference (PyTorch + CUDA)")
    parser.add_argument("--config", type=str, default="configs/experiment_B.yaml")
    parser.add_argument("--checkpoint", type=str,
                        default="checkpoints/cognitive_aim_model.pth")
    parser.add_argument("--image", type=str, help="Single image path")
    parser.add_argument("--image_dir", type=str, help="Image directory path")
    parser.add_argument("--instruction", type=str,
                        help="Guidance instruction (center/left/right/top/bottom/corners)")
    parser.add_argument("--output", type=str, default="inference_results.json")
    parser.add_argument("--device", type=str, default="auto",
                        help="auto (the CUDA device; raises without one), cuda or cpu")
    parser.add_argument("--all-instructions", action="store_true",
                        help="Run all 9 instructions in one batched call")
    parser.add_argument("--policy", type=str, default="default",
                        choices=["default", "bf16", "f32", "int8"])
    parser.add_argument("--attn", type=str, default="pallas_packed", choices=ATTN_ROUTES)
    parser.add_argument("--lookup", type=str, default="reference",
                        choices=["reference", "nested"],
                        help="config-key lookup semantics (see models/config.py)")
    parser.add_argument("--deterministic", action="store_true",
                        help="zero all sampling noise (reproducible outputs)")
    parser.add_argument("--instructions-json", type=str, default=None,
                        help="Directory mode: JSON file mapping image filename "
                             "(or stem) -> guidance instruction; files not "
                             "listed run unguided, like plain --image_dir")
    parser.add_argument("--save-json", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--token-filter", type=str, default="",
                        help="LAYER:KEEP opt-in approximate fast path "
                             "(e.g. 2:0.35); exact numerics when unset")
    args = parser.parse_args()

    if not args.image and not args.image_dir:
        raise ValueError("Must specify either --image or --image_dir")
    if args.image and args.image_dir:
        raise ValueError("Cannot specify both --image and --image_dir")

    from cognitive_aim_tpu_torch.api import CognitiveAimInference

    print("Initializing Cognitive-Aim inference engine (PyTorch)...")
    engine = CognitiveAimInference(
        config_path=args.config,
        checkpoint_path=args.checkpoint if Path(args.checkpoint).exists() else None,
        device=args.device,
        lookup=args.lookup,
        policy=args.policy,
        attn_impl=args.attn,
        seed=args.seed,
        noise_mode="zeros" if args.deterministic else "sample",
        token_filter=args.token_filter,
    )

    if args.image:
        if args.all_instructions:
            results9 = engine.predict_all_instructions(args.image)
            print("\n=== Nine-Instruction Inference Results ===")
            for name, (d, c) in results9.items():
                print(f"{name:>13s}: depth={d:.4f}  confidence={c:.4f}")
            return
        instruction = args.instruction if args.instruction else "center"
        depth, confidence, metadata = engine.predict(args.image, instruction)
        results = [(depth, confidence, metadata)]
        print("\n=== Inference Results ===")
        print(f"Image: {args.image}")
        print(f"Depth value: {depth:.4f}")
        print(f"Confidence: {confidence:.4f}")
        print(f"Guidance instruction: {instruction}")
        print(f"Cognitive modules: {metadata['cognitive_modules']}")
        print(f"Model status: {metadata['model_status']}")
    else:
        image_dir = Path(args.image_dir)
        exts = {".jpg", ".jpeg", ".png", ".bmp", ".tiff"}
        paths = sorted(
            str(p) for p in image_dir.iterdir()
            if p.suffix.lower() in exts
        )
        if not paths:
            raise ValueError(f"No image files found in directory {args.image_dir}")
        print(f"Found {len(paths)} images")
        instructions = None
        if args.instructions_json:
            import json

            with open(args.instructions_json, "r", encoding="utf-8") as f:
                by_name = json.load(f)
            instructions = [
                by_name.get(Path(p).name, by_name.get(Path(p).stem))
                for p in paths
            ]
            n_guided = sum(i is not None for i in instructions)
            print(f"Per-file instructions: {n_guided} guided, "
                  f"{len(paths) - n_guided} unguided")
        results = engine.predict_batch(paths, instructions)
        ok = [r for r in results if r[0] is not None]
        print("\n=== Batch Inference Results ===")
        print(f"Total images: {len(paths)}")
        print(f"Successfully processed: {len(ok)}")
        print(f"Failed: {len(paths) - len(ok)}")
        if ok:
            depths = [r[0] for r in ok]
            confs = [r[1] for r in ok]
            print(f"Depth range: {min(depths):.4f} - {max(depths):.4f}")
            print(f"Average depth: {np.mean(depths):.4f}")
            print(f"Average confidence: {np.mean(confs):.4f}")

    if args.save_json:
        engine.save_results(results, args.output)
    print("\nInference completed!")


if __name__ == "__main__":
    main()
