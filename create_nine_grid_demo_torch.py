"""Nine-grid spatial guidance figure tool of the PyTorch + CUDA port
(counterpart of create_nine_grid_demo.py, with the same flags).

Pass one or more --image paths and all 9 x M guided forwards run in ONE
batched forward (``CognitiveAimInference.predict_all_instructions_batch``),
then one grid figure is written per image; without --image it composes the
prediction PNGs already in --demo_results. Runs on the CUDA device unless
``--device cpu``.

    python create_nine_grid_demo_torch.py --image photo.jpg --config configs/experiment_B.yaml
"""

import argparse


def main():
    p = argparse.ArgumentParser(description="Nine-grid spatial guidance figure")
    p.add_argument("--demo_results", type=str, default="demo_results")
    p.add_argument("--output", type=str, default="figure9_nine_grid_spatial_guidance.png")
    p.add_argument("--image_stem", type=str, default="2")
    p.add_argument("--image", type=str, nargs="+",
                   help="generate the 9 predictions per image first "
                        "(one batched 9xM forward)")
    p.add_argument("--config", type=str, default="configs/experiment_B.yaml")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--device", type=str, default="auto",
                   help="auto (the CUDA device; raises without one), cuda or cpu")
    args = p.parse_args()

    from cognitive_aim_tpu_torch.utils.visualize import create_nine_grid_layout

    stems = [args.image_stem]
    if args.image:
        from pathlib import Path

        from cognitive_aim_tpu_torch.api import CognitiveAimInference

        engine = CognitiveAimInference(
            args.config, args.checkpoint, args.device, output_dir=args.demo_results
        )
        engine.predict_all_instructions_batch(args.image)
        stems = [Path(i).stem for i in args.image]

    for stem in stems:
        output = args.output
        if len(stems) > 1:
            root, dot, ext = args.output.rpartition(".")
            output = f"{root}_{stem}{dot}{ext}" if dot else f"{args.output}_{stem}"
        out = create_nine_grid_layout(args.demo_results, output, stem)
        if out is None:
            raise SystemExit(
                f"No prediction images found in {args.demo_results} for stem '{stem}'"
            )
        print(f"Nine-grid figure saved to: {out}")


if __name__ == "__main__":
    main()
