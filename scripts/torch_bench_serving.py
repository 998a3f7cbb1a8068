"""End-to-end serving throughput of the PyTorch + CUDA port (counterpart of
scripts/bench_serving.py): JPEG files on disk -> native C++ decode (its PIL
fallback where the loader does not build) -> uint8 from pinned memory ->
the engine's compiled forward (normalisation inside its graph) -> depths.
Includes host preprocessing, unlike a device-only benchmark.

The engine is the port's ``CognitiveAimInference`` at ``--size``, 3 focal
iterations, seeded weights, sampled noise, every image guided to "center"
with the default EXIF values, as the original's jitted forward; the timed
pass is ``predict_paths_batched`` (decode of chunk i+1 overlaps the forward
of chunk i), over the whole chunks of ``--n`` images.

    python scripts/torch_bench_serving.py [--n 512] [--size 224] [--batch 64]
        [--policy int8] [--device auto|cpu]
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--policy", type=str, default="int8")
    ap.add_argument("--device", type=str, default="auto",
                    help="auto (the CUDA device; raises without one) or cpu")
    return ap.parse_args(argv)


def main(argv=None, vit_cfg=None):
    """Run the benchmark; returns its numbers. ``vit_cfg`` overrides the
    backbone size (the tests' tiny width)."""
    args = parse_args(argv)
    from PIL import Image

    import torch

    from cognitive_aim_tpu_torch.api import CognitiveAimInference
    from cognitive_aim_tpu_torch.io import native_loader as NL

    tmp = tempfile.mkdtemp(prefix="serve_bench_")
    try:
        rng = np.random.RandomState(0)
        paths = []
        base = (rng.rand(480, 640, 3) * 255).astype(np.uint8)
        for i in range(args.n):
            p = os.path.join(tmp, f"im{i}.jpg")
            if i == 0:
                Image.fromarray(base).save(p, quality=90)
            else:
                os.link(paths[0], p)
            paths.append(p)
        cfg = os.path.join(tmp, "cfg.json")  # JSON is YAML
        with open(cfg, "w") as f:
            json.dump({"cognitive_modules": ["ambient_stream", "iterative_focal_stream",
                                             "exif_prior_database"],
                       "dataset": {"image_size": args.size},
                       "focal_config": {"num_iterations": 3}}, f)
        print("native loader available:", NL.available(), file=sys.stderr)
        engine = CognitiveAimInference(cfg, None, args.device, policy=args.policy,
                                       attn_impl="pallas_packed", save_images=False,
                                       vit_cfg=vit_cfg)
        B = args.batch
        n_done = (args.n // B) * B

        def serve(chunk_paths):
            return engine.predict_paths_batched(chunk_paths, instruction="center",
                                                batch_size=B, use_exif=False)

        # warm-up: the uint8 graph's capture (the original's jit compile)
        t0 = time.perf_counter()
        serve(paths[:B])
        warm_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        out = serve(paths[:n_done])
        dt = time.perf_counter() - t0
        if not np.isfinite(np.asarray(out)).all():
            raise RuntimeError("the forward gave non-finite depths")

        print("host decode only: ", file=sys.stderr, end="")
        t1 = time.perf_counter()
        for s in range(0, n_done, B):
            NL.decode_resize_batch_u8(paths[s:s + B], args.size, args.size)
        ddt = time.perf_counter() - t1
        print(f"{n_done / ddt:.0f} img/s", file=sys.stderr)
        print(f"end-to-end serving (decode+infer, overlap-free): {n_done / dt:.0f} img/s "
              f"@{args.size}^2 batch {B}", file=sys.stderr)
        numbers = {"images": n_done, "batch": B, "size": args.size, "policy": args.policy,
                   "device": str(engine.device), "decoder": engine.last_decoder,
                   "warmup_s": warm_s, "end_to_end_img_s": n_done / dt,
                   "decode_only_img_s": n_done / ddt,
                   "graphs": None if engine.compiled is None else engine.compiled.describe()}
        if engine.device.type == "cuda":
            torch.cuda.synchronize()
        print(json.dumps(numbers, default=str))
        return numbers
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
