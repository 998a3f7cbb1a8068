"""End-to-end HTTP serving throughput of the PyTorch + CUDA port
(cognitive_aim_tpu_torch/serve.py; counterpart of scripts/bench_serving_http.py):
spin the server in-process, fire concurrent /predict requests (base64 JPEGs,
mixed instructions) and report sustained requests/s, with the server's own
per-stage times: host decode a request, the mean of each stage of the
server's records (``serve.stage_ms``: a request's queue wait and wake, a
batch's wait, fill, stack, the engine's lock wait, copy in, launch and
copy out, drain, reply; ``dispatch_ms``).

The server's warm-up captures its one ``max_batch`` graph before it takes
traffic (the original's compile); every batch after is one graph replay.

    python scripts/torch_bench_serving_http.py [--n 96] [--threads 16]
        [--size 224] [--policy int8] [--max-batch 16] [--token-filter 2:0.25]
        [--device auto|cpu]
"""

import argparse
import base64
import io
import json
import os
import shutil
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=96)
    ap.add_argument("--threads", type=int, default=16)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--policy", type=str, default="int8")
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--token-filter", type=str, default="")
    ap.add_argument("--device", type=str, default="auto",
                    help="auto (the CUDA device; raises without one) or cpu")
    return ap.parse_args(argv)


def main(argv=None, vit_cfg=None):
    """Run the benchmark; returns its numbers. ``vit_cfg`` overrides the
    backbone size (the tests' tiny width)."""
    args = parse_args(argv)
    import numpy as np
    from PIL import Image

    from cognitive_aim_tpu_torch.api import CognitiveAimInference
    from cognitive_aim_tpu_torch.models.guidance import INSTRUCTIONS
    from cognitive_aim_tpu_torch.serve import serve, stage_ms

    tmp = tempfile.mkdtemp(prefix="serve_bench_http_")
    try:
        cfg_path = os.path.join(tmp, "cfg.json")  # JSON is YAML
        with open(cfg_path, "w") as f:
            json.dump({"dataset": {"image_size": args.size}}, f)
        engine = CognitiveAimInference(
            cfg_path, None, args.device, policy=args.policy, attn_impl="pallas_packed",
            noise_mode="zeros", save_images=False, token_filter=args.token_filter,
            vit_cfg=vit_cfg)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = time.perf_counter()
    httpd, batcher = serve(engine, port=0, max_batch=args.max_batch, max_delay_ms=8)
    warm_s = time.perf_counter() - t0
    print(f"warmup (capture) {warm_s:.1f}s", flush=True)
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()

    rng = np.random.RandomState(0)
    bufs = []
    for _ in range(8):
        im = Image.fromarray(rng.randint(0, 255, (args.size, args.size, 3), np.uint8))
        b = io.BytesIO()
        im.save(b, format="JPEG")
        bufs.append(base64.b64encode(b.getvalue()).decode())

    url = f"http://127.0.0.1:{port}/predict"
    done, lat = [], []
    lock = threading.Lock()

    def worker(i):
        payload = json.dumps({
            "image_b64": bufs[i % len(bufs)],
            "instruction": INSTRUCTIONS[i % len(INSTRUCTIONS)],
        }).encode()
        req = urllib.request.Request(url, payload, headers={"Content-Type": "application/json"})
        t = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                out = json.loads(r.read())
        except urllib.error.HTTPError as e:
            raise RuntimeError(f"HTTP {e.code}: {e.read()!r}") from e
        assert out["depth"] > 0
        with lock:
            done.append(i)
            lat.append(time.perf_counter() - t)

    try:
        # warm one request through (first host-side paths)
        worker(0)
        done.clear()
        lat.clear()
        batcher.batches.clear()
        batcher.decode_ms.clear()

        t0 = time.perf_counter()
        idx = iter(range(args.n))

        def drain():
            while True:
                try:
                    i = next(idx)
                except StopIteration:
                    return
                worker(i)

        threads = [threading.Thread(target=drain) for _ in range(args.threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.stop()
    bt = list(batcher.batches)
    stage = stage_ms(bt)
    numbers = {"requests": len(done), "seconds": dt, "requests_per_s": len(done) / dt,
               "p50_ms": float(np.percentile(lat, 50) * 1e3),
               "p99_ms": float(np.percentile(lat, 99) * 1e3), "threads": args.threads,
               "max_batch": args.max_batch, "policy": args.policy,
               "token_filter": args.token_filter or "off", "size": args.size,
               "device": str(engine.device), "warmup_s": warm_s,
               "decode_ms": float(np.mean(batcher.decode_ms)), "batches": len(bt),
               "mean_batch": float(np.mean([b["n"] for b in bt])), **stage}
    print(f"{len(done)} requests in {dt:.2f}s = {len(done) / dt:.1f} req/s "
          f"({args.threads} client threads, max_batch={args.max_batch}, "
          f"policy={args.policy}, tf={args.token_filter or 'off'})")
    print(json.dumps(numbers))
    return numbers


if __name__ == "__main__":
    main()
