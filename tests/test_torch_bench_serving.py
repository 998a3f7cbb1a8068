"""The port's serving benchmarks (scripts/torch_bench_serving.py,
scripts/torch_bench_serving_http.py) driven end to end on the CPU at a tiny
width: a handful of images through the loader and the engine, a handful of
requests through the HTTP server on loopback. The numbers are host clocks
of a CPU run and say nothing of the card; the tests check that each script
runs its path and reports what it measured."""

import os
import sys

import numpy as np
import pytest
import torch

from cognitive_aim_tpu_torch.nn.dinov2 import DinoV2Config

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import torch_bench_serving as BS  # noqa: E402
import torch_bench_serving_http as BH  # noqa: E402

TINY = DinoV2Config(hidden_size=64, num_layers=2, num_heads=4, patch_size=14,
                    pretrain_image_size=56)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bench_serving_decodes_and_serves_every_whole_chunk():
    got = BS.main(["--n", "7", "--size", "28", "--batch", "3", "--policy", "f32",
                   "--device", "cpu"], vit_cfg=TINY)
    assert got["images"] == 6 and got["batch"] == 3 and got["device"] == "cpu"
    assert got["decoder"] in ("native", "pil")
    assert got["end_to_end_img_s"] > 0 and got["decode_only_img_s"] > 0
    assert got["graphs"] is None  # the CPU engine runs eagerly


def test_bench_serving_http_coalesces_requests():
    got = BH.main(["--n", "6", "--threads", "3", "--size", "28", "--max-batch", "4",
                   "--policy", "f32", "--token-filter", "1:0.5", "--device", "cpu"],
                  vit_cfg=TINY)
    assert got["requests"] == 6 and got["requests_per_s"] > 0
    assert 1 <= got["batches"] <= 6 and 1.0 <= got["mean_batch"] <= 4.0
    assert got["token_filter"] == "1:0.5"
    assert np.isfinite([got["p50_ms"], got["p99_ms"], got["decode_ms"],
                        got["dispatch_ms"]]).all()
    # the server's records in place of the CUDA events it no longer records
    assert "device_ms" not in got
    stages = ["queue_wait_ms", "wait_ms", "fill_ms", "stack_ms", "engine_ms", "lock_wait_ms",
              "copy_in_ms", "launch_ms", "copy_out_ms", "drain_ms", "reply_ms", "wake_ms"]
    assert all(np.isfinite(got[k]) and got[k] >= 0 for k in stages), got
