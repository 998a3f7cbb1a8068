"""evaluate_torch.py against evaluate.py: one checkpoint (the JAX engine's
own weights, saved as the flat npz both engines load), one validation set,
the per-instruction sweep. Both engines run the default policy (bf16
backbone) with noise 0, the port on the CPU: its metrics within 2e-2
relative of the JAX ones (both round the backbone to bf16, at their own
places: ~1e-3 in depth, tests/test_torch_model.py).
"""

import numpy as np
import pytest
import yaml

from cognitive_aim_tpu.api import CognitiveAimInference as JEngine
from cognitive_aim_tpu.api import flatten_tree
from cognitive_aim_tpu.nn.dinov2 import DinoV2Config as JVit
from cognitive_aim_tpu_torch.nn.dinov2 import DinoV2Config as TVit

VIT = dict(hidden_size=64, num_layers=2, num_heads=4, patch_size=14, pretrain_image_size=56)


@pytest.fixture(scope="module")
def val_dir(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("valdata")
    (root / "images").mkdir()
    (root / "depths").mkdir()
    rng = np.random.RandomState(0)
    for i in range(5):  # 5 samples, batch 2: a short tail batch
        Image.fromarray((rng.rand(64, 64, 3) * 255).astype(np.uint8)).save(
            root / "images" / f"im{i}.jpg")
        np.save(root / "depths" / f"im{i}_depth.npy",
                rng.rand(16, 16).astype(np.float32) * 5 + 0.5)
    return str(root)


@pytest.fixture(scope="module")
def cfg_and_ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("evalcfg")
    cfg = {
        "cognitive_modules": ["ambient_stream", "iterative_focal_stream",
                              "exif_prior_database"],
        "dataset": {"image_size": 56},
        "exif_config": {"num_cameras": 5},
        "focal_config": {"num_iterations": 2},
        "validation": {"metrics": ["rmse", "abs_rel", "delta1"]},
    }
    path = str(d / "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    je = JEngine(path, None, lookup="reference", save_images=False, noise_mode="zeros",
                 vit_cfg=JVit(**VIT))
    ckpt = str(d / "weights.npz")
    np.savez(ckpt, **flatten_tree(je.params))
    return path, ckpt


def test_eval_sweep_matches_evaluate_py(val_dir, cfg_and_ckpt):
    from evaluate import evaluate_config as j_evaluate
    from evaluate_torch import evaluate_config

    path, ckpt = cfg_and_ckpt
    instructions = (None, "center", "top-left")
    got = evaluate_config(path, val_dir, ckpt, batch_size=2, lookup="reference",
                          instructions=instructions, vit_cfg=TVit(**VIT), device="cpu")
    want = j_evaluate(path, val_dir, ckpt, batch_size=2, lookup="reference",
                      instructions=instructions, vit_cfg=JVit(**VIT))
    assert set(got) == set(instructions)
    for instr in instructions:
        assert set(got[instr]) == {"rmse", "abs_rel", "delta1", "n", "mean_confidence"}
        assert got[instr]["n"] == want[instr]["n"] == 5
        for k in ("rmse", "abs_rel", "mean_confidence"):
            np.testing.assert_allclose(got[instr][k], want[instr][k], rtol=2e-2,
                                       err_msg=f"{instr} {k}")
    # guidance is live: a guided instruction moves the metrics
    assert got["center"]["rmse"] != got[None]["rmse"]


def test_eval_cli_writes_json(val_dir, cfg_and_ckpt, tmp_path):
    import json

    import evaluate_torch

    path, ckpt = cfg_and_ckpt
    out = str(tmp_path / "res.json")
    evaluate_torch.main(["--config", path, "--data_dir", val_dir, "--checkpoint", ckpt,
                         "--device", "cpu", "--batch_size", "2", "--output", out])
    with open(out) as f:
        res = json.load(f)
    # the CLI builds the config's ViT-B: its metrics are finite numbers
    assert set(res) == {"cfg.yaml"}
    assert np.isfinite(res["cfg.yaml"]["rmse"]) and res["cfg.yaml"]["n"] == 5
