#!/usr/bin/env python3
"""Export the port's guided serving forward with ``torch.export``: a program
that runs with no Python model definition.

The PyTorch + CUDA port's counterpart of ``scripts/export_model.py``, with
its flags and defaults, and ``--device`` (the card unless ``cpu``):

    python scripts/torch_export_model.py --out build/cognitive_aim.pt2 \\
        [--config configs/experiment_B.yaml] [--checkpoint ckpt.npz]
        [--batch 16] [--policy int8] [--attn pallas_packed]
        [--token-filter 2:0.35] [--skip-roundtrip] [--device cpu]

Builds ``CognitiveAimInference`` (``noise_mode="zeros"``), wraps its model as
``serve(images, exif, gidx) -> (depth, confidence)`` (the serving contract:
the attention maps stay a debug surface), exports it under ``torch.no_grad()``
at a static batch, as JAX exports at a fixed B, and writes

  * ``<out>``: ``torch.export.save`` of the program: its graph, weights and
    constants (the cached guidance, focal and resize tables, on the device
    it was traced on). Every hand-written kernel is a ``caim.<op>`` node of
    the graph, not its plain arithmetic; the script prints their count by
    op;
  * ``<out>.params.npz``: the program's state dict under its own state-dict
    names (the JAX artifact's npz is keyed by its parameter tree's), bf16
    stored as float32, which is exact; ``load_program`` casts each back to
    the dtype the program holds.

Then the round trip, unless ``--skip-roundtrip``: ``load_program`` (the
consumer's side) and the live model on the same inputs, depth and
confidence within rtol 2e-5 / atol 1e-6 (on the card the same kernels run
in the same order: bit-equal).

A consumer needs the ``caim`` op registrations and nothing of the model:

    import cognitive_aim_tpu_torch.kernels   # registers the ops
    program = torch.export.load(path).module()

``load_program`` does that and loads the npz; it imports nothing else of the
package. An artifact is read back by the torch version that wrote it.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

RTOL, ATOL = 2e-5, 1e-6  # scripts/export_model.py's round trip


class Serve(torch.nn.Module):
    """``serve(images, exif, gidx) -> (depth, confidence)`` of a model."""

    def __init__(self, model, noise_mode):
        super().__init__()
        self.model, self.noise_mode = model, noise_mode

    def forward(self, images, exif, gidx):
        out = self.model(images, exif, guidance=gidx, noise_mode=self.noise_mode)
        return out.depth, out.confidence


def serving_inputs(batch: int, size: int, device, images=None):
    """(images, exif, gidx) of scripts/export_model.py: zero images unless
    given, its exif values, instruction 0 for every row."""
    if images is None:
        images = torch.zeros(batch, size, size, 3, device=device)
    exif = {"camera_idx": torch.zeros(batch, dtype=torch.long, device=device),
            "focal_length": torch.full((batch,), 50.0, device=device),
            "aperture": torch.full((batch,), 2.8, device=device),
            "iso": torch.full((batch,), 100.0, device=device)}
    return images, exif, torch.zeros(batch, dtype=torch.long, device=device)


def roundtrip_images(batch: int, size: int, device):
    """The round trip's images: ``RandomState(0).randn(B, S, S, 3) * 0.5``."""
    rng = np.random.RandomState(0)
    return torch.from_numpy(rng.randn(batch, size, size, 3).astype(np.float32) * 0.5).to(device)


def export_engine(engine, batch: int):
    """The engine's serving forward exported at ``batch``; the module is left
    with ``requires_grad`` off. One live forward first: the model's cached
    tables (guidance masks, focal and resize tables) are made on it, as real
    tensors; made during the trace they would be cached as fake ones."""
    serve = Serve(engine.model, engine.noise_mode).requires_grad_(False)
    args = serving_inputs(batch, engine.image_size, engine.device)
    with torch.no_grad():
        serve(*args)
        return torch.export.export(serve, args)


def save_params(program, path: str) -> int:
    """The program's state dict to ``path`` (npz) by its state-dict names,
    bf16 as float32. Returns the number of arrays."""
    flat = {k: (v.float() if v.dtype == torch.bfloat16 else v).detach().cpu().numpy()
            for k, v in program.state_dict.items()}
    np.savez(path, **flat)
    return len(flat)


def load_program(path: str):
    """The consumer's side: the ``caim`` op registrations, the program at
    ``path`` as a module (on the device it was exported on), and its state
    dict from ``<path>.params.npz``, each array cast to the dtype and device
    the program holds. Imports nothing of the package but
    ``cognitive_aim_tpu_torch.kernels``."""
    import cognitive_aim_tpu_torch.kernels  # noqa: F401  (registers the caim ops)

    module = torch.export.load(path).module()
    state = module.state_dict()
    with np.load(path + ".params.npz") as npz:
        if set(npz.files) != set(state):
            raise ValueError(f"{path}.params.npz does not hold the program's state dict")
        module.load_state_dict({k: torch.from_numpy(npz[k]).to(state[k].device, state[k].dtype)
                                for k in npz.files})
    return module


def main(argv=None, vit_cfg=None) -> dict:
    """Export, save, and (unless ``--skip-roundtrip``) load and compare;
    returns the numbers it printed. ``vit_cfg`` overrides the backbone's size
    (the engine's testing hook)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--config", type=str, default="configs/experiment_B.yaml")
    ap.add_argument("--checkpoint", type=str, default=None)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--policy", type=str, default="int8")
    ap.add_argument("--attn", type=str, default="pallas_packed")
    ap.add_argument("--token-filter", type=str, default="")
    ap.add_argument("--skip-roundtrip", action="store_true")
    ap.add_argument("--device", type=str, default="auto",
                    help="the card unless 'cpu' (the plain versions: no kernel runs)")
    args = ap.parse_args(argv)

    from cognitive_aim_tpu_torch.api import CognitiveAimInference
    from cognitive_aim_tpu_torch.kernels._library import op_counts

    engine = CognitiveAimInference(
        args.config, args.checkpoint, device=args.device, policy=args.policy,
        attn_impl=args.attn, noise_mode="zeros", save_images=False,
        token_filter=args.token_filter, vit_cfg=vit_cfg)
    B, S = args.batch, engine.image_size

    t0 = time.perf_counter()
    program = export_engine(engine, B)
    torch.export.save(program, args.out)
    export_s = time.perf_counter() - t0
    n_params = save_params(program, args.out + ".params.npz")
    counts = dict(sorted(op_counts(program.graph).items()))
    mb = os.path.getsize(args.out) / 1e6
    print(f"exported and serialized in {export_s:.1f}s: {args.out} ({mb:.1f} MB) + "
          f"params.npz ({n_params} arrays); device {engine.device}; caim nodes "
          + (", ".join(f"{k} {v}" for k, v in counts.items()) or "none"), flush=True)
    result = {"export_s": export_s, "artifact_mb": mb, "params": n_params, "caim_nodes": counts}
    if args.skip_roundtrip:
        return result

    t0 = time.perf_counter()
    loaded = load_program(args.out)
    result["load_s"] = time.perf_counter() - t0
    inputs = serving_inputs(B, S, engine.device, roundtrip_images(B, S, engine.device))
    with torch.no_grad():
        d0, c0 = Serve(engine.model, engine.noise_mode)(*inputs)
        d1, c1 = loaded(*inputs)
    for name, live, rt in (("depth", d0, d1), ("confidence", c0, c1)):
        np.testing.assert_allclose(rt.float().cpu().numpy(), live.float().cpu().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    result["bit_equal"] = bool(torch.equal(d0, d1) and torch.equal(c0, c1))
    print(f"roundtrip OK: the loaded artifact, rebuilt from the npz, reproduces the live "
          f"model (depth[0]={float(d0[0, 0]):.5f}; bit-equal: {result['bit_equal']})")
    return result


if __name__ == "__main__":
    main()
