"""The system under test: ``cognitive_aim_tpu_torch``'s inference engine,
built from a cell's configuration file and given the benchmark's seeded
weights (``engine.params = flat``). This module and the drivers are the
only code of the benchmark that touch the program."""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import tempfile
from typing import Dict, Tuple

import numpy as np

from benchmark import inputs

# what the benchmark may never find loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "cognitive_aim_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden
    (``cognitive_aim_tpu_torch`` is not ``cognitive_aim_tpu``)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def engine_config_path(ctx) -> str:
    """The file the engine reads: the configuration file itself, or, at a
    test's tiny widths, a copy with the tiny image size under ``TMPDIR``."""
    if ctx.tiny is None:
        return str(ctx.root / ctx.config_file)
    fd, path = tempfile.mkstemp(prefix="bench_cfg_", suffix=".json")
    with os.fdopen(fd, "w") as f:
        json.dump(ctx.cfg, f)
    ctx.cleanup.append(path)
    return path


def build(ctx, token_filter: str) -> Tuple[object, Dict[str, np.ndarray]]:
    """(engine, flat weights): the engine of the cell's configuration, with
    the token filter ``token_filter`` ("" for none), holding the weights
    drawn from the seed."""
    import time

    from cognitive_aim_tpu_torch.api import CognitiveAimInference

    t0 = time.perf_counter()
    e = ctx.cfg["engine"]
    vit_cfg = None
    if ctx.tiny is not None:  # tests: the tiny backbone of the configuration copy
        from cognitive_aim_tpu_torch.nn.dinov2 import DinoV2Config

        vit_cfg = DinoV2Config(**ctx.ref.program_backbone(ctx.dims))
    with contextlib.redirect_stdout(io.StringIO()):
        eng = CognitiveAimInference(engine_config_path(ctx), None, device=str(ctx.device),
                                    policy=e["policy"], attn_impl=e["attn_impl"],
                                    noise_mode=e["noise_mode"], save_images=False,
                                    vit_cfg=vit_cfg, token_filter=token_filter)
    t1 = time.perf_counter()
    # the sizes the parameter layout does not show (the feed-forward's width
    # it does: the layout is compared next)
    v, d = eng.model.vit_cfg, ctx.dims
    got = (v.hidden_size, v.num_layers, v.num_heads, v.patch_size, v.pretrain_image_size,
           eng.image_size, eng.arch.num_iterations)
    want = (d.hidden, d.layers, d.heads, d.patch, d.pretrain_image, d.image, d.num_iterations)
    if got != want:
        raise ValueError(f"the engine built {got}, the configuration states {want}")
    _, flat = inputs.weights(ctx.ref, d, ctx.seed, ctx.device)
    theirs = {k: tuple(np.shape(a)) for k, a in eng.params.items()}
    ours = ctx.ref.param_shapes(d)
    if theirs != ours:
        diff = sorted(set(theirs.items()) ^ set(ours.items()))
        raise ValueError(f"the engine's parameter layout differs from the reference's: {diff}")
    t2 = time.perf_counter()
    eng.params = flat
    ctx.log(f"engine built in {t1 - t0:.2f} s, weights drawn in {t2 - t1:.2f} s, "
            f"given to it in {time.perf_counter() - t2:.2f} s")
    return eng, flat
