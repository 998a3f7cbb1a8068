"""The plain reference (benchmark/reference/) against the program's CPU
forward at tiny widths, through the configuration's reference module. Only
this file imports both; the reference itself imports nothing of the
program (test_bench_harness.py checks that)."""

import numpy as np
import pytest
import torch

from benchmark import inputs, spec
from benchmark.harness import tiny_config
from benchmark.reference import model as ref
from conftest import TINY

GELU = spec.reference(spec.ROOT, "vitb14_518_int8")


def test_tables_match_the_programs():
    from cognitive_aim_tpu_torch.models.guidance import _mask_table_np
    from cognitive_aim_tpu_torch.models.streams import center_bias_np, focal_pos_encoding_np
    from cognitive_aim_tpu_torch.nn.torch_interp import resize_weights

    for g in (4, 5, 37):
        want = torch.from_numpy(_mask_table_np(g).reshape(9, -1).copy())
        assert torch.equal(ref.mask_table(g, "cpu"), want)
    for n, d in ((16, 64), (1369, 768), (1369, 1024)):
        # the program's table is float32 arithmetic, the reference's float64:
        # sines of arguments up to 36 differ by a few float32 steps
        np.testing.assert_allclose(ref.focal_pos_encoding(n, d, "cpu").numpy(),
                                   focal_pos_encoding_np(n, d), atol=1e-5)
        np.testing.assert_allclose(ref.center_bias(n, "cpu").numpy(), center_bias_np(n),
                                   atol=1e-7)
    for src, dst in ((37, 4), (37, 5), (37, 40)):
        np.testing.assert_allclose(ref.bicubic_matrix(src, dst, "cpu").numpy(),
                                   resize_weights(src, dst, "bicubic"), atol=1e-6)
    assert ref.INSTRUCTIONS == __import__(
        "cognitive_aim_tpu_torch.models.guidance", fromlist=["INSTRUCTIONS"]).INSTRUCTIONS


def test_quantisation_matches_the_programs_int8_scheme():
    from cognitive_aim_tpu_torch.kernels.int8_ops import quantize_activations, quantize_weight

    g = torch.Generator().manual_seed(0)
    w = torch.randn(96, 40, generator=g)  # [in, out], as the flat layout holds it
    qw = quantize_weight(w.T)
    torch.testing.assert_close(ref.quantize(w, 8, 0), (qw["q"].float() * qw["s"][:, None]).T,
                               rtol=0, atol=0)
    x = torch.randn(7, 96, generator=g) * 3
    q, s = quantize_activations(x)
    torch.testing.assert_close(ref.quantize(x, 8, -1), q.float() * s, rtol=0, atol=0)
    q4 = ref.quantize(x[:1], 4, -1)
    assert len(torch.unique(q4 / q4.abs().max())) <= 15  # int4: 15 levels


def _program_forward(d, flat, images, exif, gidx, token_filter):
    """The program's eager int8 forward on the CPU (its plain kernel
    versions), from the same flat weights."""
    from cognitive_aim_tpu_torch.convert import load_flat_params
    from cognitive_aim_tpu_torch.core.precision import INT8_BACKBONE
    from cognitive_aim_tpu_torch.core.rng import NoiseMode
    from cognitive_aim_tpu_torch.io.preprocess import normalize_u8
    from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel
    from cognitive_aim_tpu_torch.models.config import ModelArchConfig
    from cognitive_aim_tpu_torch.nn.dinov2 import DinoV2Config

    kw = {} if token_filter is None else dict(token_filter_layer=token_filter[0],
                                               token_filter_keep=token_filter[1])
    arch = ModelArchConfig(num_iterations=d.num_iterations, focus_strength=d.focus_strength,
                           image_size=d.image, num_cameras=d.num_cameras, **kw)
    vit = DinoV2Config(**GELU.program_backbone(d))
    model = CognitiveAimModel(arch, INT8_BACKBONE, attn_impl="pallas_packed", vit_cfg=vit,
                              device="cpu")
    load_flat_params(model, flat).prepare_params()
    with torch.no_grad():
        out = model(normalize_u8(images), exif, guidance=gidx, noise_mode=NoiseMode.ZEROS)
    return {"depth": out.depth[:, 0], "confidence": out.confidence[:, 0],
            "curiosity": out.curiosity, "attention": out.attention}


@pytest.mark.parametrize("token_filter", [None, (2, 0.35)], ids=["exact", "filter2:0.35"])
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 7])
def test_reference_agrees_with_the_programs_cpu_forward(token_filter, seed):
    from benchmark import compare

    cfg = tiny_config(spec.config(spec.ROOT, spec.bench(), "vitb14_518_int8"), TINY)
    d = GELU.dims(cfg)
    _, flat = inputs.weights(GELU, d, seed, "cpu")
    assert {k: v.shape for k, v in flat.items()} == GELU.param_shapes(d)
    B = 6
    images = inputs.images_u8(B, d.image, seed, "t", "cpu")
    exif = {k: torch.from_numpy(v) for k, v in inputs.exif(B, seed, "t", d.num_cameras).items()}
    gidx = torch.from_numpy(inputs.instructions(B, seed, "t").astype(np.int64))
    got = _program_forward(d, flat, images, exif, gidx, token_filter)
    want = GELU.forward(inputs.on_device(flat, "cpu"), d, images, exif, gidx,
                        token_filter=token_filter)
    n = compare.numbers(got, want)
    # the program runs the backbone and the focal streams in bfloat16 (8
    # significant bits), the reference in float32; a rounding that moves
    # an int8 code moves the next product by one step
    assert n["depth_rel"] < 5e-3 and n["curiosity_rel"] < 5e-3, n
    assert n["confidence_abs"] < 2e-3, n
    assert n["attention_rel"] < 0.15, n
    # the guided map itself, compared directly, is the mask's softmax
    torch.testing.assert_close(got["attention"], want["attention"], rtol=0.02, atol=1e-6)
