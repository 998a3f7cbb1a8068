"""The ViT-L configuration of the port against the JAX package, at ViT-L's
own widths: D 1024, 16 heads of 64, MLP 4096, patch 14 (``config_for("large")``
in both packages), cut to 6 blocks so that the JAX spec ``4:0.25`` runs as
written (blocks 4 and 5 after the filter point), on 98x98 images (a 7x7 grid
of 49 patches, interpolated from the 37x37 pretrain grid), batch 3.

One JAX init (``jax.random.PRNGKey(0)``, ~15 s here) is shared by every test
through an ``lru_cache`` and carried across with ``convert.load_flat_params``;
the training test takes its first two blocks. Inputs come from a numpy seed.
Where the JAX function reaches a Pallas kernel (the int8 chained block, K12),
it runs in interpret mode with ``attn_impl="pallas_packed"`` named again on
the JAX model (off a TPU the model swaps it for ``xla``); the port runs on CPU
tensors, so its kernel wrappers take their plain versions (the CUDA kernels
are held to those on the card by ``chip_smoke.py`` phase (m)).

Tolerances, with their reasons (those of the tests at small widths, but
one):
  * strict float32: ``F32_TOL`` of tests/test_torch_model.py (atol 2e-6,
    rtol 1e-5: summation order only; measured <= 8e-7 here), and at 4:0.25
    the kept set identical to JAX's, with the keep boundary's priority gap
    above 1e-5 so that the equality is not luck;
  * bfloat16 default and int8: ``BF16_TOL`` (atol 1e-2) for depth,
    confidence and attention, as ``MODEL_CASES`` of tests/test_torch_filter.py
    (measured <= 4.7e-3 here); one int8 block ``INT8_BACKBONE_TOL`` (atol
    2e-2 / rtol 5e-2), per element;
  * six chained int8 blocks: the one tolerance that differs. Per element,
    ``INT8_BACKBONE_TOL`` fails on 147 of 102,400 elements: int8 steps that
    land apart feed the next block, so the error grows with depth. They are
    held as chip_smoke.py holds 12 chained int8 blocks: RMS difference over
    RMS value within 2e-2, largest difference over largest value within 5e-2
    (``TOL_CHAIN_RMS``, ``TOL_CHAIN_MAX``; measured 1.1e-2 and 1.7e-2), and
    at most 0.5% of the elements outside ``INT8_BACKBONE_TOL``
    (``TOL_CHAIN_OUTSIDE``; measured 0.14%, fused 0.12%). Planted in the
    port's activation quantiser: floor in place of round-half-even fails the
    RMS and share bounds (2.1e-2, 5.7%); a scale 10% off on one row in 64
    fails the max and share bounds (6.3e-2, 1.2%); 1% off passes them all,
    as it passes one block's ``INT8_BACKBONE_TOL``;
  * the training step: loss and every gradient within atol 1e-5
    (tests/test_torch_train.py's ``GRAD_TOL``).
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cognitive_aim_tpu import api as JAPI
from cognitive_aim_tpu.api import flatten_tree
from cognitive_aim_tpu.core import precision as JP
from cognitive_aim_tpu.core.rng import NoiseMode as JNoise
from cognitive_aim_tpu.models import config as JCfg
from cognitive_aim_tpu.models import guidance as JG
from cognitive_aim_tpu.models.cognitive_aim import CognitiveAimModel as JModel
from cognitive_aim_tpu.nn import dinov2 as JD
from cognitive_aim_tpu.train import losses as JLS
from cognitive_aim_tpu.train.trainer import TrainConfig as JTrainConfig
from cognitive_aim_tpu.train.trainer import scalar_depth_target as j_target
from cognitive_aim_tpu_torch.api import CognitiveAimInference
from cognitive_aim_tpu_torch.convert import flat_params, load_flat_params
from cognitive_aim_tpu_torch.core import precision as TP
from cognitive_aim_tpu_torch.core.rng import NoiseMode
from cognitive_aim_tpu_torch.kernels import flash_attention as TFA
from cognitive_aim_tpu_torch.kernels import int8_block as TIB
from cognitive_aim_tpu_torch.models import config as TCfg
from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel as TModel
from cognitive_aim_tpu_torch.nn import dinov2 as TD
from cognitive_aim_tpu_torch.train.trainer import TrainConfig, Trainer

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEPTH = 6
IMG = 98
P = (IMG // 14) ** 2  # 49 patches
B = 3
SPEC = "4:0.25"
K_KEEP = round(0.25 * P)  # 12 kept patches, the fused context token beside them

F32_TOL = dict(atol=2e-6, rtol=1e-5)
BF16_TOL = dict(atol=1e-2, rtol=0.0)
INT8_BACKBONE_TOL = dict(atol=2e-2, rtol=5e-2)
GRAD_TOL = dict(atol=1e-5, rtol=0.0)
# several chained int8 blocks: an int8 activation one step apart in one
# package feeds the next block, so element errors grow with depth (at ViT-L's
# width, 2 images: RMS 5.4e-3 after one block, 1.1e-2 after six; bf16 4.6e-3
# and 7.4e-3), and after 4 blocks a few elements (25, then 147 of 102,400 at
# 6) pass INT8_BACKBONE_TOL. So the chain is held as chip_smoke.py holds 12
# chained int8 blocks at full width: RMS difference over RMS value, and the
# largest difference over the largest value; and the share of elements
# outside INT8_BACKBONE_TOL (147 and, fused, 118 of 102,400 at 6 blocks)
TOL_CHAIN_RMS = 2e-2
TOL_CHAIN_MAX = 5e-2
TOL_CHAIN_OUTSIDE = 5e-3
MIN_GAP = 1e-5  # priority gap at the keep boundary, strict float32

# the engines' config: the demo's modules, 2 focal iterations, the ViT-L backbone
CFG = {"cognitive_modules": ["ambient_stream", "iterative_focal_stream",
                             "exif_prior_database"],
       "dataset": {"image_size": IMG}, "exif_config": {"num_cameras": 5},
       "focal_config": {"num_iterations": 2}, "backbone_size": "large"}
ARCH = JCfg.resolve_model_config(CFG)

CASES = {
    # name: (JAX policy, port policy, JAX attn_impl, tolerance)
    "strict_f32": (JP.STRICT_F32, TP.STRICT_F32, "xla", F32_TOL),
    "bf16_default": (JP.DEFAULT_POLICY, TP.DEFAULT_POLICY, "xla", BF16_TOL),
    "int8": (JP.INT8_BACKBONE, TP.INT8_BACKBONE, "pallas_packed", BF16_TOL),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch thread: XLA's threads and the other test workers share the
    cores (tests/test_torch_filter.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_grad():
    """Every test runs under torch.no_grad(), as the engine serves; the
    training test turns autograd on around its step."""
    with torch.no_grad():
        yield


@pytest.fixture
def pallas_calls(monkeypatch):
    """Every ``pallas_call`` in interpret mode; lists the kernel bodies traced."""
    from jax.experimental import pallas as pl

    orig, names = pl.pallas_call, []

    def interp(kernel, *a, **kw):
        names.append(getattr(kernel, "func", kernel).__name__)
        kw["interpret"] = True
        return orig(kernel, *a, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)
    return names


@pytest.fixture
def fuse_aomlp(monkeypatch, pallas_calls):
    """``CAIM_FUSE_AOMLP=1`` for both packages, with no JAX trace from before
    the variable was set and none left behind (tests/test_torch_fused.py)."""
    monkeypatch.setenv("CAIM_FUSE_AOMLP", "1")
    jax.clear_caches()
    yield pallas_calls
    monkeypatch.delenv("CAIM_FUSE_AOMLP")
    jax.clear_caches()


def _jvit(gelu, layers=DEPTH):
    return JD.config_for("large", num_layers=layers, gelu_approx=gelu)


def _tvit(gelu, layers=DEPTH):
    return TD.config_for("large", num_layers=layers, gelu_approx=gelu)


@functools.lru_cache(maxsize=None)
def _jax_init():
    """The JAX init of ARCH at DEPTH blocks (it depends neither on the policy
    nor on the token filter); tests only read the result."""
    params = JModel(ARCH, vit_cfg=_jvit(False)).init(jax.random.PRNGKey(0))
    return params, flatten_tree(params)


def _arch(spec):
    return dataclasses.replace(ARCH, **JCfg.parse_token_filter(spec)) if spec else ARCH


def _pair(case, spec=""):
    """(JAX model, its prepared params, the port's model, prepared) on the
    shared weights."""
    jp, tp, jimpl, _ = CASES[case]
    arch = _arch(spec)
    params, flat = _jax_init()
    jm = JModel(arch, policy=jp, attn_impl=jimpl, vit_cfg=_jvit(jp.fast_gelu))
    jm.attn_impl = jimpl  # off a TPU the JAX model swaps pallas_packed for xla
    tm = TModel(TCfg.ModelArchConfig(**dataclasses.asdict(arch)), policy=tp,
                attn_impl="pallas_packed", device="cpu", vit_cfg=_tvit(tp.fast_gelu))
    load_flat_params(tm, flat)
    return jm, jm.prepare_params(params), tm.prepare_params()


def _images(n, seed=0):
    return np.random.RandomState(seed).randn(n, IMG, IMG, 3).astype(np.float32)


def _record_keep_indices(monkeypatch, module, jax_side):
    """Wrap a module's ``_keep_indices``: the list receives (priority, kept
    indices, k_keep) of every call, on the JAX side through a callback out
    of the jitted forward."""
    calls = []
    orig = module._keep_indices

    def wrapped(importance, keep_weights, k_keep, ctx_frac=0.0):
        idx = orig(importance, keep_weights, k_keep, ctx_frac)
        prio = importance if keep_weights is None else importance + 10.0 * (keep_weights - 1.0)

        def keep(p, i):
            calls.append((np.asarray(p, np.float32), np.asarray(i), k_keep))

        if jax_side:
            jax.debug.callback(keep, prio, idx, ordered=True)
        else:
            keep(prio, idx)
        return idx

    monkeypatch.setattr(module, "_keep_indices", wrapped)
    return calls


def _attention_lengths(monkeypatch):
    """The token count of every attention call of the port's backbone (K1
    on the ``pallas_packed`` route)."""
    lengths, orig = [], TD.attend

    def spy(attn_impl, q, *rest):
        lengths.append(q.shape[1])
        return orig(attn_impl, q, *rest)

    monkeypatch.setattr(TD, "attend", spy)
    return lengths


# ------------------------------------------------------------- config ----
def test_large_config_reaches_the_model_with_vit_l_shapes():
    """A ``backbone_size: large`` config gives both packages' models ViT-L:
    24 blocks, D 1024, 16 heads of 64, MLP 4096, and the port's model (built
    on the meta device: shapes only) the parameters of JAX's init, shape for
    shape and count for count."""
    jarch, tarch = JCfg.resolve_model_config(CFG), TCfg.resolve_model_config(CFG)
    assert dataclasses.asdict(tarch) == dataclasses.asdict(jarch)
    assert tarch.backbone_size == "large" and tarch.feature_dim == 1024
    jm = JModel(jarch, policy=JP.INT8_BACKBONE)
    tm = TModel(tarch, policy=TP.INT8_BACKBONE, device="meta")
    assert dataclasses.asdict(tm.vit_cfg) == dataclasses.asdict(jm.vit_cfg)
    cfg = tm.vit_cfg
    assert (cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.head_dim, cfg.mlp_dim,
            cfg.patch_size) == (24, 1024, 16, 64, 4096, 14)
    assert cfg.gelu_approx  # the int8 chained block needs the tanh GELU
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    jsizes = {"/".join(str(getattr(k, "key", k)) for k in path): int(np.prod(leaf.shape))
              for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert sum(p.numel() for p in tm.parameters()) == sum(jsizes.values())
    assert jsizes["backbone/layers/fc1/w"] == 24 * 1024 * 4096
    blk = tm.backbone.layers[0]
    assert len(tm.backbone.layers) == 24
    assert tuple(blk.qkv.weight.shape) == (3 * 1024, 1024)
    assert tuple(blk.fc1.weight.shape) == (4096, 1024)
    assert tuple(blk.fc2.weight.shape) == (1024, 4096)
    assert tuple(tm.focal_stream.streams[0].key_proj.weight.shape) == (1024, 1024)


def test_kernel_shape_rules_take_vit_l():
    """The shape rules of the kernels this configuration reaches take ViT-L's
    widths at the main path's rows (B 8 and 24 at 518: N 1370, 344 after
    4:0.25, 1369 in the focal stream): K4a's fc1 cluster split at F 4096, K12
    at (1024, 4096), the int8 GEMM's tile widths of K2 and K5 ([1024, 3072]
    in three parts), K3 ([1024, 1024]) and K4b ([4096, 1024]), K11's cluster
    at 16 heads."""
    cta, cols = TIB.fc1_cluster_shape(4096)
    assert 1 <= cta <= 8 and cta * cols == 4096
    assert TIB.attnout_mlp_shape(1024, 4096) is not None
    for b in (8, 24):
        for n in (1370, 1 + round(0.25 * 1369) + 1, 1369):
            for cols_out, parts in ((3 * 1024, 3), (1024, 1)):
                w = TIB.gemm_tile_cols(b * n, cols_out, parts)
                assert w and (cols_out // parts) % w == 0, (b, n, cols_out)
    assert TFA.out_res_cluster_size(16) >= 1


# -------------------------------------------------------- whole model ----
@pytest.mark.parametrize("guided", [False, True], ids=["unguided", "guided"])
@pytest.mark.parametrize("spec", ["", SPEC], ids=["exact", "4of0.25"])
@pytest.mark.parametrize("case", list(CASES))
def test_vit_l_model_matches_jax(case, spec, guided, pallas_calls, monkeypatch):
    """Depth, confidence and attention of the ViT-L model, exact and at
    4:0.25, unguided and guided, against the JAX model on the same weights.
    At 4:0.25 the port's K1 runs blocks 4 and 5 at the kept length (CLS, 12
    kept patches, the fused context token); in strict float32 the kept set
    is JAX's."""
    jm, jq, tm = _pair(case, spec)
    tol = CASES[case][3]
    x = _images(B, seed=17)
    g = np.asarray([0, 4, 8], np.int32) if guided else None
    jcalls = _record_keep_indices(monkeypatch, JD, jax_side=True)
    tcalls = _record_keep_indices(monkeypatch, TD, jax_side=False)
    lengths = _attention_lengths(monkeypatch)
    want = jax.jit(lambda p, im, gi: jm.apply(p, im, None, noise_mode=JNoise.ZEROS,
                                              guidance=gi))(
        jq, jnp.asarray(x), None if g is None else jnp.asarray(g))
    jax.effects_barrier()
    got = tm(torch.from_numpy(x), None, noise_mode=NoiseMode.ZEROS,
             guidance=None if g is None else torch.from_numpy(g))
    for field in ("depth", "confidence", "attention"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   err_msg=f"{case} {spec or 'exact'} {field}", **tol)
    n_full = 1 + P
    stream = [n_full] * 4 + [1 + K_KEEP + 1] * 2 if spec else [n_full] * DEPTH
    assert lengths == stream
    assert len(jcalls) == len(tcalls) == (1 if spec else 0)
    if spec:
        (jprio, jidx, k), (tprio, tidx, _) = jcalls[0], tcalls[0]
        assert k == K_KEEP and tidx.shape == (B, K_KEEP)
        if case == "strict_f32":
            s = -np.sort(-jprio, axis=1)
            assert float((s[:, k - 1] - s[:, k]).min()) > MIN_GAP, "pick another seed"
            np.testing.assert_allclose(tprio, jprio, atol=2e-6)
            np.testing.assert_array_equal(tidx, jidx)


def _first_blocks(params, n_blocks):
    """The JAX parameter tree with its first ``n_blocks`` blocks."""
    layers = jax.tree.map(lambda a: a[:n_blocks], params["backbone"]["layers"])
    return dict(params, backbone=dict(params["backbone"], layers=layers))


def _int8_blocks(n_blocks):
    """The first ``n_blocks`` int8 chained blocks of the shared weights in
    both packages on the same images, before the heads: (port, JAX) hidden
    states [2, 1 + P, 1024] as float32."""
    params = _first_blocks(_jax_init()[0], n_blocks)
    jm = JModel(ARCH, policy=JP.INT8_BACKBONE, vit_cfg=_jvit(True, layers=n_blocks))
    tm = TModel(TCfg.ModelArchConfig(**dataclasses.asdict(ARCH)), policy=TP.INT8_BACKBONE,
                attn_impl="pallas_packed", device="cpu", vit_cfg=_tvit(True, layers=n_blocks))
    load_flat_params(tm, flatten_tree(params)).prepare_params()
    x = _images(2, seed=5)
    want = JD.apply(jm.prepare_params(params)["backbone"], jnp.asarray(x), jm.vit_cfg,
                    compute_dtype=jnp.bfloat16, attn_impl="pallas_packed")
    got = tm.backbone(torch.from_numpy(x), compute_dtype=torch.bfloat16,
                      attn_impl="pallas_packed")
    assert got.shape == (2, 1 + P, 1024) and got.dtype == torch.bfloat16
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


def _assert_blocks_close(got, want, n_blocks):
    """One block: every element within INT8_BACKBONE_TOL. More blocks: the
    chain's tolerance (see TOL_CHAIN_RMS)."""
    if n_blocks == 1:
        np.testing.assert_allclose(got, want, **INT8_BACKBONE_TOL)
        return
    d = np.abs(got - want)
    rms = float(np.sqrt((d ** 2).mean() / (want ** 2).mean()))
    worst = float(d.max() / np.abs(want).max())
    lim = INT8_BACKBONE_TOL["atol"] + INT8_BACKBONE_TOL["rtol"] * np.abs(want)
    outside = float((d > lim).mean())
    assert (rms <= TOL_CHAIN_RMS and worst <= TOL_CHAIN_MAX
            and outside <= TOL_CHAIN_OUTSIDE), (rms, worst, outside)


@pytest.mark.parametrize("n_blocks", [1, DEPTH])
def test_vit_l_int8_blocks_match_jax_chained_block(n_blocks, pallas_calls):
    """The int8 chained blocks (K2 on [1024, 3072], K1 over 16 heads, K3 on
    [1024, 1024], K4a at F 4096, K4b) against JAX's chained block: one block
    element by element, the 6 blocks as a chain."""
    got, want = _int8_blocks(n_blocks)
    _assert_blocks_close(got, want, n_blocks)


@pytest.mark.parametrize("n_blocks", [1, DEPTH])
def test_vit_l_fused_block_matches_jax_fused(n_blocks, fuse_aomlp, monkeypatch):
    """Under ``CAIM_FUSE_AOMLP=1`` every int8 ViT-L block takes K12 at
    (1024, 4096) in place of K3 -> K4, in both packages, and the two agree
    as the unfused blocks do."""
    calls = {"K12": 0, "K3": 0, "K4": 0}
    for kid, name in (("K12", "int8_attnout_mlp_ln"), ("K3", "int8_out_residual"),
                      ("K4", "int8_mlp_ln")):
        def spy(*a, _orig=getattr(TIB, name), _kid=kid, **kw):
            calls[_kid] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(TIB, name, spy)
    got, want = _int8_blocks(n_blocks)
    assert "_attnout_mlp_kernel" in fuse_aomlp
    assert "_mlp_ln_kernel" not in fuse_aomlp and "_out_res_kernel" not in fuse_aomlp
    assert calls == {"K12": n_blocks, "K3": 0, "K4": 0}
    _assert_blocks_close(got, want, n_blocks)


# ------------------------------------------------------------- engine ----
def test_vit_l_engine_matches_jax_engine_int8_filtered(pallas_calls, tmp_path, monkeypatch):
    """The port's engine and the JAX engine, each built with ``vit_cfg`` at
    ViT-L's width and DEPTH blocks, int8, token filter 4:0.25, noise zeros,
    loading the same npz: depth and confidence of one image under the 9
    instructions (one guided batch of 9)."""
    from PIL import Image

    params, flat = _jax_init()
    cfg = str(tmp_path / "vit_l.json")  # JSON is YAML
    with open(cfg, "w") as f:
        json.dump(CFG, f)
    npz = str(tmp_path / "vit_l.npz")
    np.savez(npz, **flat)
    img = str(tmp_path / "scene.png")
    Image.fromarray(np.random.RandomState(3).randint(0, 256, (120, 160, 3), np.uint8)).save(img)
    # the JAX engine's own init at seed 0 is the shared init of the same arch
    # and key: taken from the cache (the npz then overwrites all of it)
    monkeypatch.setattr(JModel, "init", lambda self, key: params)
    kw = dict(policy="int8", noise_mode="zeros", save_images=False, token_filter=SPEC)
    jeng = JAPI.CognitiveAimInference(cfg, npz, attn_impl="pallas_packed", vit_cfg=_jvit(True),
                                      **kw)
    jeng.model.attn_impl = "pallas_packed"  # off a TPU it was swapped for xla
    teng = CognitiveAimInference(cfg, npz, "cpu", vit_cfg=_tvit(True), **kw)
    assert teng.model.vit_cfg.hidden_size == 1024 and teng.model.vit_cfg.num_heads == 16
    assert teng.arch.token_filter_layer == 4 and teng.arch.token_filter_keep == 0.25
    for name in teng.params:
        np.testing.assert_array_equal(teng.params[name], flat[name], err_msg=name)
    jall, tall = jeng.predict_all_instructions(img), teng.predict_all_instructions(img)
    assert set(tall) == set(jall) == set(JG.INSTRUCTIONS)
    for name in JG.INSTRUCTIONS:
        np.testing.assert_allclose(tall[name], jall[name], err_msg=name, **BF16_TOL)


# ----------------------------------------------------------- training ----
TRAIN = dict(learning_rate=3e-3, epochs=1, batch_size=4, steps_per_epoch=30,
             freeze_backbone=False, weight_decay=0.015, attention_entropy_weight=0.01,
             beta_schedule="cosine", beta_start=0.05, beta_end=1.5)


def _train_batch(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"images": rng.randn(n, IMG, IMG, 3).astype(np.float32) * 0.5,
            "depths": np.abs(rng.randn(n).astype(np.float32)) + 0.5,
            "exif": {"camera_idx": np.zeros(n, np.int32),
                     "focal_length": np.full(n, 0.25, np.float32),
                     "aperture": np.full(n, 0.127, np.float32),
                     "iso": np.full(n, 0.016, np.float32)},
            "guidance": np.arange(n, dtype=np.int32) % 9}


def _jax_loss_and_grads(jm, params, batch, cfg, kl_w):
    """The JAX trainer's loss formula (trainer.py loss_fn) on
    ``model.apply(train=True)`` with no key, and its gradients
    (tests/test_torch_train.py)."""
    images = jnp.asarray(batch["images"])
    exif = {k: jnp.asarray(v) for k, v in batch["exif"].items()}
    guidance = jnp.asarray(batch["guidance"])

    def loss(p):
        out = jm.apply(p, images, exif, guidance=guidance, rng=None, train=True,
                       curiosity_kl_weight=jnp.float32(kl_w))
        pred = out.depth[:, 0]
        target = j_target(jnp.asarray(batch["depths"]))
        total = JLS.scale_invariant_loss(pred, target, cfg.loss_lambda)
        total = total + cfg.curiosity_weight * JLS.curiosity_loss(
            out.curiosity, jnp.abs(pred - target))
        return total + cfg.attention_entropy_weight * out.aux["attention_entropy"]

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(value), flatten_tree(grads)


def test_vit_l_training_step_matches_jax(tmp_path):
    """One training step at ViT-L's width, 2 blocks (the shared init's first
    two), strict float32, guided: the port trainer's loss and every
    per-parameter gradient against ``jax.value_and_grad`` of the JAX
    trainer's loss, and the loss of ``Trainer.train_step`` against it."""
    with torch.enable_grad():
        params = _first_blocks(_jax_init()[0], 2)
        jm = JModel(ARCH, policy=JP.STRICT_F32, vit_cfg=_jvit(False, layers=2))
        tm = TModel(TCfg.ModelArchConfig(**dataclasses.asdict(ARCH)), policy=TP.STRICT_F32,
                    attn_impl="pallas_packed", device="cpu", vit_cfg=_tvit(False, layers=2))
        load_flat_params(tm, flatten_tree(params))
        batch = _train_batch(4)
        want_loss, want = _jax_loss_and_grads(jm, params, batch, JTrainConfig(**TRAIN), 0.05)
        tr = Trainer(tm, TrainConfig(**TRAIN), output_dir=str(tmp_path))
        total, _ = tr.loss(tm, tr.device_batch(batch), None, True, 0.05)
        got = torch.autograd.grad(total, list(tm.parameters()), allow_unused=True)
        np.testing.assert_allclose(float(total.detach()), want_loss, **GRAD_TOL)
        twin = TModel(tm.arch, policy=tm.policy, vit_cfg=tm.vit_cfg, device="cpu")
        with torch.no_grad():
            for p, g in zip(twin.parameters(), got):
                p.copy_(torch.zeros_like(p) if g is None else g)
        flat = flat_params(twin)
        assert set(flat) == set(want)
        assert flat["backbone/layers/fc1/w"].shape == (2, 1024, 4096)
        for k in want:
            np.testing.assert_allclose(flat[k], np.asarray(want[k]), err_msg=k, **GRAD_TOL)
        before = flat_params(tm)
        logs = tr.train_step(batch, None)
        np.testing.assert_allclose(logs["loss"], want_loss, **GRAD_TOL)
        after = flat_params(tm)
        assert np.abs(after["backbone/layers/fc1/w"] - before["backbone/layers/fc1/w"]).max() > 0
