"""The port's certification toolchain (cognitive_aim_tpu_torch/certify/)
against the JAX package's scripts (scripts/procedural_scenes.py,
policy_delta.py, train_synth_ckpt.py, pretrain_procedural.py,
attention_stats.py, delta_sweep.py, certify_filter.py), on the CPU at small
sizes.

Where a script keeps a piece of its logic inside ``main`` (checkpoint
names, ``ckpt_flat``, delta_sweep's ``measure``), the test compiles that
piece out of the script's own source and runs it beside the port's function.

Tolerances, with their reasons:
  * scene generators, ``synth_images``, the depth laws, ``_anchors_px``,
    checkpoint names, ``ckpt_flat`` and ``certify_filter``'s JSON: equal,
    bit for bit or byte for byte (numpy on both sides, or plain Python);
  * float32 depths (the strict policy): atol 1e-5, and the tables built
    from them atol 1e-5 (summation order only; the kept sets of the
    filtered strict-f32 variants are identical, checked index for index);
  * int8 depths: atol 1e-2, the port's int8 model tolerance
    (tests/test_torch_model.py): the int8 GEMMs agree to rounding, the bf16
    steps between them round at other places;
  * attention statistics: atol 1e-5 (float32 softmax, sort and sums);
  * the pretrain's augmentation: equal to numpy's normalisation and flips
    (the same float32 operations);
  * the certification guard: the JAX test's own bound, a 4% gt-metric gap.
"""

import ast
import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
sys.path.insert(0, SCRIPTS)

import policy_delta as j_policy_delta  # noqa: E402
import procedural_scenes as j_scenes  # noqa: E402
import train_synth_ckpt as j_synth  # noqa: E402

from cognitive_aim_tpu.api import CognitiveAimInference as JEngine  # noqa: E402
from cognitive_aim_tpu.api import flatten_tree as j_flatten  # noqa: E402
from cognitive_aim_tpu.api import unflatten_npz as j_unflatten  # noqa: E402
from cognitive_aim_tpu.core import precision as JP  # noqa: E402
from cognitive_aim_tpu.core.rng import NoiseMode as JNoise  # noqa: E402
from cognitive_aim_tpu.models import guidance as JG  # noqa: E402
from cognitive_aim_tpu.models.cognitive_aim import CognitiveAimModel as JModel  # noqa: E402
from cognitive_aim_tpu.models.config import ModelArchConfig as JArch  # noqa: E402
from cognitive_aim_tpu.models.config import parse_token_filter as j_parse  # noqa: E402
from cognitive_aim_tpu.nn import dinov2 as JD  # noqa: E402
from cognitive_aim_tpu_torch import api as TA  # noqa: E402
from cognitive_aim_tpu_torch.certify import attention_stats as AS  # noqa: E402
from cognitive_aim_tpu_torch.certify import common as CC  # noqa: E402
from cognitive_aim_tpu_torch.certify import delta_sweep as DS  # noqa: E402
from cognitive_aim_tpu_torch.certify import policy_delta as PD  # noqa: E402
from cognitive_aim_tpu_torch.certify import pretrain as PT  # noqa: E402
from cognitive_aim_tpu_torch.certify import procedural as P  # noqa: E402
from cognitive_aim_tpu_torch.certify import synth_train as ST  # noqa: E402
from cognitive_aim_tpu_torch.core import precision as TP  # noqa: E402
from cognitive_aim_tpu_torch.core.rng import NoiseMode  # noqa: E402
from cognitive_aim_tpu_torch.io.preprocess import normalize_np  # noqa: E402
from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel as TModel  # noqa: E402
from cognitive_aim_tpu_torch.models.config import ModelArchConfig as TArch  # noqa: E402
from cognitive_aim_tpu_torch.nn import dinov2 as TD  # noqa: E402
from cognitive_aim_tpu_torch.train.trainer import TrainConfig, Trainer  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False

F32 = dict(atol=1e-5, rtol=0.0)
INT8 = dict(atol=1e-2, rtol=0.0)
SIZE = 56  # a 4x4 patch grid
VIT = dict(hidden_size=64, num_layers=4, num_heads=4, patch_size=14, pretrain_image_size=SIZE)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny tensors: torch's default thread pool next to XLA's costs more
    than it gives."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pallas_interpret(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _script(name):
    path = os.path.join(SCRIPTS, name)
    with open(path) as f:
        return path, ast.parse(f.read())


def _main_of(tree):
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")


def _run_statements(path, body, first, last, ns):
    """Exec the statements of ``body`` from the one whose source starts with
    ``first`` through the one that starts with ``last``; returns ``ns``."""
    src = [ast.unparse(s) for s in body]
    i = next(k for k, s in enumerate(src) if s.startswith(first))
    j = next(k for k, s in enumerate(src) if k >= i and s.startswith(last))
    exec(compile(ast.Module(body=body[i:j + 1], type_ignores=[]), path, "exec"), ns)
    return ns


def _inner_function(path, tree, name, ns):
    fn = next(n for n in ast.walk(_main_of(tree))
              if isinstance(n, ast.FunctionDef) and n.name == name)
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"), ns)
    return ns[name]


# ---------------------------------------------------------- generators ----
GENERATORS = {
    "gen_procedural": lambda m, s, seed: m.gen_procedural(3, s, seed),
    "gen_procedural_u8": lambda m, s, seed: m.gen_procedural_u8(3, s, seed),
    "gen_procedural_aimed": lambda m, s, seed: m.gen_procedural_aimed(3, s, seed),
    "gen_procedural_aimed_u8": lambda m, s, seed: m.gen_procedural_aimed_u8(3, s, seed),
    "_anchors_px": lambda m, s, seed: m._anchors_px(s + seed % 7),
}


@pytest.mark.parametrize("seed", [0, 12345])
@pytest.mark.parametrize("size", [56, 64])
@pytest.mark.parametrize("name", list(GENERATORS) + ["synth_images", "LAWS"])
def test_generators_bit_for_bit(name, size, seed):
    if name == "synth_images":
        got, want = PD.synth_images(4, size, seed), j_policy_delta.synth_images(4, size, seed)
    elif name == "LAWS":
        imgs = j_policy_delta.synth_images(4, size, seed)
        assert sorted(ST.LAWS) == sorted(j_synth.LAWS)
        got = [ST.LAWS[k](imgs) for k in sorted(ST.LAWS)]
        want = [j_synth.LAWS[k](imgs) for k in sorted(j_synth.LAWS)]
    else:
        got, want = GENERATORS[name](P, size, seed), GENERATORS[name](j_scenes, size, seed)
    got, want = (got, want) if isinstance(got, (tuple, list)) else ((got,), (want,))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_scene_cache_round_trip(tmp_path):
    path = str(tmp_path / "c" / "train.npz")
    a = P.cached(path, P.gen_procedural_u8, 2, 28, 3)
    assert os.path.exists(path)
    b = P.cached(path, lambda *a: pytest.fail("regenerated a cached set"), 2, 28, 3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


# --------------------------------------------------- checkpoint names ----
PRETRAIN_FLAGS = [
    [], ["--guided"], ["--aimed", "--seed", "3"], ["--image-size", "224", "--steps", "200"],
    ["--train-filter", "2:0.35", "--init-from", "x.npz"],
    ["--train-filter", "1:0.6,2:0.3@f4", "--filter-every", "4", "--init-from", "x.npz"],
    ["--train-filter", "2:0.25@p", "--init-from", "x.npz", "--adapter-rank", "16"],
    ["--train-filter", "2:0.25@p", "--init-from", "x.npz", "--adapter-rank", "8",
     "--adapter-heads", "--filter-every", "3"],
    ["--train-filter", "2:0.35", "--filter-always", "--backbone", "large"],
    ["--guided", "--backbone", "large", "--n-images", "64", "--n-eval", "8"],
]


@pytest.mark.parametrize("flags", PRETRAIN_FLAGS, ids=lambda f: " ".join(f) or "default")
def test_pretrain_checkpoint_and_cache_names_match_the_script(flags):
    args = PT.parse_args(flags + ["--ckpt-dir", "ck", "--data-cache", "dc"])
    path, tree = _script("pretrain_procedural.py")
    body = _main_of(tree).body
    ns = _run_statements(path, body, "law = ", "out = os.path.join(", dict(
        args=args, os=os, S=args.image_size, gen_procedural_aimed_u8=None,
        gen_procedural_u8=None))
    assert PT.checkpoint_name(args) == ns["out"]
    assert PT.law_of(args) == ns["law"]
    _run_statements(path, body, "cache = ", "cache = ", ns)
    _run_statements(path, body, "ecache = ", "ecache = ", ns)
    assert PT.cache_names(args) == (ns["cache"], ns["ecache"])


SWEEP_FLAGS = [
    [], ["--image-size", "518", "--steps", "3000"], ["--train-filter", "2:0.35"],
    ["--train-filter", "2:0.35@p", "--train-filter-mode", "alternate"],
    ["--train-filter", "2:0.25@p", "--adapter-rank", "16"],
    ["--train-filter", "2:0.25@p", "--adapter-rank", "8", "--adapter-heads"],
    ["--train-guided", "--backbone", "large"],
    ["--train-filter", "1:0.6,2:0.3", "--train-filter-mode", "alternate", "--train-guided"],
]


@pytest.mark.parametrize("flags", SWEEP_FLAGS, ids=lambda f: " ".join(f) or "default")
def test_delta_sweep_checkpoint_names_match_the_script(flags):
    args = DS.parse_args(flags + ["--ckpt-dir", "ck"])
    path, tree = _script("delta_sweep.py")
    loop = next(n for n in _main_of(tree).body if isinstance(n, ast.For)
                and ast.unparse(n.iter) == "itertools.product(seeds, laws)")
    for seed, law in ((0, "procg"), (2, "center")):
        ns = _run_statements(path, loop.body, "tf_tag = ''", "legacy = ",
                             dict(args=args, os=os, seed=seed, law=law))
        assert DS.checkpoint_paths(args, seed, law) == (ns["ckpt"], ns["legacy"])


def test_pretrain_name_is_the_one_delta_sweep_measures():
    pa = PT.parse_args(["--guided", "--steps", "200", "--image-size", "224", "--ckpt-dir", "d"])
    da = DS.parse_args(["--measure-only", "--steps", "200", "--image-size", "224",
                        "--ckpt-dir", "d"])
    assert PT.checkpoint_name(pa) == DS.checkpoint_paths(da, 0, "procg")[0]


# ------------------------------------------------------ tiny weights ----
@functools.lru_cache(maxsize=None)
def _jax_weights(seed=0):
    """JAX init of the certification arch at the tiny width: (JAX vit, JAX
    params, flat interchange)."""
    jvit = JD.DinoV2Config(**VIT)
    jm = JModel(JArch(num_iterations=6, image_size=SIZE, freeze_backbone=False,
                      use_lora=False), vit_cfg=jvit)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed))  # eager init dispatches op by op
    return jvit, params, j_flatten(params)


def _tvit():
    return TD.DinoV2Config(**VIT)


def _norm_scenes(n, seed):
    imgs, gt = P.gen_procedural(n, SIZE, seed)
    return normalize_np(imgs), gt


def test_attention_stats_match_build_stats_fn():
    path, tree = _script("attention_stats.py")
    jvit, params, flat = _jax_weights()
    j_stats = _inner_like_module(path, tree, "build_stats_fn")(jvit)
    x, _ = _norm_scenes(4, 7)
    want = np.asarray(j_stats(params["backbone"], jnp.asarray(x)))
    bb = AS.backbone_of(flat, SIZE, _tvit(), "cpu")
    got = AS.build_stats_fn()(bb, torch.from_numpy(x)).numpy()
    assert got.shape == (VIT["num_layers"], 5)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # a backbone-only tree (no 'backbone/' prefix) loads the same weights
    bare = {k[len("backbone/"):]: v for k, v in flat.items() if k.startswith("backbone/")}
    got2 = AS.build_stats_fn()(AS.backbone_of(bare, SIZE, _tvit(), "cpu"),
                               torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got2, got)


def _inner_like_module(path, tree, name):
    """A top-level function of a script, compiled alone (its imports run
    inside it)."""
    ns = {"np": np}
    exec(compile(ast.Module(body=[n for n in tree.body if isinstance(n, ast.FunctionDef)
                                  and n.name == name], type_ignores=[]), path, "exec"), ns)
    return ns[name]


# ------------------------------------------------------------ measure ----
def _record_keep_indices(monkeypatch, module, jax_side):
    """Every kept-index selection of ``module``'s token filter, in call order."""
    calls = []
    orig = module._keep_indices

    def wrapped(importance, keep_weights, k_keep, ctx_frac=0.0):
        idx = orig(importance, keep_weights, k_keep, ctx_frac)
        if jax_side:
            jax.debug.callback(lambda i: calls.append(np.asarray(i)), idx, ordered=True)
        else:
            calls.append(idx.numpy())
        return idx

    monkeypatch.setattr(module, "_keep_indices", wrapped)
    return calls


def _jax_fwd(m, B):
    exif = {k: jnp.asarray(v) for k, v in CC.exif_numpy(B).items()}
    return jax.jit(lambda p, x, g: m.apply(p, x, exif, guidance=g, rng=jax.random.PRNGKey(0),
                                           noise_mode=JNoise.ZEROS))


def _jax_measure(specs, variant_policy, params_fast, params_f32, batches, gt, f32_fwd,
                 include_unguided=True):
    """delta_sweep.py's own ``measure``, compiled out of its main, on JAX
    models: the strict f32 exact path and the variants under
    ``variant_policy``."""
    path, tree = _script("delta_sweep.py")
    jvit = JD.DinoV2Config(**VIT)
    variants = {s: JModel(JArch(num_iterations=6, image_size=SIZE, freeze_backbone=False,
                                use_lora=False, **j_parse(s)), policy=variant_policy,
                          attn_impl="pallas_packed", vit_cfg=jvit) for s in specs}
    fwds = {"f32": f32_fwd}
    fwds.update({s: _jax_fwd(m, batches[0].shape[0]) for s, m in variants.items()})

    class Args:
        pass

    args = Args()
    args.include_unguided = include_unguided
    measure = _inner_function(path, tree, "measure", dict(
        G=JG, jnp=jnp, np=np, args=args, fwds=fwds, variants=variants, eval_dev=batches,
        EB=batches[0].shape[0]))
    # each variant prepared under its own policy (the script used the
    # training model's prepare_params: see the test after next)
    table, gt_table = measure(params_f32, variants[specs[0]].prepare_params(params_fast), gt,
                              ev=[jnp.asarray(b) for b in batches])
    return table, gt_table


@pytest.fixture(scope="module")
def measure_inputs():
    jvit, params, flat = _jax_weights()
    x, gt = _norm_scenes(8, DS.EVAL_SEED)
    batches = [x[:4], x[4:]]
    f32_model = JModel(JArch(num_iterations=6, image_size=SIZE, freeze_backbone=False,
                             use_lora=False), policy=JP.STRICT_F32, attn_impl="xla",
                       vit_cfg=jvit)
    return params, flat, batches, gt, _jax_fwd(f32_model, 4)


def _port_measure(flat, specs, batches, gt, policy):
    return DS.measure(flat, flat, specs, [torch.from_numpy(b) for b in batches], gt=gt,
                      gnames=DS.instruction_names(True), eval_size=SIZE, vit=_tvit(),
                      policy=policy, device="cpu")


def test_measure_f32_variants_match_jax_with_identical_kept_sets(measure_inputs, monkeypatch):
    params, flat, batches, gt, f32_fwd = measure_inputs
    specs = ["2:0.35", "2:0.25@p"]
    j_calls = _record_keep_indices(monkeypatch, JD, True)
    jt, jgt = _jax_measure(specs, JP.STRICT_F32, params, params, batches, gt, f32_fwd)
    jax.effects_barrier()
    t_calls = _record_keep_indices(monkeypatch, TD, False)
    tt, tgt, depths = _port_measure(flat, specs, batches, gt, "f32")
    gnames = DS.instruction_names(True)
    # JAX loops instruction -> model -> batch, the port model -> instruction -> batch
    n_b = len(batches)
    j_keyed = {(s, g, b): j_calls[(gi * len(specs) + si) * n_b + b]
               for gi, g in enumerate(gnames) for si, s in enumerate(specs) for b in range(n_b)}
    t_keyed = {(s, g, b): t_calls[(si * len(gnames) + gi) * n_b + b]
               for si, s in enumerate(specs) for gi, g in enumerate(gnames) for b in range(n_b)}
    assert len(j_calls) == len(t_calls) == len(j_keyed)
    for key, idx in j_keyed.items():
        np.testing.assert_array_equal(t_keyed[key], idx, err_msg=str(key))
    for spec in specs:
        for g in gnames:
            np.testing.assert_allclose(tt[spec][g], jt[spec][g], **F32)
    for name in jgt:
        for g in gnames:
            np.testing.assert_allclose(tgt[name][g], jgt[name][g], **F32)
    assert set(depths) == {"f32", *specs}


def test_measure_int8_variant_matches_jax_prepared_under_its_policy(measure_inputs,
                                                                    pallas_interpret):
    params, flat, batches, gt, f32_fwd = measure_inputs
    jt, jgt = _jax_measure(["2:0.35"], JP.INT8_BACKBONE, params, params, batches, gt,
                           f32_fwd, include_unguided=False)
    tt, tgt, depths = _port_measure(flat, ["2:0.35"], batches, gt, "int8")
    for g in JG.INSTRUCTIONS:
        np.testing.assert_allclose(tgt["f32"][g], jgt["f32"][g], **F32)
        np.testing.assert_allclose(tgt["2:0.35"][g], jgt["2:0.35"][g], **INT8)
        np.testing.assert_allclose(tt["2:0.35"][g], jt["2:0.35"][g], **INT8)


def test_jax_delta_sweep_int8_variants_ran_bf16_and_the_port_runs_int8(measure_inputs):
    """delta_sweep.py prepares the int8 variants' weights with the training
    model's prepare_params, whose default policy returns the tree as it is:
    its "int8" variant then equals the default-policy (bf16) filtered model
    bit for bit. The port prepares each variant under its own policy."""
    params, flat, batches, gt, _ = measure_inputs
    jvit = JD.DinoV2Config(**VIT)
    arch = JArch(num_iterations=6, image_size=SIZE, freeze_backbone=False, use_lora=False)
    filt = dataclasses.replace(arch, **j_parse("2:0.35"))
    train_model = JModel(arch, attn_impl="pallas_packed", vit_cfg=jvit)  # delta_sweep.py:235
    p_int8 = train_model.prepare_params(params)  # delta_sweep.py:485
    assert p_int8 is params
    int8_variant = JModel(filt, policy=JP.INT8_BACKBONE, attn_impl="pallas_packed",
                          vit_cfg=jvit)
    bf16_filtered = JModel(filt, policy=JP.DEFAULT_POLICY, attn_impl="pallas_packed",
                           vit_cfg=jvit)
    g = jnp.arange(4, dtype=jnp.int32) % 9
    got = _jax_fwd(int8_variant, 4)(p_int8, jnp.asarray(batches[0]), g).depth
    want = _jax_fwd(bf16_filtered, 4)(params, jnp.asarray(batches[0]), g).depth
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    # the port: every block of its int8 variant is quantised, and its depths
    # are not the bf16 filtered model's
    m = DS.loaded(DS.variant_model("2:0.35", SIZE, vit=_tvit(), device="cpu"), flat)
    assert all(blk.quantized for blk in m.backbone.layers)
    bf = DS.loaded(DS.variant_model("2:0.35", SIZE, vit=_tvit(), policy="default",
                                    device="cpu"), flat)
    x, gv = torch.from_numpy(batches[0]), torch.arange(4) % 9
    assert not torch.equal(CC.depths(m, x, gv), CC.depths(bf, x, gv))
    np.testing.assert_allclose(CC.depths(bf, x, gv).numpy(), np.asarray(want)[:, 0], **INT8)


# ------------------------------------------------------- policy_delta ----
def test_policy_delta_tables_match_jax_engines(tmp_path, pallas_interpret):
    """The port's engines and tables against the JAX script's engines
    (strict f32 on XLA, int8, int8 + filter) on one checkpoint."""
    _, params, flat = _jax_weights()
    ckpt = str(tmp_path / "w.npz")
    np.savez(ckpt, **flat)
    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as f:
        json.dump(PD.engine_config(SIZE), f)
    jvit = JD.DinoV2Config(**VIT)
    jkw = dict(noise_mode="zeros", save_images=False, seed=0, vit_cfg=jvit)
    jeng = {"f32": JEngine(cfg, ckpt, policy="f32", attn_impl="xla", **jkw),
            "int8": JEngine(cfg, ckpt, policy="int8", attn_impl="pallas_packed", **jkw),
            "int8+tf": JEngine(cfg, ckpt, policy="int8", attn_impl="pallas_packed",
                               token_filter="2:0.35", **jkw)}
    norm = normalize_np(PD.synth_images(4, SIZE, 0))
    exif = {k: jnp.asarray(v) for k, v in CC.exif_numpy(4).items()}
    jpreds = {n: {} for n in jeng}
    jconfs = {n: {} for n in jeng}
    for gi, g in enumerate(JG.INSTRUCTIONS):  # policy_delta.py:117-126
        for n, e in jeng.items():
            out = e._guided(e.params, jnp.asarray(norm), exif, jnp.full((4,), gi, jnp.int32),
                            jax.random.PRNGKey(0))
            jpreds[n][g] = np.asarray(out.depth[:, 0], np.float64)
            jconfs[n][g] = np.asarray(out.confidence[:, 0], np.float64)
    engines = PD.build_engines(SIZE, ckpt, vit=_tvit(), token_filter="2:0.35", device="cpu")
    preds, confs = PD.predict(engines, norm, 4)
    for g in JG.INSTRUCTIONS:
        np.testing.assert_allclose(preds["f32"][g], jpreds["f32"][g], **F32)
        for n in ("int8", "int8+tf"):
            np.testing.assert_allclose(preds[n][g], jpreds[n][g], **INT8)
    got, want = PD.tables(preds, confs), PD.tables(jpreds, jconfs)
    for n in ("int8", "int8+tf"):
        for g in JG.INSTRUCTIONS:
            np.testing.assert_allclose(got[n]["absrel"][g], want[n]["absrel"][g], **INT8)
    assert got["int8"]["worst"] < PD.BUDGET


def test_policy_delta_refuses_a_checkpoint_it_did_not_load(tmp_path):
    _, _, flat = _jax_weights()
    bad = {k: v for k, v in flat.items()}
    bad["backbone/pos_embed"] = np.zeros((1, 5, VIT["hidden_size"]), np.float32)
    ckpt = str(tmp_path / "bad.npz")
    np.savez(ckpt, **bad)
    with pytest.raises(RuntimeError, match="did not load"):
        PD.build_engines(SIZE, ckpt, vit=_tvit(), device="cpu")


# ----------------------------------------------------------- pretrain ----
def test_augment_matches_numpy():
    rng = np.random.RandomState(4)
    u8 = rng.randint(0, 256, (6, 28, 28, 3)).astype(np.uint8)
    d = rng.rand(6).astype(np.float32) + 0.5
    norm = normalize_np(u8.astype(np.float32) / 255.0)
    seen = set()
    for step in range(12):
        g = PT.step_generator(0, step, "cpu", 1)
        batch, flips = PT.augment(torch.from_numpy(u8), torch.from_numpy(d), g, aimed=False)
        want = norm
        if flips[0]:
            want = want[:, :, ::-1]
        if flips[1]:
            want = want[:, ::-1]
        np.testing.assert_array_equal(batch["images"].numpy(), want)
        np.testing.assert_array_equal(batch["depths"].numpy(), d)
        seen.add(tuple(bool(f) for f in flips))
        for k, v in CC.exif_numpy(6).items():
            np.testing.assert_array_equal(batch["exif"][k].numpy(), v)
    assert len(seen) == 4  # every flip combination occurs
    d9 = rng.rand(6, 9).astype(np.float32)
    batch, gidx = PT.augment(torch.from_numpy(u8), torch.from_numpy(d9),
                             PT.step_generator(0, 1, "cpu", 1), aimed=True)
    gi = gidx.numpy()
    np.testing.assert_array_equal(batch["images"].numpy(), norm)  # no flips when aimed
    np.testing.assert_array_equal(batch["depths"].numpy(), d9[np.arange(6), gi])
    np.testing.assert_array_equal(batch["guidance"].numpy(), gi)
    assert gi.min() >= 0 and gi.max() < 9


CKPT_FLAT_CASES = {
    "plain": [],
    "train_filter": ["--train-filter", "2:0.35", "--init-from", "b.npz"],
    "adapters": ["--train-filter", "2:0.25@p", "--init-from", "b.npz", "--adapter-rank", "4"],
    "adapter_heads": ["--train-filter", "2:0.25@p", "--init-from", "b.npz",
                      "--adapter-rank", "4", "--adapter-alpha", "8", "--adapter-heads",
                      "--adapter-targets", "qkv,fc1"],
}


@pytest.mark.parametrize("case", list(CKPT_FLAT_CASES))
def test_ckpt_flat_matches_the_script(case, capsys):
    args = PT.parse_args(CKPT_FLAT_CASES[case])
    rng = np.random.RandomState(1)
    base = {"backbone/layers/q/w": rng.randn(2, 4, 4).astype(np.float32),
            "backbone/cls_token": rng.randn(1, 1, 4).astype(np.float32),
            "fusion/fc0/w": rng.randn(4, 4).astype(np.float32),
            "decision_head/fc0/b": rng.randn(1).astype(np.float32)}
    trained = {k: v + np.float32(1e-3) for k, v in base.items()}
    trained["backbone/layers/lora_B"] = rng.randn(2, 4, 4).astype(np.float32)
    path, tree = _script("pretrain_procedural.py")
    j_ckpt_flat = _inner_function(path, tree, "ckpt_flat", dict(
        args=args, base_flat=base, flatten_tree=j_flatten, jax=jax, np=np))
    want = j_ckpt_flat(trained)
    want_out = capsys.readouterr().out
    got = PT.ckpt_flat(trained, args, base)
    assert capsys.readouterr().out == want_out  # the drift warning, where there is one
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    if args.adapter_rank:
        assert "drifted" in want_out
        for k, v in base.items():
            if k.startswith("backbone/") or not args.adapter_heads:
                np.testing.assert_array_equal(got[k], v)  # the base, bit for bit
    if args.adapter_heads:
        np.testing.assert_array_equal(got["filterpath/fusion/fc0/w"], trained["fusion/fc0/w"])


TINY_RUN = ["--tiny", "--layers", "2", "--device", "cpu", "--steps", "4", "--n-images", "16",
            "--batch", "4", "--image-size", "28", "--n-eval", "4", "--eval-every", "2"]


@pytest.fixture(scope="module")
def pretrain_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("pretrain")
    dirs = ["--ckpt-dir", str(root / "ck"), "--data-cache", str(root / "data")]
    base = PT.main(TINY_RUN + dirs)  # the plain run: every other mode starts from it
    return dirs, base


PRETRAIN_MODES = {
    "guided": ["--guided"],
    "aimed": ["--aimed"],
    "train_filter_alternate": ["--train-filter", "1:0.5", "--init-from", None],
    "train_filter_every_3": ["--train-filter", "1:0.5@p", "--filter-every", "3",
                             "--init-from", None],
    "adapters_with_init_from": ["--train-filter", "1:0.5", "--init-from", None,
                                "--adapter-rank", "4", "--adapter-heads"],
}


def test_pretrain_main_plain(pretrain_dirs):
    _, base = pretrain_dirs
    assert os.path.basename(base["checkpoint"]) == "s0_proc_4_i28.npz"
    assert all(np.isfinite(base["losses"])) and len(base["losses"]) == 4
    assert [e["step"] for e in base["evals"]] == [0, 2, 4]
    assert base["evals"][0]["absrel_worst_instruction"] is None
    flat, meta = CC.load_flat(base["checkpoint"])
    assert meta == {}
    np.testing.assert_array_equal(flat["fusion/fc0/w"],
                                  base["model"].fusion.fc0.weight.detach().numpy().T)


@pytest.mark.parametrize("mode", list(PRETRAIN_MODES))
def test_pretrain_main_modes(mode, pretrain_dirs, monkeypatch, tmp_path):
    dirs, base = pretrain_dirs
    flags = [base["checkpoint"] if f is None else f for f in PRETRAIN_MODES[mode]]
    alts = []
    orig = Trainer.train_step

    def spy(self, batch, generator=None, fetch_logs=True, alt=None):
        alts.append(alt)
        return orig(self, batch, generator, fetch_logs, alt)

    monkeypatch.setattr(Trainer, "train_step", spy)
    out = PT.main(TINY_RUN + dirs + flags)
    args = PT.parse_args(TINY_RUN + dirs + flags)
    assert out["checkpoint"] == PT.checkpoint_name(args) and os.path.exists(out["checkpoint"])
    assert all(np.isfinite(out["losses"]))
    flat, meta = CC.load_flat(out["checkpoint"])
    if mode in ("guided", "aimed"):
        assert out["evals"][-1]["absrel_worst_instruction"] is not None
        assert alts == [False] * 4
    if mode.startswith("train_filter"):
        every = args.filter_every
        assert alts == [s % every != 0 for s in range(4)]
        assert meta == {"train_filter": args.train_filter}
    if mode == "adapters_with_init_from":
        assert alts == [False] * 4  # the filter on every step, no exact path
        assert meta["adapter_rank"] == "4" and meta["adapter_heads"] == "1"
        base_flat = CC.load_flat(base["checkpoint"])[0]
        for k, v in base_flat.items():
            np.testing.assert_array_equal(flat[k], v)  # the frozen base, bit for bit
        assert any(k.startswith("backbone/layers/lora") for k in flat)
        assert any(k.startswith("filterpath/") for k in flat)
        # the port's engine reads the stamps: a filtered engine takes the overlay and
        # folds the adapters, an exact engine serves the base
        cfg = str(tmp_path / "cfg.json")
        with open(cfg, "w") as f:
            json.dump(PD.engine_config(28), f)
        monkeypatch.setenv("CAIM_REQUIRE_FILTER_STAMP", "1")
        kw = dict(device="cpu", noise_mode="zeros", save_images=False,
                  vit_cfg=CC.vit_config(2, True, 28))
        fast = TA.CognitiveAimInference(cfg, out["checkpoint"], token_filter="1:0.5", **kw)
        np.testing.assert_array_equal(fast.params["fusion/fc0/w"],
                                      flat["filterpath/fusion/fc0/w"])
        assert not any("lora" in k for k in fast.params)
        assert not np.array_equal(fast.params["backbone/layers/q/w"],
                                  base_flat["backbone/layers/q/w"])  # folded
        exact = TA.CognitiveAimInference(cfg, out["checkpoint"], **kw)
        np.testing.assert_array_equal(exact.params["backbone/layers/q/w"],
                                      base_flat["backbone/layers/q/w"])
        np.testing.assert_array_equal(exact.params["fusion/fc0/w"], base_flat["fusion/fc0/w"])


def test_cross_load_port_checkpoint(pretrain_dirs, tmp_path, monkeypatch):
    """A port-written, filter-stamped checkpoint: JAX's unflatten_npz reads
    it into a JAX model that gives the port's depths; the port's engine
    accepts its stamp and refuses another spec's."""
    dirs, base = pretrain_dirs
    out = PT.main(TINY_RUN + dirs + ["--train-filter", "1:0.5", "--init-from",
                                     base["checkpoint"], "--steps", "2"])
    jvit = JD.DinoV2Config(hidden_size=64, num_layers=2, num_heads=4, patch_size=14,
                           pretrain_image_size=28)
    with np.load(out["checkpoint"]) as z:
        jparams = j_unflatten(z)
    jm = JModel(JArch(num_iterations=6, image_size=28, freeze_backbone=False, use_lora=False),
                policy=JP.STRICT_F32, attn_impl="xla", vit_cfg=jvit)
    x = normalize_np(P.gen_procedural(4, 28, 5)[0])
    g = np.arange(4, dtype=np.int32)
    jexif = {k: jnp.asarray(v) for k, v in CC.exif_numpy(4).items()}
    want = np.asarray(jm.apply(jparams, jnp.asarray(x), jexif, guidance=jnp.asarray(g),
                               noise_mode=JNoise.ZEROS).depth[:, 0])
    tvit = CC.vit_config(2, True, 28)
    tm = DS.loaded(DS.f32_model(28, vit=tvit, device="cpu"), CC.load_flat(out["checkpoint"])[0])
    got = CC.depths(tm, torch.from_numpy(x), torch.from_numpy(g).long()).numpy()
    np.testing.assert_allclose(got, want, **F32)

    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as f:
        json.dump(PD.engine_config(28), f)
    monkeypatch.setenv("CAIM_REQUIRE_FILTER_STAMP", "1")
    kw = dict(device="cpu", noise_mode="zeros", save_images=False, vit_cfg=tvit)
    eng = TA.CognitiveAimInference(cfg, out["checkpoint"], token_filter="1:0.5", **kw)
    np.testing.assert_array_equal(eng.params["fusion/fc0/w"],
                                  CC.load_flat(out["checkpoint"])[0]["fusion/fc0/w"])
    with pytest.raises(TA.CheckpointRefused):
        TA.CognitiveAimInference(cfg, out["checkpoint"], token_filter="1:0.4", **kw)


def test_trainer_alt_model_shares_the_main_parameters(tmp_path):
    """The alternation's exact steps train the main model's parameters
    through the per-block recompute: two alt steps equal two steps of a
    trainer on the exact model alone."""
    vit = CC.vit_config(2, True, 28)
    filt = TModel(CC.arch(28, token_filter_layer=1, token_filter_keep=0.5,
                          token_filter_train=True), vit_cfg=vit, device="cpu")
    filt.init(torch.Generator().manual_seed(0))
    exact = TModel(CC.arch(28), vit_cfg=vit, device="cpu")
    solo = TModel(CC.arch(28), vit_cfg=vit, device="cpu")
    solo.load_state_dict(filt.state_dict())
    cfg = TrainConfig(epochs=1, batch_size=4, steps_per_epoch=4, learning_rate=1e-3,
                      freeze_backbone=False)
    tr = Trainer(filt, cfg, output_dir=str(tmp_path), alt_model=exact)
    ref = Trainer(solo, cfg, output_dir=str(tmp_path))
    assert exact.fusion.fc0.weight is filt.fusion.fc0.weight
    imgs = PD.synth_images(4, 28, 0)
    batch = {"images": normalize_np(imgs), "depths": ST.depth_law(imgs),
             "exif": CC.exif_numpy(4)}
    for i in range(2):
        a = tr.train_step(batch, torch.Generator().manual_seed(i), alt=True)
        b = ref.train_step(batch, torch.Generator().manual_seed(i))
        assert a["loss"] == b["loss"]
    for (n, p), q in zip(filt.named_parameters(), solo.parameters()):
        assert torch.equal(p, q), n
    with pytest.raises(ValueError, match="alt_model"):
        ref.train_step(batch, alt=True)


def test_synth_train_main_and_subprocess_cells(tmp_path, monkeypatch):
    """synth_train writes a checkpoint policy_delta's engines load; delta_sweep
    trains two cells in subprocesses and merges them."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # tiny cells: one thread each
    out = str(tmp_path / "synth.npz")
    flat = ST.main(["--out", out, "--steps", "2", "--batch", "4", "--image-size", "28",
                    "--n-images", "8", "--device", "cpu"])
    assert sorted(CC.load_flat(out)[0]) == sorted(flat)
    sweep = str(tmp_path / "sweep.json")
    res = DS.main(["--cell-subprocess", "--seeds", "0,1", "--laws", "ring", "--steps", "2",
                   "--batch", "4", "--n-train", "8", "--image-size", "28", "--n-eval", "4",
                   "--eval-batch", "4", "--tiny", "--layers", "2", "--filters", "1:0.5",
                   "--ckpt-dir", str(tmp_path / "ck"), "--out", sweep, "--device", "cpu"])
    assert [(r["seed"], r["law"]) for r in res["runs"]] == [(0, "ring"), (1, "ring")]
    with open(sweep) as f:
        assert json.load(f) == res
    for r in res["runs"]:
        assert set(r["absrel_gt"]) == {"f32", "1:0.5"}
        assert all(np.isfinite(v) for v in r["table"]["1:0.5"].values())


def test_measure_only_reports_a_missing_checkpoint(tmp_path):
    with pytest.raises(SystemExit, match="missing"):
        DS.main(["--measure-only", "--seeds", "7", "--laws", "procg", "--tiny", "--layers", "2",
                 "--image-size", "28", "--n-eval", "4", "--ckpt-dir", str(tmp_path),
                 "--out", str(tmp_path / "o.json"), "--device", "cpu"])


# ------------------------------------------------------ certify_filter ----
def _sweep_json(path, rng, specs, cells):
    runs = []
    for seed, law in cells:
        gt = {name: {g: float(rng.rand() * 0.1) for g in JG.INSTRUCTIONS}
              for name in ["f32", *specs]}
        runs.append({"seed": seed, "law": law, "absrel_gt": gt,
                     "table": {s: {g: float(rng.rand() * 0.05) for g in JG.INSTRUCTIONS}
                               for s in specs}})
    with open(path, "w") as f:
        json.dump({"runs": runs}, f)


@pytest.mark.parametrize("budget", [None, "0.03"])
def test_certify_filter_output_is_byte_identical(tmp_path, budget):
    rng = np.random.RandomState(0)
    base, cand = str(tmp_path / "base.json"), str(tmp_path / "cand.json")
    cells = [(0, "procg"), (1, "procg"), (0, "center")]
    _sweep_json(base, rng, ["2:0.35"], cells)
    _sweep_json(cand, rng, ["2:0.35", "2:0.25@p", "1:0.6,2:0.3"], cells[:2] + [(5, "ring")])
    argv = ["--baseline", base, "--candidate", cand] + (["--budget", budget] if budget else [])
    env = dict(os.environ, PYTHONPATH=ROOT)
    want = subprocess.run([sys.executable, os.path.join(SCRIPTS, "certify_filter.py"), *argv],
                          capture_output=True, check=True, env=env).stdout
    got = subprocess.run([sys.executable, "-m", "cognitive_aim_tpu_torch.certify.certify_filter",
                          *argv], capture_output=True, check=True, env=env, cwd=ROOT).stdout
    assert got == want
    assert json.loads(got.splitlines()[-1])["specs"]


# ----------------------------------------- the certification guard ----
GUARD_SPECS = {"2:0.35": {"token_filter_layer": 2, "token_filter_keep": 0.35},
               "2:0.25": {"token_filter_layer": 2, "token_filter_keep": 0.25}}


def _garch(**kw):
    return CC.arch(SIZE, num_iterations=2, **kw)


def _guard_batch(norm, target, i):
    b = slice((i % 8) * 8, (i % 8) * 8 + 8)
    return {"images": norm[b], "depths": target[b], "exif": CC.exif_numpy(8)}


@pytest.fixture(scope="module")
def guard_cell(tmp_path_factory):
    """tests/test_certification_guard.py's fixed-seed tiny cell on the port:
    4 layers, 56x56, 60 steps at lr 3e-3, strict f32, the center law."""
    imgs01 = PD.synth_images(64, SIZE, seed=0)
    norm, target = normalize_np(imgs01), ST.depth_law(imgs01)
    model = TModel(_garch(), policy=TP.STRICT_F32, vit_cfg=_tvit(), device="cpu")
    model.init(torch.Generator().manual_seed(0))
    cfg = TrainConfig(epochs=1, batch_size=8, steps_per_epoch=60, learning_rate=3e-3,
                      freeze_backbone=False, weight_decay=0.0)
    tr = Trainer(model, cfg, output_dir=str(tmp_path_factory.mktemp("guard")))
    losses = [tr.train_step(_guard_batch(norm, target, i), torch.Generator().manual_seed(i))
              ["loss"] for i in range(60)]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), "cell did not train"
    eval01 = PD.synth_images(16, SIZE, seed=12345)
    return (model, norm, target, torch.from_numpy(normalize_np(eval01)),
            ST.depth_law(eval01).astype(np.float64))


def _absrel_per_instruction(model, images, gt):
    return {g: CC.absrel(CC.depths(model, images, gi, torch.Generator().manual_seed(0),
                                   NoiseMode.SAMPLE).numpy(), gt)
            for gi, g in enumerate(JG.INSTRUCTIONS)}


def _variant(model, **kw):
    m = TModel(_garch(**kw), policy=TP.STRICT_F32, vit_cfg=_tvit(), device="cpu")
    m.load_state_dict(model.state_dict())
    return m


@pytest.mark.parametrize("spec", sorted(GUARD_SPECS))
def test_certified_spec_gt_gap_bound(guard_cell, spec):
    model, _, _, images, gt = guard_cell
    a = _absrel_per_instruction(_variant(model), images, gt)
    b = _absrel_per_instruction(_variant(model, **GUARD_SPECS[spec]), images, gt)
    gap = max(abs(b[g] - a[g]) for g in JG.INSTRUCTIONS)
    assert gap < 0.04, f"{spec} gt-metric gap {gap * 100:.2f}% exceeded the 4% guard"


def test_alternation_sandwich_rescue(guard_cell, tmp_path):
    """The JAX guard's alternation test on the port: a filtered / exact
    alternating finetune keeps the exact path from collapsing and the
    filtered gap within noise of the raw gap and under 4%."""
    model, norm, target, images, gt = guard_cell
    spec = GUARD_SPECS["2:0.35"]
    a0 = _absrel_per_instruction(_variant(model), images, gt)
    b0 = _absrel_per_instruction(_variant(model, **spec), images, gt)
    gap_raw = max(abs(b0[g] - a0[g]) for g in JG.INSTRUCTIONS)
    filt = _variant(model, **spec, token_filter_train=True)
    exact = _variant(model)
    tr = Trainer(filt, TrainConfig(epochs=1, batch_size=8, steps_per_epoch=40,
                                   learning_rate=3e-4, freeze_backbone=False, weight_decay=0.0),
                 output_dir=str(tmp_path), alt_model=exact)
    for i in range(40):
        tr.train_step(_guard_batch(norm, target, i), torch.Generator().manual_seed(1000 + i))
    a1 = _absrel_per_instruction(_variant(filt), images, gt)
    b1 = _absrel_per_instruction(_variant(filt, **spec), images, gt)
    gap_sand = max(abs(b1[g] - a1[g]) for g in JG.INSTRUCTIONS)
    assert max(a1.values()) < max(a0.values()) * 1.5 + 0.01
    assert gap_sand < max(2.0 * gap_raw, 0.01)
    assert gap_sand < 0.04


def test_guided_training_keeps_the_unguided_path_equal_to_jax(tmp_path):
    """Guided training (a random instruction per sample, here given per
    batch) never feeds the unguided fusion input in either package: after 8
    trainer steps from the same weights, the port's unguided and guided
    depths equal the JAX trainer's to float32 rounding (the recipe's
    unguided held-out number is the same function's)."""
    from cognitive_aim_tpu.train.trainer import TrainConfig as JTrainConfig
    from cognitive_aim_tpu.train.trainer import Trainer as JTrainer
    from cognitive_aim_tpu_torch.convert import load_flat_params

    vit = dict(hidden_size=64, num_layers=2, num_heads=4, patch_size=14, pretrain_image_size=28)
    arch = dict(num_iterations=2, image_size=28, freeze_backbone=False)
    jm = JModel(JArch(**arch), policy=JP.STRICT_F32, vit_cfg=JD.DinoV2Config(**vit))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = TModel(TArch(**arch), policy=TP.STRICT_F32, vit_cfg=TD.DinoV2Config(**vit),
                device="cpu")
    load_flat_params(tm, j_flatten(params))
    kw = dict(learning_rate=1e-4, epochs=1, batch_size=8, steps_per_epoch=8,
              freeze_backbone=False)  # the recipe's lr
    jt = JTrainer(jm, params, JTrainConfig(**kw), output_dir=str(tmp_path / "j"))
    tt = Trainer(tm, TrainConfig(**kw), output_dir=str(tmp_path / "t"))
    imgs, gt = P.gen_procedural(8, 28, 1)
    for i in range(8):
        rng = np.random.RandomState(i)
        b = {"images": normalize_np(imgs), "depths": gt, "exif": CC.exif_numpy(8),
             "guidance": rng.randint(0, 9, 8).astype(np.int32)}
        np.testing.assert_allclose(tt.train_step(b)["loss"], jt.train_step(b, None)["loss"],
                                   atol=1e-5, rtol=0)
    x = normalize_np(P.gen_procedural(8, 28, 2)[0])
    jex = {k: jnp.asarray(v) for k, v in CC.exif_numpy(8).items()}
    ev = jax.jit(lambda p, im, gv: jm.apply(p, im, jex, noise_mode=JNoise.ZEROS,
                                            guidance=gv).depth[:, 0])
    for g in (None, np.arange(8) % 9):
        want = ev(jt.params, jnp.asarray(x), None if g is None else jnp.asarray(g))
        got = CC.depths(tm, torch.from_numpy(x), None if g is None else torch.from_numpy(g))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
