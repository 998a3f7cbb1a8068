"""The kernels as ``caim`` custom ops, and the port's ``torch.export`` path,
on the CPU (scripts/torch_export_model.py; the JAX side's
scripts/export_model.py and tests/test_export.py).

  (a) ``torch.library.opcheck`` of every ``caim`` op on small CPU inputs:
      the implementation runs the plain version, the fake gives the same
      shapes, dtypes and strides, no output aliases an input or another;
  (b) the tiny model (tests/test_export.py's sizes with 4 layers, so that a
      layer-2 filter acts), exported under default, int8, int8 2:0.35 and
      int8 2:0.35@p: one ``caim`` node per launch the card makes, and none of
      the kernels' arithmetic traced into aten ops (no square softmax, no
      integer product, no rounding); saved and loaded through a BytesIO and
      rebuilt from its npz alone, it reproduces the live model at
      scripts/export_model.py's rtol 2e-5 / atol 1e-6;
  (c) the loaded artifact against the JAX package's ``jax.export`` artifact
      on the same weights, a batch of 9 carrying the 9 instructions: strict
      f32 (erf GELU) at F32_TOL, int8 at BF16_TOL (tests/test_torch_model.py's
      tolerances and reasons; the JAX int8 side runs its Pallas kernels in
      interpret mode);
  (d) a subprocess loads the artifact with only the op registrations
      imported: no model, nn or api module of the port, no jax;
  (e) scripts/torch_export_model.py's ``main`` end to end with ``--device
      cpu`` at a tiny width (the engine's ``vit_cfg`` hook).

Exports are made once per configuration and shared by the tests.
"""

import dataclasses
import functools
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cognitive_aim_tpu.api import unflatten_npz
from cognitive_aim_tpu.core import precision as JP
from cognitive_aim_tpu.core.rng import NoiseMode as JNoise
from cognitive_aim_tpu.models.cognitive_aim import CognitiveAimModel as JModel
from cognitive_aim_tpu.models.config import ModelArchConfig
from cognitive_aim_tpu.nn import dinov2 as JD
from cognitive_aim_tpu_torch.convert import flat_params, load_flat_params
from cognitive_aim_tpu_torch.core import precision as TP
from cognitive_aim_tpu_torch.core.rng import NoiseMode
from cognitive_aim_tpu_torch.kernels import _library
from cognitive_aim_tpu_torch.kernels import flash_attention as TFA
from cognitive_aim_tpu_torch.kernels import focal_attention as TFO
from cognitive_aim_tpu_torch.kernels import int8_block as TIB
from cognitive_aim_tpu_torch.kernels import int8_gemm as TIG
from cognitive_aim_tpu_torch.kernels.int8_ops import quantize_weight
from cognitive_aim_tpu_torch.models import config as TCfg
from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel as TModel
from cognitive_aim_tpu_torch.nn import dinov2 as TD

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import torch_export_model as EXP  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# tests/test_export.py's tiny ViT with 4 layers: a 56x56 image is the 4x4
# pretrain grid, 16 patches
TINY = dict(hidden_size=64, num_layers=4, num_heads=4, patch_size=14, pretrain_image_size=56)
IMG, B9 = 56, 9
RT_TOL = dict(rtol=EXP.RTOL, atol=EXP.ATOL)
F32_TOL = dict(atol=2e-6, rtol=1e-5)  # tests/test_torch_model.py
BF16_TOL = dict(atol=1e-2, rtol=0.0)  # tests/test_torch_model.py

# ------------------------------------------------------------ (a) opcheck ----
_g = torch.Generator().manual_seed(0)


def _r(*shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(*shape, generator=_g) * scale).to(dtype)


def _w(n, k):
    w = quantize_weight(_r(n, k, scale=0.05))
    return w["q"], w["s"]


B, N, H = 2, 5, 2
HD, D, F = H * 64, 128, 256
bf = torch.bfloat16
q, k, v = (_r(B, N, HD, dtype=bf) for _ in range(3))
x, ctx, res = _r(B, N, D, dtype=bf), _r(B, N, D, dtype=bf), _r(B, N, D, dtype=bf)
g, be, bd, ls = 1 + _r(D, scale=0.1), _r(D, scale=0.1), _r(D, scale=0.1), _r(D, scale=0.1)
wqkv, bqkv = _w(3 * D, D), _r(3 * D, scale=0.1)
wo, w1, w2, b1 = _w(D, D), _w(F, D), _w(D, F), _r(F, scale=0.1)
h8, sh = TIB.int8_fc1_gelu_ln_plain(x, g, be, *w1, b1)
OPCHECK = {
    "flash_attention_packed": (q, k, v, 0.125, H),
    "flash_attention_packed_bias": (q, k, v, _r(B, N), 0.125, H),
    "flash_attention_packed_int8": (q, k, v, 0.125, H),
    "flash_attention_packed_i8qk": (q, k, v, 0.125, H),
    "flash_attention_packed_i8qk_bias": (q, k, v, _r(B, N), 0.125, H),
    "flash_attention_packed_out_res": (q, k, v, *wo, bd, ls, res, 0.125, H, True),
    # strided views: the column slices of one fused [B, N, 3, H, 64] projection
    "flash_attention": tuple(_r(B, N, 3, H, 64).unbind(2)) + (0.125,),
    "quantize_rows": (q, k),
    "quantize_heads": (q, H, None),
    "focal_attention_fused": (x.float(), ctx.float(), res.float(), 8.0),
    "int8_qkv_proj_ln": (x, g, be, *wqkv, bqkv, 1e-6, bf),
    "int8_qkv_proj": (x, *wqkv, bqkv, bf),
    "int8_out_residual": (ctx, *wo, bd, ls, res),
    "int8_out_residual_prequant": (h8, sh, *w2, bd, ls, res),
    "int8_fc1_gelu_ln": (x, g, be, *w1, b1, 1e-6),
    "int8_fc1_gelu": (x, *w1, b1),
    "int8_proj": (x, *w1, b1, bf),
    "int8_attnout_mlp_ln": (ctx, *wo, bd, ls, res, g, be, *w1, b1, *w2, bd, ls, 1e-6),
    "int8_gemm_fused": (x.view(B * N, D), *wqkv, bqkv, bf),
}


@pytest.mark.parametrize("name", sorted(OPCHECK))
def test_opcheck_every_caim_op(name):
    """The schema, the fake against the implementation (the plain version
    here), no aliasing, and the op under aot_autograd with dynamic shapes;
    on the CPU no launch is counted."""
    before = _launch_counts()
    torch.library.opcheck(_library.OPS[name], OPCHECK[name])
    assert _launch_counts() == before


def test_every_op_has_an_opcheck_case_and_every_wrapper_an_op():
    """Nineteen ops, one each for the kernels (K4 is K4a then K4b), each
    with a case above; each is ``torch.ops.caim.<name>``."""
    assert sorted(_library.OPS) == sorted(OPCHECK) and len(OPCHECK) == 19
    for name, op in _library.OPS.items():
        assert getattr(torch.ops.caim, name).default is op._opoverload
    wrappers = {w.__name__ for w in TFA.WRAPPERS + TIB.WRAPPERS + TIG.WRAPPERS}
    wrappers.add(TFO.focal_attention_fused.__name__)
    assert wrappers - {"int8_mlp_ln"} == set(_library.OPS)


def _launch_counts():
    return [w.launches for w in TFA.WRAPPERS + TIB.WRAPPERS + TIG.WRAPPERS
            + (TFO.focal_attention_fused,)]


def test_fakes_on_cuda_tensors_build_nothing_and_check_nothing(monkeypatch):
    """What ``torch.export`` meets on the card: each op on fake CUDA tensors
    gives the shapes and dtypes of its CPU implementation's outputs,
    contiguous, on the inputs' device, without reaching the library (which
    would build it and read pointers); and the CUDA implementation's checks
    are not made (width 64: the GEMM takes multiples of 128)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from cognitive_aim_tpu_torch.kernels import _build

    def no_library():
        raise AssertionError("the library was reached")

    monkeypatch.setattr(_build, "library", no_library)
    real = {name: _library.OPS[name](*args) for name, args in OPCHECK.items()}

    def on_card(a):
        if not isinstance(a, torch.Tensor):
            return a
        return torch.empty_strided(a.shape, a.stride(), dtype=a.dtype, device="cuda")

    with FakeTensorMode():
        for name, args in OPCHECK.items():
            got = _library.OPS[name](*map(on_card, args))
            want = real[name] if isinstance(real[name], (tuple, list)) else (real[name],)
            got = got if isinstance(got, (tuple, list)) else (got,)
            assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype) for t in want]
            assert all(t.device.type == "cuda" and t.is_contiguous() for t in got), name
        narrow = torch.empty(1, 3, 64, dtype=bf, device="cuda")
        w = torch.empty(64, 64, dtype=torch.int8, device="cuda")
        s64 = torch.empty(64, device="cuda")
        assert _library.OPS["int8_proj"](narrow, w, s64, s64, bf).shape == (1, 3, 64)


def test_qkv_ops_return_one_packed_tensor_and_the_wrappers_unbind_it():
    """K2 and K5: the op and the plain version give [3, B, N, D]; the wrapper
    gives three contiguous [B, N, D] views of it."""
    packed = _library.OPS["int8_qkv_proj"](x, *wqkv, bqkv, bf)
    assert packed.shape == (3, B, N, D) and packed.is_contiguous()
    assert torch.equal(packed, TIB.int8_qkv_proj_plain(x, *wqkv, bqkv, bf))
    parts = TIB.int8_qkv_proj(x, *wqkv, bqkv)
    assert len(parts) == 3 and all(p.is_contiguous() for p in parts)
    assert all(torch.equal(a, b) for a, b in zip(parts, packed))
    ln = TIB.int8_qkv_proj_ln(x, g, be, *wqkv, bqkv)
    assert all(torch.equal(a, b)
               for a, b in zip(ln, TIB.int8_qkv_proj_ln_plain(x, g, be, *wqkv, bqkv)))


# -------------------------------------------------------- the tiny models ----
def _tarch(arch):
    return TCfg.ModelArchConfig(**dataclasses.asdict(arch))


def _arch(token_filter=""):
    return ModelArchConfig(num_iterations=2, image_size=IMG,
                           **TCfg.parse_token_filter(token_filter))


@functools.lru_cache(maxsize=None)
def _flat():
    """The weights of both sides: the port's seeded init as the flat float32
    interchange (``convert.flat_params``), which ``load_flat_params`` gives
    the port's models and ``unflatten_npz`` the JAX package's."""
    tm = TModel(_tarch(_arch()), device="cpu", vit_cfg=TD.DinoV2Config(**TINY))
    return flat_params(tm.init(torch.Generator().manual_seed(0)))


POLICIES = {
    # name: (JAX policy, port policy, tanh GELU)
    "default": (JP.DEFAULT_POLICY, TP.DEFAULT_POLICY, True),
    "int8": (JP.INT8_BACKBONE, TP.INT8_BACKBONE, True),
    "strict_f32_erf": (JP.STRICT_F32, TP.STRICT_F32, False),
}


def _port_model(policy, token_filter=""):
    """The port's tiny model on the JAX init's weights (``convert``), prepared
    for the policy, on the CPU."""
    _, tp, gelu = POLICIES[policy]
    tm = TModel(_tarch(_arch(token_filter)), policy=tp, attn_impl="pallas_packed",
                device="cpu", vit_cfg=TD.DinoV2Config(**TINY, gelu_approx=gelu))
    load_flat_params(tm, _flat())
    return tm.prepare_params()


def _inputs(batch=B9):
    """scripts/export_model.py's round-trip inputs; the 9 instructions."""
    images, exif, _ = EXP.serving_inputs(batch, IMG, "cpu",
                                         EXP.roundtrip_images(batch, IMG, "cpu"))
    return images, exif, torch.arange(batch) % 9


def _exported(policy, token_filter=""):
    return _export(policy, token_filter)


@functools.lru_cache(maxsize=None)
def _export(policy, token_filter):
    """(live serve module, ExportedProgram, module loaded from a BytesIO and
    rebuilt from the npz alone, the saved artifact's bytes, npz bytes)."""
    serve = EXP.Serve(_port_model(policy, token_filter), NoiseMode.ZEROS).requires_grad_(False)
    args = _inputs()
    with torch.no_grad():
        serve(*args)  # the cached tables made on real tensors (export_engine)
        program = torch.export.export(serve, args)
    blob, npz = io.BytesIO(), io.BytesIO()
    torch.export.save(program, blob)
    np.savez(npz, **{n: (t.float() if t.dtype == torch.bfloat16 else t).numpy()
                     for n, t in program.state_dict.items()})
    blob.seek(0)
    loaded = torch.export.load(blob).module()
    state = loaded.state_dict()
    npz.seek(0)
    with np.load(npz) as arrays:
        assert set(arrays.files) == set(state)
        # every weight from the npz: the module's own are zeroed first
        for t in state.values():
            t.zero_()
        loaded.load_state_dict({n: torch.from_numpy(arrays[n]).to(state[n].dtype)
                                for n in arrays.files})
    return serve, program, loaded, blob.getvalue(), npz.getvalue()


# launches per forward on the card at 4 layers and 2 focal iterations
INT8 = {"int8_qkv_proj_ln": 4, "flash_attention_packed": 4, "int8_out_residual": 4,
        "int8_fc1_gelu_ln": 4, "int8_out_residual_prequant": 4, "int8_qkv_proj": 2,
        "focal_attention_fused": 2}
EXPORTS = {
    "default": ("default", "", {"flash_attention_packed": 4, "focal_attention_fused": 2}),
    "int8": ("int8", "", INT8),
    "int8 2:0.35": ("int8", "2:0.35", INT8),
    "int8 2:0.35@p": ("int8", "2:0.35@p", {**INT8, "flash_attention_packed": 2,
                                           "flash_attention_packed_bias": 2}),
}
MATMULS = ("mm", "bmm", "matmul", "einsum", "linear", "baddbmm", "addmm")


def _kernel_arithmetic(graph):
    """aten nodes that would be a kernel's plain arithmetic: a square score
    matrix's softmax (K1, K7, K6), an integer product or a rounding (the
    int8 kernels, the quantisers)."""
    found = []
    for n in graph.nodes:
        if n.op != "call_function" or not str(n.target).startswith("aten."):
            continue
        op, val = str(n.target).split(".")[1], n.meta.get("val")
        shape = tuple(getattr(val, "shape", ()))
        if "softmax" in op and len(shape) >= 2 and shape[-1] == shape[-2] > 1:
            found.append((str(n.target), shape))
        if op in MATMULS and not getattr(val, "dtype", torch.float32).is_floating_point:
            found.append((str(n.target), shape))
        if op == "round":
            found.append((str(n.target), shape))
    return found


@pytest.mark.parametrize("case", sorted(EXPORTS))
def test_export_holds_one_caim_node_a_launch_and_reloads_exactly(case):
    policy, spec, want = EXPORTS[case]
    serve, program, loaded, blob, _ = _exported(policy, spec)
    assert dict(_library.op_counts(program)) == want
    assert dict(_library.op_counts(loaded.graph)) == want
    assert _kernel_arithmetic(program.graph) == []
    args = _inputs()
    with torch.no_grad():
        d0, c0 = serve(*args)
        d1, c1 = loaded(*args)
    assert d0.shape == c0.shape == (B9, 1)
    np.testing.assert_allclose(d1.numpy(), d0.numpy(), **RT_TOL)
    np.testing.assert_allclose(c1.numpy(), c0.numpy(), **RT_TOL)
    assert len(blob) > 1000


def test_the_filtered_export_filters():
    """2:0.35 acts at layer 2 of 4: its program differs from the exact one's
    and so do its outputs, by less than the filter's own error."""
    exact, _, _, _, _ = _exported("int8")
    filtered, _, _, _, _ = _exported("int8", "2:0.35")
    args = _inputs()
    with torch.no_grad():
        de, df = exact(*args)[0], filtered(*args)[0]
    assert not torch.equal(de, df)
    assert float((de - df).abs().max()) < 0.5 * float(de.abs().max())


# ------------------------------------------------- (c) against jax.export ----
@pytest.fixture
def pallas_interpret(monkeypatch):
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def interp(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", interp)


def _jax_artifact(policy, images, exif, gidx):
    """tests/test_export.py's export of the JAX tiny model, deserialized and
    called; noise zeros, as scripts/export_model.py serves."""
    from jax import export as jexport

    jp, _, gelu = POLICIES[policy]
    jm = JModel(_arch(), policy=jp, attn_impl="pallas_packed",
                vit_cfg=JD.DinoV2Config(**TINY, gelu_approx=gelu))
    params = jm.prepare_params(unflatten_npz(_flat()))
    key = jax.random.PRNGKey(0)

    def serve(p, x, e, gi):
        out = jm.apply(p, x, e, guidance=gi, rng=key, noise_mode=JNoise.ZEROS)
        return out.depth, out.confidence

    jargs = (jnp.asarray(images), {n: jnp.asarray(t) for n, t in exif.items()},
             jnp.asarray(gidx, jnp.int32))
    blob = jexport.export(jax.jit(serve))(params, *jargs).serialize()
    d, c = jexport.deserialize(blob).call(params, *jargs)
    return np.asarray(d), np.asarray(c)


@pytest.mark.parametrize("policy,tol", [("strict_f32_erf", F32_TOL), ("int8", BF16_TOL)],
                         ids=["strict_f32_erf", "int8"])
def test_loaded_artifact_matches_the_jax_export(policy, tol, pallas_interpret):
    _, _, loaded, _, _ = _exported(policy)
    images, exif, gidx = _inputs()
    assert sorted(gidx.tolist()) == list(range(9))
    with torch.no_grad():
        d, c = loaded(images, exif, gidx)
    jd, jc = _jax_artifact(policy, images.numpy(),
                           {n: t.numpy() for n, t in exif.items()}, gidx.numpy())
    np.testing.assert_allclose(d.numpy(), jd, err_msg=f"{policy} depth", **tol)
    np.testing.assert_allclose(c.numpy(), jc, err_msg=f"{policy} confidence", **tol)


# ------------------------------------------- (d) a consumer without the model ----
def test_artifact_loads_with_only_the_op_registrations(tmp_path):
    serve, _, _, blob, npz = _exported("int8", "2:0.35@p")
    path = str(tmp_path / "tiny.pt2")
    with open(path, "wb") as f:
        f.write(blob)
    with open(path + ".params.npz", "wb") as f:
        f.write(npz)
    images, exif, gidx = _inputs()
    with torch.no_grad():
        d0, c0 = serve(images, exif, gidx)
    np.savez(str(tmp_path / "io.npz"), images=images.numpy(), gidx=gidx.numpy(),
             d=d0.numpy(), c=c0.numpy(), **{"exif_" + n: t.numpy() for n, t in exif.items()})
    code = (
        "import sys\n"
        "import numpy as np, torch\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'scripts')!r})\n"
        "from torch_export_model import load_program\n"
        f"program = load_program({path!r})\n"
        f"io = np.load({str(tmp_path / 'io.npz')!r})\n"
        "exif = {n[5:]: torch.from_numpy(io[n]) for n in io.files if n.startswith('exif_')}\n"
        "with torch.no_grad():\n"
        "    d, c = program(torch.from_numpy(io['images']), exif, torch.from_numpy(io['gidx']))\n"
        "np.testing.assert_allclose(d.numpy(), io['d'], rtol=2e-5, atol=1e-6)\n"
        "np.testing.assert_allclose(c.numpy(), io['c'], rtol=2e-5, atol=1e-6)\n"
        "pkg = 'cognitive_aim_tpu_torch'\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'cognitive_aim_tpu')\n"
        "       or any(m == f'{pkg}.{p}' or m.startswith(f'{pkg}.{p}.')\n"
        "              for p in ('models', 'nn', 'api', 'io', 'serve', 'train'))]\n"
        "assert not bad, bad\n"
        "assert f'{pkg}.kernels.flash_attention' in sys.modules\n"
        "print('consumer ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    assert "consumer ok" in out.stdout


# ----------------------------------------------------- (e) the script's main ----
def test_export_script_end_to_end_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "model.pt2")
    vit = TD.DinoV2Config(**{**TINY, "num_layers": 2}, gelu_approx=True)
    got = EXP.main(["--out", out, "--device", "cpu", "--batch", "2",
                    "--config", os.path.join(ROOT, "configs", "experiment_B.yaml")],
                   vit_cfg=vit)
    text = capsys.readouterr().out
    assert "roundtrip OK" in text and "caim nodes" in text
    assert os.path.getsize(out) > 1000 and os.path.exists(out + ".params.npz")
    assert got["bit_equal"] and got["params"] > 0
    # the int8 policy's 2 layers and experiment_B.yaml's focal iterations
    from cognitive_aim_tpu_torch.api import load_config

    cfg = load_config(os.path.join(ROOT, "configs", "experiment_B.yaml"))
    n_iter = TCfg.resolve_model_config(cfg).num_iterations
    assert got["caim_nodes"] == {
        "flash_attention_packed": 2, "int8_qkv_proj_ln": 2, "int8_out_residual": 2,
        "int8_fc1_gelu_ln": 2, "int8_out_residual_prequant": 2,
        "int8_qkv_proj": n_iter, "focal_attention_fused": n_iter}
