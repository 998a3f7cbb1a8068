"""The CUDA kernels K1, K6, K7, K8, K9, K10, K10b, K11 and the int8 kernels K2,
K3, K4, K4a, K4b, K5, K12, K13, K14, K15 against their plain PyTorch versions,
on the card; K10, K10b and K9, the int8 instantiation of K1's program, at
every length around its tiles, on rows of full int8 scale and under K1's
permutation probe; K11, its OUT_RES instantiation (a thread-block cluster of
one CTA a head), at the lengths around its tiles and every head count it
takes; K12's one kernel (a thread-block cluster a 64-row tile) at every row
count and width it takes. Every test here needs an NVIDIA Hopper GPU and skips without one.
The one-pass fc1 GEMM of K4a and K14 (a thread-block cluster per row tile)
is held to the plain version's bits, with a probe that makes every row's
scale come from another CTA of the cluster.

This file imports no jax (the GPU machine has none). From the repository
root on that machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Inputs come from a numpy seed. The plain version runs in float32 on the
same input values. Tolerances: bf16 outputs of magnitude up to ~2 are
rounded to bf16 (spacing <= 2^-7) and the kernel rounds P to bf16 before
the PV product: atol 2e-2. The float32 kernels (the strict policy's
register-tiled programs) differ from the plain version only in summation
order: atol 1e-4. K6's bf16 attended: within
1e-2 of the plain version's largest value (``FOCAL_REL``); its row views are
f32 over the unrounded P, values <= 1: atol 1e-5.

int8 kernels: the plain version runs the same f32 arithmetic on the same
bf16 inputs with an exact integer product (``torch._int_mm`` or float64).
A bf16 output may round the other way (one bf16 step, 2^-7 of the value),
and an int8 activation may differ by 1 where the layernorm's summation
order moves a value across a rounding boundary: outputs within
1e-2 max(1, |plain|); int8 outputs differ by at most 1 in under 1% of the
elements; row scales to rtol 2e-4 in all but 1e-3 of the rows (a row fed by
such an int8 step moves by ~1e-3 of its maximum), none beyond 5e-3.
"""

import threading

import numpy as np
import pytest
import torch

from cognitive_aim_tpu_torch.kernels import _build
from cognitive_aim_tpu_torch.kernels import flash_attention as TFA
from cognitive_aim_tpu_torch.kernels import focal_attention as TFO
from cognitive_aim_tpu_torch.kernels import int8_block as TIB
from cognitive_aim_tpu_torch.kernels import int8_gemm as TIG
from cognitive_aim_tpu_torch.kernels.int8_ops import quantize_weight


@pytest.fixture(autouse=True, scope="module")
def _no_grad():
    """The model's forward is differentiable since the port trains; these
    inference tests run under torch.no_grad(), as the engine serves."""
    with torch.no_grad():
        yield


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (see the module docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _arrays(shape, n=3, seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) * scale).astype(np.float32) for _ in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("N", [257, 481, 1370])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k1_kernel_matches_plain(N, dtype, cuda_device):
    B, H, D = 2, 12, 64
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype) for a in _arrays((B, N, H * D)))
    n = TFA.flash_attention_packed.launches
    got = TFA.flash_attention_packed(q, k, v, D ** -0.5, H)
    torch.cuda.synchronize()
    assert TFA.flash_attention_packed.launches == n + 1
    want = TFA.flash_attention_packed_plain(q.float(), k.float(), v.float(), D ** -0.5, H)
    # bf16: outputs rounded to bf16 and P rounded before PV
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert float((got.float() - want).abs().max()) <= tol


# ------------------------------- the bf16 attention program of K1, K7, K8 ----
BODY_LENGTHS = [1, 63, 64, 65, 127, 128, 129, 257, 416, 481, 826, 1370]


@pytest.mark.cuda
@pytest.mark.parametrize("N", BODY_LENGTHS)
@pytest.mark.parametrize("H", [12, 16])
def test_flash_body_matches_plain_at_every_length(N, H, cuda_device):
    """K1's bf16 program at lengths around its 64-row tiles and the model's
    stream lengths, ViT-B's 12 heads and ViT-L's 16: atol 1e-2, twice the
    largest error measured on the card (4.6e-3, at short lengths)."""
    B, D = 2, 64
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in _arrays((B, N, H * D), seed=N))
    want = TFA.flash_attention_packed_plain(q.float(), k.float(), v.float(), D ** -0.5, H)
    got = TFA.flash_attention_packed(q, k, v, D ** -0.5, H)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert float((got.float() - want).abs().max()) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("N", [65, 257, 1370])
def test_flash_body_keeps_keys_in_place(N, cuda_device):
    """A permutation probe: V one-hot by key index (V[b, j, h, d] = 1 where
    j % 64 == d) and peaked scores (q = 40 k, k one-hot the same way), so row
    i's output is one-hot at i % 64. A slip in the P fragments or V's
    transposed descriptor moves the 1 to another column: an error of 1, which
    random inputs could hide inside 2e-2."""
    B, H, D = 2, 4, 64
    onehot = torch.zeros(B, N, H, D, device=cuda_device)
    j = torch.arange(N, device=cuda_device)
    onehot[:, j, :, j % D] = 1.0
    k = onehot.reshape(B, N, H * D).to(torch.bfloat16)
    q = (40.0 * onehot).reshape(B, N, H * D).to(torch.bfloat16)
    want = TFA.flash_attention_packed_plain(q.float(), k.float(), k.float(), 1.0, H)
    hot = want.view(B, N, H, D).argmax(-1)
    assert torch.equal(hot, (j % D)[None, :, None].expand(B, N, H))
    got = TFA.flash_attention_packed(q, k, k, 1.0, H)
    torch.cuda.synchronize()
    assert float((got.float() - want).abs().max()) <= 1e-2
    assert torch.equal(got.view(B, N, H, D).float().argmax(-1), hot)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 65, 129, 481])
@pytest.mark.parametrize("bias", ["zeros", "groups", "every_key"])
def test_flash_body_bias_rows_at_short_lengths(N, bias, cuda_device):
    """K7 on the bias rows of the token filter at lengths inside one or two
    key tiles; atol 2e-2 as K7's other tests: the log-count rows peak the
    softmax on a few keys, so outputs reach |v| ~ 2, where a bf16 step is
    2^-7 * 2. A zero row gives K1's bits."""
    B, H, D = 2, 12, 64
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in _arrays((B, N, H * D), seed=N))
    row = _bias_row(B, N, bias, cuda_device)
    want = TFA.flash_attention_packed_bias_plain(q.float(), k.float(), v.float(), row,
                                                 D ** -0.5, H)
    got = TFA.flash_attention_packed_bias(q, k, v, row, D ** -0.5, H)
    torch.cuda.synchronize()
    assert float((got.float() - want).abs().max()) <= 2e-2
    if bias == "zeros":
        assert torch.equal(got, TFA.flash_attention_packed(q, k, v, D ** -0.5, H))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 129, 481, 1370])
def test_flash_body_is_deterministic_and_k8_is_k1(N, cuda_device):
    """Two launches give the same bits (no atomics); K8 on the column slices
    of one fused projection gives K1's bits on the same values."""
    B, H, D = 2, 12, 64
    (a,) = _arrays((B, N, 3 * H * D), n=1, seed=N)
    fused = torch.from_numpy(a).to(cuda_device, torch.bfloat16)
    q, k, v = fused.split(H * D, dim=-1)
    first = TFA.flash_attention_packed(*(t.contiguous() for t in (q, k, v)), D ** -0.5, H)
    again = TFA.flash_attention_packed(*(t.contiguous() for t in (q, k, v)), D ** -0.5, H)
    k8 = TFA.flash_attention(*(t.view(B, N, H, D) for t in (q, k, v)), D ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(first, again)
    assert torch.equal(k8.view(B, N, H * D), first)


@pytest.mark.cuda
def test_flash_body_raises_on_misaligned_strides_before_a_launch(cuda_device):
    """Rows 16-byte aligned at every stride, as TMA asks: a head stride of
    68 values, a token stride of 260, or a base 8 bytes off raise, and
    nothing launches."""
    n8 = TFA.flash_attention.launches
    wide = torch.zeros(2, 10, 4, 68, device=cuda_device, dtype=torch.bfloat16)[..., :64]
    rows = torch.zeros(2, 10, 4 * 64 + 4, device=cuda_device, dtype=torch.bfloat16)
    tok = rows[..., :256].unflatten(-1, (4, 64))
    flat = torch.zeros(2 * 10 * 256 + 4, device=cuda_device, dtype=torch.bfloat16)
    off = flat[4:].view(2, 10, 4, 64)
    for t in (wide, tok, off):
        with pytest.raises(ValueError):
            TFA.flash_attention(t, t, t, 0.125)
    assert TFA.flash_attention.launches == n8


@pytest.mark.cuda
@pytest.mark.parametrize("N,D", [(1369, 768), (77, 128), (256, 64), (300, 1024)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k6_kernel_matches_plain(N, D, dtype, cuda_device):
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _arrays((2, N, D), scale=0.5))
    scale = (D // 8) ** 0.5
    got = TFO.focal_attention_fused(q, k, v, scale)
    torch.cuda.synchronize()
    want = TFO.focal_attention_plain(q.float(), k.float(), v.float(), scale)
    if dtype == torch.bfloat16:
        _assert_focal_close(got, want)
    else:
        for g, w, tol in zip(got, want, (1e-4, 1e-5, 1e-5, 1e-5)):
            assert float((g.float() - w).abs().max()) <= tol


# K6's bf16 attended against the plain version, relative to its largest value:
# the bf16 output's rounding is at most 2^-8 of it and rounding the normalised
# P to bf16 adds ~1e-3, so 1e-2 holds with twice the worst case (an absolute
# 2e-2 would pass 0.8 x attended at N 1369, whose RMS is ~0.017)
FOCAL_REL = 1e-2


def _assert_focal_close(got, want):
    """attended within FOCAL_REL of max |plain|, the f32 views over the
    unrounded P within 1e-5, every output finite."""
    tols = (FOCAL_REL * float(want[0].abs().max()), 1e-5, 1e-5, 1e-5)
    for g, w, tol in zip(got, want, tols):
        assert bool(torch.isfinite(g).all())
        assert float((g.float() - w).abs().max()) <= tol


# K6's bf16 program around its 64-row query tiles and 64-key halves of a
# 128-key step, at every width it takes
FOCAL_LENGTHS = [1, 63, 64, 65, 127, 128, 129, 191, 193, 257, 1369]


@pytest.mark.cuda
@pytest.mark.parametrize("N", FOCAL_LENGTHS)
@pytest.mark.parametrize("D", [64, 128, 256, 512, 768, 1024])
def test_k6_bf16_matches_plain_at_every_length_and_width(N, D, cuda_device):
    """attended within 1e-2 of max |plain| (bf16 outputs, P rounded to
    bf16), 1e-5 for the f32 views over the unrounded P."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in _arrays((2, N, D), seed=N + D, scale=0.5))
    scale = (D // 8) ** 0.5
    got = TFO.focal_attention_fused(q, k, v, scale)
    torch.cuda.synchronize()
    _assert_focal_close(got, TFO.focal_attention_plain(q.float(), k.float(), v.float(), scale))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [77, 1369])
def test_k6_colmean_is_deterministic(N, cuda_device):
    """The colsum partials are summed in a fixed order: two runs, same bits."""
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in _arrays((8, N, 768), seed=7, scale=0.5))
    first = TFO.focal_attention_fused(q, k, v, 96 ** 0.5)
    second = TFO.focal_attention_fused(q, k, v, 96 ** 0.5)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [65, 481])
def test_k6_nan_padding_does_not_reach_the_outputs(N, cuda_device):
    """q, k, v are the first N rows of buffers whose rows past N hold NaN;
    the kernel's loads stop at N (rows past it read as zeros) and padded
    query rows are kept out of colmean by a select."""
    D, pad = 256, 64
    arrays = _arrays((1, N, D), seed=8, scale=0.5)
    views = []
    for a in arrays:
        buf = torch.full((1, N + pad, D), float("nan"), device=cuda_device,
                         dtype=torch.bfloat16)
        buf[:, :N] = torch.from_numpy(a).to(cuda_device, torch.bfloat16)
        views.append(buf[:, :N])
    assert all(v.is_contiguous() for v in views)
    got = TFO.focal_attention_fused(*views, (D // 8) ** 0.5)
    torch.cuda.synchronize()
    _assert_focal_close(got, TFO.focal_attention_plain(*(v.float() for v in views),
                                                       (D // 8) ** 0.5))


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    x = torch.zeros(1, 10, 96, device=cuda_device)  # 96 is not H * 64
    with pytest.raises(ValueError):
        TFA.flash_attention_packed(x, x, x, 0.125, 2)
    with pytest.raises(ValueError):
        TFO.focal_attention_fused(x, x, x, 1.0)  # D % 64 != 0
    y = torch.zeros(1, 10, 128, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        TFA.flash_attention_packed(y, y, y, 0.125, 2)


# ---------------- the strict policy's f32 programs: K1, K7, K8 and K6 ----
@pytest.mark.cuda
@pytest.mark.parametrize("N", BODY_LENGTHS)
@pytest.mark.parametrize("H", [12, 16])
def test_flash_f32_program_matches_plain_at_every_length(N, H, cuda_device):
    """K1's f32 program (csrc/flash_f32.cuh: register tiles, K and V by
    cp.async) at the bf16 program's lengths, ViT-B and ViT-L heads: atol
    1e-4, summation order only."""
    B, D = 2, 64
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _arrays((B, N, H * D), seed=N))
    want = TFA.flash_attention_packed_plain(q, k, v, D ** -0.5, H)
    got = TFA.flash_attention_packed(q, k, v, D ** -0.5, H)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("N", [65, 257, 1370])
def test_flash_f32_program_keeps_keys_in_place(N, cuda_device):
    """The permutation probe of the bf16 program, in f32: a key moved inside
    a tile costs an error of 1."""
    B, H, D = 2, 4, 64
    onehot = torch.zeros(B, N, H, D, device=cuda_device)
    j = torch.arange(N, device=cuda_device)
    onehot[:, j, :, j % D] = 1.0
    k = onehot.reshape(B, N, H * D)
    got = TFA.flash_attention_packed(40.0 * k, k, k, 1.0, H)
    want = TFA.flash_attention_packed_plain(40.0 * k, k, k, 1.0, H)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-4
    assert torch.equal(got.view(B, N, H, D).argmax(-1), (j % D)[None, :, None].expand(B, N, H))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 65, 129, 257, 481, 1370])
@pytest.mark.parametrize("bias", ["zeros", "groups", "every_key"])
def test_flash_f32_program_bias_rows(N, bias, cuda_device):
    """K7's f32 kernel (the program's BIAS instantiation) on the token
    filter's bias rows: atol 1e-4. A zero row gives K1's bits: the scores
    take the same fused multiply-add with a zero addend."""
    B, H, D = 2, 12, 64
    q, k, v = (torch.from_numpy(a).to(cuda_device) for a in _arrays((B, N, H * D), seed=N))
    row = _bias_row(B, N, bias, cuda_device)
    want = TFA.flash_attention_packed_bias_plain(q, k, v, row, D ** -0.5, H)
    got = TFA.flash_attention_packed_bias(q, k, v, row, D ** -0.5, H)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-4
    if bias == "zeros":
        assert torch.equal(got, TFA.flash_attention_packed(q, k, v, D ** -0.5, H))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 129, 257, 1370])
def test_flash_f32_program_is_deterministic_and_k8_is_k1(N, cuda_device):
    """K8's f32 kernel on the column slices of one fused projection (token
    stride 3 H 64): within 1e-4 of the plain version and K1's bits on the
    same values; two launches give the same bits."""
    B, H, D = 2, 12, 64
    (a,) = _arrays((B, N, 3 * H * D), n=1, seed=N)
    q, k, v = torch.from_numpy(a).to(cuda_device).split(H * D, dim=-1)
    first = TFA.flash_attention_packed(*(t.contiguous() for t in (q, k, v)), D ** -0.5, H)
    again = TFA.flash_attention_packed(*(t.contiguous() for t in (q, k, v)), D ** -0.5, H)
    views = [t.view(B, N, H, D) for t in (q, k, v)]
    k8 = TFA.flash_attention(*views, D ** -0.5)
    want = TFA.attention_reference(*views, D ** -0.5)
    torch.cuda.synchronize()
    assert float((k8 - want).abs().max()) <= 1e-4
    assert torch.equal(first, again)
    assert torch.equal(k8.view(B, N, H * D), first)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 63, 65, 256, 1369])
@pytest.mark.parametrize("D", [768, 1024])
def test_k6_f32_matches_plain_at_ragged_lengths(N, D, cuda_device):
    """K6's f32 program (the scores pass, the attend pass on the kept
    scores) at the model's widths and lengths around its 64-row and 64-key
    tiles; B 8 at N 1369 takes its 128-row blocks, B 2 its 64-row ones:
    attended atol 1e-4, the views 1e-5."""
    B = 8 if N == 1369 else 2
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in _arrays((B, N, D), seed=N + D, scale=0.5))
    scale = (D // 8) ** 0.5
    got = TFO.focal_attention_fused(q, k, v, scale)
    want = TFO.focal_attention_plain(q, k, v, scale)
    torch.cuda.synchronize()
    for g, w, tol in zip(got, want, (1e-4, 1e-5, 1e-5, 1e-5)):
        assert bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", [(2, 256), (8, 1369)])
def test_k6_f32_is_deterministic(B, N, cuda_device):
    """No atomics on either block shape: two runs, the same bits."""
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in _arrays((B, N, 768), seed=9, scale=0.5))
    first = TFO.focal_attention_fused(q, k, v, 96 ** 0.5)
    second = TFO.focal_attention_fused(q, k, v, 96 ** 0.5)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_k6_f32_nan_padding_does_not_reach_the_outputs(cuda_device):
    """Rows past N hold NaN: the copies stop at N, the scores past N are
    never read and P past N is a select, not a product."""
    N, D, pad = 481, 256, 64
    views = []
    for a in _arrays((1, N, D), seed=8, scale=0.5):
        buf = torch.full((1, N + pad, D), float("nan"), device=cuda_device)
        buf[:, :N] = torch.from_numpy(a).to(cuda_device)
        views.append(buf[:, :N])
    got = TFO.focal_attention_fused(*views, (D // 8) ** 0.5)
    want = TFO.focal_attention_plain(*views, (D // 8) ** 0.5)
    torch.cuda.synchronize()
    for g, w, tol in zip(got, want, (1e-4, 1e-5, 1e-5, 1e-5)):
        assert bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 96, 200, 1000])
def test_k6_f32_raises_without_a_launch_where_no_kernel_takes_the_width(D, cuda_device):
    """The f32 program takes every multiple of 64 (each pass steps through
    D in 32s and owns 64 columns of attended a block); other widths raise
    before a launch."""
    n = TFO.focal_attention_fused.launches
    x = torch.zeros(1, 10, D, device=cuda_device)
    with pytest.raises(ValueError):
        TFO.focal_attention_fused(x, x, x, 1.0)
    assert TFO.focal_attention_fused.launches == n


# ------------------------------------------------- K8, [B, N, H, 64] ----
@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "packed_view", "fused_slices", "heads_major",
                                    "batch_broadcast"])
@pytest.mark.parametrize("N,H", [(257, 12), (481, 12), (1370, 12), (257, 16)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k8_kernel_matches_plain(dtype, N, H, layout, cuda_device):
    """K8 on separately made [B, N, H, 64] tensors, on views of packed
    [B, N, H*64] projections, on the column slices of one fused
    [B, N, 3*H*64] projection (token stride 3*H*64), on [B, H, N, 64] memory
    read as [B, N, H, 64] (head stride N*64 above the token stride) and on
    one batch expanded (batch stride 0): no copy in between, the same values
    as K1 on the packed layout bit for bit."""
    B, D = 2, 64
    a = _arrays((B, N, 3 * H * D), n=1)[0]
    fused = torch.from_numpy(a).to(cuda_device, dtype)
    q, k, v = (t.view(B, N, H, D) for t in fused.split(H * D, dim=-1))
    if layout != "fused_slices":
        q, k, v = (t.contiguous() for t in (q, k, v))
    if layout == "packed_view":
        q, k, v = (t.view(B, N, H * D).view(B, N, H, D) for t in (q, k, v))
    if layout == "heads_major":
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    if layout == "batch_broadcast":
        q, k, v = (t[:1].expand(B, N, H, D) for t in (q, k, v))
    n, n1 = TFA.flash_attention.launches, TFA.flash_attention_packed.launches
    got = TFA.flash_attention(q, k, v, D ** -0.5)
    torch.cuda.synchronize()
    assert TFA.flash_attention.launches == n + 1
    assert TFA.flash_attention_packed.launches == n1  # K8 is not K1's entry
    assert got.shape == (B, N, H, D) and got.dtype == dtype and got.is_contiguous()
    want = TFA.attention_reference(q.float(), k.float(), v.float(), D ** -0.5)
    assert float((got.float() - want).abs().max()) <= (2e-2 if dtype == torch.bfloat16 else 1e-4)
    qkv = (t.reshape(B, N, H * D).contiguous() for t in (q, k, v))
    packed = TFA.flash_attention_packed(*qkv, D ** -0.5, H)
    assert torch.equal(got.view(B, N, H * D), packed)


@pytest.mark.cuda
def test_k8_raises_on_what_the_kernel_does_not_take(cuda_device):
    x = torch.zeros(2, 10, 4, 64, device=cuda_device, dtype=torch.bfloat16)
    n = TFA.flash_attention.launches
    with pytest.raises(ValueError):  # head size 32
        TFA.flash_attention(x[..., :32], x[..., :32], x[..., :32], 0.125)
    with pytest.raises(ValueError):  # heads-first view: the last dimension is strided
        t = x.transpose(2, 3).contiguous().transpose(2, 3)
        TFA.flash_attention(t, t, t, 0.125)
    with pytest.raises(ValueError):  # rows 8 bytes off a 16-byte boundary
        y = torch.zeros(2 * 10 * 4 * 64 + 4, device=cuda_device, dtype=torch.bfloat16)
        t = y[4:].view(2, 10, 4, 64)
        TFA.flash_attention(t, t, t, 0.125)
    with pytest.raises(ValueError):  # k of another length
        TFA.flash_attention(x, x[:, :9], x, 0.125)
    with pytest.raises(TypeError):
        TFA.flash_attention(x.half(), x.half(), x.half(), 0.125)
    assert TFA.flash_attention.launches == n


# ------------------------------------- biased and int8-QK^T attention ----
def _bias_row(B, N, kind, dev):
    """Key-side logit bias [B, N]: zeros; log token counts on the 4 trailing
    keys (all keys below 4) with one empty group at log(1e-6); log counts on
    every key."""
    r = np.random.RandomState(3)
    b = np.zeros((B, N), np.float32)
    if kind == "groups":  # as many trailing keys as there are, up to 4
        g = min(4, N)
        b[:, -g:] = np.log(r.randint(1, 891, (B, 4)))[:, 4 - g:]
        b[0, -min(2, N)] = np.log(1e-6)
    elif kind == "every_key":
        b[:] = np.log(r.randint(1, 891, (B, N)))
    return torch.from_numpy(b).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("N,H", [(257, 12), (481, 12), (416, 12), (1370, 12), (257, 16)])
@pytest.mark.parametrize("bias", ["zeros", "groups", "every_key"])
@pytest.mark.parametrize("kernel", ["K7", "K7_f32", "K10b"])
def test_biased_attention_kernel_matches_plain(kernel, bias, N, H, cuda_device):
    """bf16: atol 2e-2 as K1 (bf16 outputs, P rounded before P V); the
    float32 K7 kernel: summation order only, atol 1e-4. A zero bias gives
    the unbiased kernel's output bit for bit."""
    B, D = 2, 64
    dtype = torch.float32 if kernel == "K7_f32" else torch.bfloat16
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype) for a in _arrays((B, N, H * D)))
    row = _bias_row(B, N, bias, cuda_device)
    wrapper, plain, unbiased = {
        "K7": (TFA.flash_attention_packed_bias, TFA.flash_attention_packed_bias_plain,
               TFA.flash_attention_packed),
        "K10b": (TFA.flash_attention_packed_i8qk_bias,
                 TFA.flash_attention_packed_i8qk_bias_plain, TFA.flash_attention_packed_i8qk),
    }[kernel.split("_")[0]]
    n = wrapper.launches
    got = wrapper(q, k, v, row, D ** -0.5, H)
    torch.cuda.synchronize()
    assert wrapper.launches == n + 1 and got.dtype == dtype
    want = plain(q.float(), k.float(), v.float(), row, D ** -0.5, H)
    assert bool(torch.isfinite(got).all())
    assert float((got.float() - want).abs().max()) <= (1e-4 if dtype == torch.float32 else 2e-2)
    if bias == "zeros":
        assert torch.equal(got, unbiased(q, k, v, D ** -0.5, H))


@pytest.mark.cuda
@pytest.mark.parametrize("N,H", [(257, 12), (481, 12), (1370, 12), (257, 16)])
def test_k10_kernel_matches_plain(N, H, cuda_device):
    B, D = 2, 64
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in _arrays((B, N, H * D)))
    n, nq = TFA.flash_attention_packed_i8qk.launches, TFA.quantize_rows.launches
    got = TFA.flash_attention_packed_i8qk(q, k, v, D ** -0.5, H)
    torch.cuda.synchronize()
    assert TFA.flash_attention_packed_i8qk.launches == n + 1
    assert TFA.quantize_rows.launches == nq + 1  # q and k in one quantising launch
    want = TFA.flash_attention_packed_i8qk_plain(q.float(), k.float(), v.float(), D ** -0.5, H)
    assert float((got.float() - want).abs().max()) <= 2e-2


# --------------------- the int8 instantiation of the program: K10, K10b, K9 ----
I8QK_LENGTHS = [1, 63, 64, 65, 257, 416, 481, 1370]
I8QK_KERNELS = ["K10", "K10b", "K9"]


def _i8qk_call(kernel, q, k, v, row, scale, H):
    if kernel == "K10":
        return (TFA.flash_attention_packed_i8qk(q, k, v, scale, H),
                TFA.flash_attention_packed_i8qk_plain(q.float(), k.float(), v.float(), scale, H))
    if kernel == "K9":
        return (TFA.flash_attention_packed_int8(q, k, v, scale, H),
                TFA.flash_attention_packed_int8_plain(q.float(), k.float(), v.float(), scale, H))
    return (TFA.flash_attention_packed_i8qk_bias(q, k, v, row, scale, H),
            TFA.flash_attention_packed_i8qk_bias_plain(q.float(), k.float(), v.float(), row,
                                                       scale, H))


@pytest.mark.cuda
@pytest.mark.parametrize("N", I8QK_LENGTHS)
@pytest.mark.parametrize("H", [12, 16])
@pytest.mark.parametrize("kernel", I8QK_KERNELS)
def test_i8qk_program_matches_plain_at_every_length(kernel, H, N, cuda_device):
    """K10, K10b (bias: log counts on every key) and K9 (scales per (row,
    head)) at lengths around the 64-row tiles and the model's stream lengths,
    ViT-B's 12 heads and ViT-L's 16: atol 2e-2 (bf16 outputs, P rounded before
    P V); one attention launch and one quantising launch a call (K9's:
    quantize_heads); K10b on a zero row gives K10's bits."""
    B, D = 2, 64
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in _arrays((B, N, H * D), seed=N))
    row = _bias_row(B, N, "every_key", cuda_device)
    wrapper = {"K10": TFA.flash_attention_packed_i8qk, "K10b": TFA.flash_attention_packed_i8qk_bias,
               "K9": TFA.flash_attention_packed_int8}[kernel]
    quant = TFA.quantize_heads if kernel == "K9" else TFA.quantize_rows
    n, nq = wrapper.launches, quant.launches
    got, want = _i8qk_call(kernel, q, k, v, row, D ** -0.5, H)
    torch.cuda.synchronize()
    assert (wrapper.launches, quant.launches) == (n + 1, nq + 1)
    assert bool(torch.isfinite(got).all())
    assert float((got.float() - want).abs().max()) <= 2e-2
    if kernel == "K10b":
        zero = torch.zeros(B, N, device=cuda_device)
        assert torch.equal(TFA.flash_attention_packed_i8qk_bias(q, k, v, zero, D ** -0.5, H),
                           TFA.flash_attention_packed_i8qk(q, k, v, D ** -0.5, H))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [65, 481, 1370])
@pytest.mark.parametrize("kernel", I8QK_KERNELS)
def test_i8qk_rows_of_full_scale(kernel, N, cuda_device):
    """Every q and k value at +-127 after quantisation (rows of +-1: the
    integer sums reach 64 x 127^2, where an f32 conversion that is not exact
    would show): atol 2e-2 against the plain version's exact product."""
    B, H, D = 2, 12, 64
    r = np.random.RandomState(N)
    q, k = (torch.from_numpy(np.where(r.rand(B, N, H * D) < 0.5, -1.0, 1.0).astype(np.float32))
            .to(cuda_device, torch.bfloat16) for _ in range(2))
    (v,) = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
            for a in _arrays((B, N, H * D), n=1, seed=N))
    assert bool((TFA.quantize_rows(q)[0].abs() == 127).all())
    row = _bias_row(B, N, "groups", cuda_device)
    got, want = _i8qk_call(kernel, q, k, v, row, D ** -0.5, H)
    torch.cuda.synchronize()
    assert float((got.float() - want).abs().max()) <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("N", [65, 257, 1370])
@pytest.mark.parametrize("kernel", I8QK_KERNELS)
def test_i8qk_program_keeps_keys_in_place(kernel, N, cuda_device):
    """The permutation probe of K1's program on the int8 one: V one-hot by
    key index (V[b, j, h, d] = 1 where j % 64 == d), q = 40 k with k one-hot
    the same way, so that each quantised row holds one 127 and row i's output
    is one-hot at i % 64; a key moved inside a tile or a stage costs an error
    of 1. K10b with a zero row."""
    B, H, D = 2, 4, 64
    onehot = torch.zeros(B, N, H, D, device=cuda_device)
    j = torch.arange(N, device=cuda_device)
    onehot[:, j, :, j % D] = 1.0
    k = onehot.reshape(B, N, H * D).to(torch.bfloat16)
    q = (40.0 * onehot).reshape(B, N, H * D).to(torch.bfloat16)
    row = torch.zeros(B, N, device=cuda_device)
    got, want = _i8qk_call(kernel, q, k, k, row, 1.0, H)
    torch.cuda.synchronize()
    hot = (j % D)[None, :, None].expand(B, N, H)
    assert torch.equal(want.view(B, N, H, D).argmax(-1), hot)
    assert float((got.float() - want).abs().max()) <= 2e-2
    assert torch.equal(got.view(B, N, H, D).float().argmax(-1), hot)


@pytest.mark.cuda
@pytest.mark.parametrize("N,H", [(481, 12), (1370, 12), (257, 16), (65, 16)])
def test_k9_is_k10_where_every_head_shares_the_row_maximum(N, H, cuda_device):
    """Where every head of a row has the same largest |value|, its (row, head)
    scales are K10's joint-row scales and its int8 rows are K10's: K9 gives
    K10's bits (the one program, on scales read [B, H, N] in place of
    [B, N])."""
    B = 2
    q, k, v = (torch.from_numpy(a * 0.5).to(cuda_device, torch.bfloat16)
               for a in _arrays((B, N, H * 64), seed=N + H))
    for t in (q, k):
        t.view(B, N, H, 64)[..., 5] = 3.0
    got9 = TFA.flash_attention_packed_int8(q, k, v, 0.125, H)
    got10 = TFA.flash_attention_packed_i8qk(q, k, v, 0.125, H)
    torch.cuda.synchronize()
    assert torch.equal(got9, got10)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 481, 768), (8, 1370, 768), (2, 257, 1024), (1, 1, 128)])
def test_quantize_heads_kernel_matches_plain(shape, cuda_device):
    """K9's quantiser: q and k in one launch, per (row, head) over each
    head's 64 values, scales [B, H, N]; int8 values and scales bit for bit
    the plain version's (both divide in f32, round half to even, clip)."""
    B, N, HD = shape
    H = HD // 64
    a, b = _arrays(shape, n=2, seed=6, scale=2.0)
    a *= np.random.RandomState(7).rand(B, N, H).repeat(64, axis=-1)
    q, k = (torch.from_numpy(t).to(cuda_device, torch.bfloat16) for t in (a, b))
    q.view(B, N, H, 64)[0, 0, 0] = 0.0  # a head's slice of zeros: the 1e-12 floor
    n = TFA.quantize_heads.launches
    got = TFA.quantize_heads(q, H, k)
    torch.cuda.synchronize()
    assert TFA.quantize_heads.launches == n + 1
    want = TFA.quantize_heads_plain(q, H, k)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
    assert got[1].shape == (B, H, N) and float(got[1][0, 0, 0]) == np.float32(1e-12)


@pytest.mark.cuda
def test_i8qk_blocks_per_sm_are_reported(cuda_device):
    """The occupancy query of each instantiation answers (at least one
    block an SM); the int8 one needs less shared memory than K1's."""
    lib = _build.library()
    for bias in (0, 1):
        for i8qk in (0, 1):
            assert lib.caim_flash_blocks_per_sm(bias, i8qk) >= 1
    assert lib.caim_flash_blocks_per_sm(0, 1) >= lib.caim_flash_blocks_per_sm(0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 481, 768), (8, 1370, 768), (2, 257, 1024), (1, 1, 64)])
def test_quantize_rows_of_q_and_k_in_one_launch(shape, cuda_device):
    """q and k quantised together: one launch, each tensor's int8 values
    and scales bit-equal to the plain version's, and to the one-tensor
    kernel's."""
    a, b = _arrays(shape, n=2, seed=5, scale=2.0)
    q, k = (torch.from_numpy(t).to(cuda_device, torch.bfloat16) for t in (a, b))
    n = TFA.quantize_rows.launches
    got = TFA.quantize_rows(q, k)
    assert TFA.quantize_rows.launches == n + 1
    want = TFA.quantize_rows_plain(q, k)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype and torch.equal(g, w)
    assert all(torch.equal(g, w) for g, w in zip(got, (*TFA.quantize_rows(q),
                                                       *TFA.quantize_rows(k))))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 481, 768), (2, 257, 1024)])
def test_quantize_rows_kernel_matches_plain(shape, cuda_device):
    """Kernel and plain version both divide by 127 (the plain version by a
    tensor on the card: by a Python scalar PyTorch's CUDA division multiplies
    by the rounded reciprocal), round half to even and clip in float32: the
    int8 values and the scales are equal bit for bit."""
    (x,) = _arrays(shape, n=1, seed=4, scale=2.0)
    x = torch.from_numpy(x).to(cuda_device, torch.bfloat16)
    n = TFA.quantize_rows.launches
    x8, sx = TFA.quantize_rows(x)
    p8, ps = TFA.quantize_rows_plain(x)
    assert TFA.quantize_rows.launches == n + 1
    assert x8.dtype == torch.int8 and sx.shape == (*shape[:2], 1)
    assert torch.equal(x8, p8) and torch.equal(sx, ps)


@pytest.mark.cuda
def test_quantize_rows_raises_on_what_the_kernel_does_not_take(cuda_device):
    """On the card the wrapper launches its kernel or raises; it never takes
    the plain version there."""
    n, n10 = TFA.quantize_rows.launches, TFA.flash_attention_packed_i8qk.launches
    ok = torch.zeros(2, 10, 1024, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(TypeError):  # float32 rows
        TFA.quantize_rows(ok.float())
    for bad in (torch.zeros(2, 10, 1088, device=cuda_device, dtype=torch.bfloat16),  # too wide
                torch.zeros(2, 10, 68, device=cuda_device, dtype=torch.bfloat16),  # not 8 k
                ok[:, :, ::2],  # not contiguous
                ok.reshape(-1)[4:4 + 2 * 9 * 1024].view(2, 9, 1024)):  # 8-byte aligned
        with pytest.raises(ValueError):
            TFA.quantize_rows(bad)
    for other in (ok[:, :9], ok.float(), ok[:, :, ::2]):  # q and k that differ
        with pytest.raises(ValueError):
            TFA.quantize_rows(ok, other)
    assert TFA.quantize_rows.launches == n
    y = torch.zeros(1, 10, 17 * 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # 17 heads: wider than the quantising kernel takes
        TFA.flash_attention_packed_i8qk(y, y, y, 0.125, 17)
    assert (TFA.quantize_rows.launches, TFA.flash_attention_packed_i8qk.launches) == (n, n10)


@pytest.mark.cuda
def test_filter_attention_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    x = torch.zeros(1, 10, 96, device=cuda_device, dtype=torch.bfloat16)  # not H * 64
    row = torch.zeros(1, 10, device=cuda_device)
    for call in (lambda: TFA.flash_attention_packed_bias(x, x, x, row, 0.125, 2),
                 lambda: TFA.flash_attention_packed_i8qk(x, x, x, 0.125, 2),
                 lambda: TFA.flash_attention_packed_i8qk_bias(x, x, x, row, 0.125, 2)):
        with pytest.raises(ValueError):
            call()
    y = torch.zeros(1, 10, 128, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # a bias row of another length
        TFA.flash_attention_packed_bias(y, y, y, torch.zeros(1, 9, device=cuda_device), 0.125, 2)
    with pytest.raises(ValueError):  # a bias row on another device
        TFA.flash_attention_packed_i8qk_bias(y, y, y, torch.zeros(1, 10), 0.125, 2)
    before = [w.launches for w in TFA.WRAPPERS]
    with pytest.raises(TypeError):  # the int8-QK^T kernel takes bf16 only
        TFA.flash_attention_packed_i8qk(y.float(), y.float(), y.float(), 0.125, 2)
    assert [w.launches for w in TFA.WRAPPERS] == before


@pytest.mark.cuda
@pytest.mark.parametrize("impl,want", [("pallas_packed", [1, 2, 0, 0]),
                                       ("pallas_packed_i8qk", [0, 0, 1, 2])])
def test_filtered_model_counts_its_launches(impl, want, cuda_device):
    """A 3-layer int8 model with the filter '1:0.5@p': block 0 runs the
    unbiased attention, blocks 1 and 2 the biased one."""
    from cognitive_aim_tpu_torch.core.precision import policy_from_name
    from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel
    from cognitive_aim_tpu_torch.models.config import ModelArchConfig, parse_token_filter
    from cognitive_aim_tpu_torch.nn.dinov2 import DinoV2Config

    vit = DinoV2Config(hidden_size=128, num_layers=3, num_heads=2, pretrain_image_size=56,
                       gelu_approx=True)
    arch = ModelArchConfig(num_iterations=2, image_size=112, **parse_token_filter("1:0.5@p"))
    model = CognitiveAimModel(arch, policy_from_name("int8"), impl, vit_cfg=vit)
    model.init(torch.Generator(device="cuda").manual_seed(0)).prepare_params()
    x = torch.randn(3, 112, 112, 3, device=cuda_device)
    g = torch.tensor([0, 4, 8], device=cuda_device)
    counters = TFA.WRAPPERS[:4]
    for w in counters:
        w.launches = 0
    out = model(x, guidance=g)
    torch.cuda.synchronize()
    assert [w.launches for w in counters] == want
    model.attn_impl = impl.replace("pallas_packed", "plain")
    ref = model(x, guidance=g)
    torch.testing.assert_close(out.depth, ref.depth, atol=0, rtol=2e-2)
    torch.testing.assert_close(out.confidence, ref.confidence, atol=0, rtol=2e-2)


# ------------------------------------------------------------ int8 kernels ----
def _int8_inputs(B, N, D, F, dev, seed=0):
    r = np.random.RandomState(seed)

    def f(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((r.randn(*shape) * scale + shift).astype(np.float32)).to(dev)

    def vec(n, scale, shift=0.0):  # f32 at bf16-rounded values, as prepare_params leaves them
        return f(n, scale=scale, shift=shift).bfloat16().float()

    t = {"x": f(B, N, D).bfloat16(), "ctx": f(B, N, D).bfloat16(),
         "g": vec(D, 0.1, 1.0), "be": vec(D, 0.05), "ls": vec(D, 0.1, 0.9)}
    for name, n, k in (("qkv", 3 * D, D), ("out", D, D), ("fc1", F, D), ("fc2", D, F)):
        w = quantize_weight(f(n, k, scale=0.05))
        t[name] = (w["q"], w["s"], vec(n, 0.01))
    return t


def _assert_bf16_close(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.is_contiguous() and g.shape == w.shape
        lim = 1e-2 * max(1.0, float(w.float().abs().max()))
        assert float((g.float() - w.float()).abs().max()) <= lim


SHAPES = [(2, 1370, 768, 3072), (3, 257, 768, 3072), (2, 481, 768, 3072),
          (1, 100, 1024, 4096), (1, 17, 128, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B%d-N%d-D%d-F%d" % s)
@pytest.mark.parametrize("kernel", ["K2", "K5", "K3", "K4b", "K4"])
def test_int8_kernel_matches_plain(kernel, shape, cuda_device):
    t = _int8_inputs(*shape, cuda_device)
    x, ctx, g, be, ls = t["x"], t["ctx"], t["g"], t["be"], t["ls"]
    h8, sh = TIB.int8_fc1_gelu_ln_plain(x, g, be, *t["fc1"])
    wrapper, plain, args = {
        # K2 and K5: the plain version's packed [3, B, N, D] as the wrapper's q, k, v
        "K2": (TIB.int8_qkv_proj_ln, lambda *a: TIB.int8_qkv_proj_ln_plain(*a).unbind(0),
               (x, g, be, *t["qkv"])),
        "K5": (TIB.int8_qkv_proj, lambda *a: TIB.int8_qkv_proj_plain(*a).unbind(0),
               (x, *t["qkv"])),
        "K3": (TIB.int8_out_residual, TIB.int8_out_residual_plain, (ctx, *t["out"], ls, x)),
        "K4b": (TIB.int8_out_residual_prequant, TIB.int8_out_residual_prequant_plain,
                (h8, sh, *t["fc2"], ls, x)),
        "K4": (TIB.int8_mlp_ln, TIB.int8_mlp_ln_plain, (x, g, be, *t["fc1"], *t["fc2"], ls)),
    }[kernel]
    n = wrapper.launches
    got = wrapper(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == n + 1
    _assert_bf16_close(got, plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B%d-N%d-D%d-F%d" % s)
def test_k4a_kernel_matches_plain(shape, cuda_device):
    t = _int8_inputs(*shape, cuda_device, seed=1)
    args = (t["x"], t["g"], t["be"], *t["fc1"])
    h8, sh = TIB.int8_fc1_gelu_ln(*args)
    torch.cuda.synchronize()
    h8p, shp = TIB.int8_fc1_gelu_ln_plain(*args)
    assert h8.dtype == torch.int8 and sh.dtype == torch.float32 and sh.shape == shp.shape
    diff = (h8.int() - h8p.int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 1e-2
    srel = (sh - shp).abs() / shp
    assert float((srel > 2e-4).float().mean()) < 1e-3 and float(srel.max()) <= 5e-3


@pytest.mark.cuda
def test_k4b_is_exact_on_the_same_int8_input(cuda_device):
    """No quantising prologue: the same integers, the same f32 epilogue."""
    t = _int8_inputs(2, 300, 768, 3072, cuda_device, seed=2)
    h8, sh = TIB.int8_fc1_gelu_ln_plain(t["x"], t["g"], t["be"], *t["fc1"])
    got = TIB.int8_out_residual_prequant(h8, sh, *t["fc2"], t["ls"], t["x"])
    want = TIB.int8_out_residual_prequant_plain(h8, sh, *t["fc2"], t["ls"], t["x"])
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_int8_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    t = _int8_inputs(2, 40, 256, 512, cuda_device)
    x, g, be, ls = t["x"], t["g"], t["be"], t["ls"]
    with pytest.raises(TypeError):  # f32 activations
        TIB.int8_qkv_proj_ln(x.float(), g, be, *t["qkv"])
    with pytest.raises(TypeError):
        TIB.int8_out_residual(x.float(), *t["out"], ls, x)
    with pytest.raises(TypeError):  # the kernel writes bf16 only
        TIB.int8_qkv_proj(x, *t["qkv"], out_dtype=torch.float32)
    strided = torch.empty(2, 40, 512, device=cuda_device, dtype=torch.bfloat16)[..., :256]
    assert not strided.is_contiguous()
    with pytest.raises(ValueError):
        TIB.int8_qkv_proj(strided, *t["qkv"])
    with pytest.raises(ValueError):
        TIB.int8_fc1_gelu_ln(strided, g, be, *t["fc1"])
    with pytest.raises(ValueError):  # bf16 vectors: the kernels read f32
        TIB.int8_qkv_proj_ln(x, g.bfloat16(), be, *t["qkv"])
    wq, ws, b = t["out"]
    with pytest.raises(ValueError):  # a weight that is a transposed view
        TIB.int8_out_residual(x, wq.t(), ws, b, ls, x)
    narrow = _int8_inputs(1, 8, 192, 384, cuda_device)  # widths not multiples of 128
    with pytest.raises(ValueError):
        TIB.int8_qkv_proj(narrow["x"], *narrow["qkv"])
    before = [w.launches for w in TIB.WRAPPERS]
    with pytest.raises(TypeError):
        TIB.int8_mlp_ln(x.float(), g, be, *t["fc1"], *t["fc2"], ls)
    assert [w.launches for w in TIB.WRAPPERS] == before


@pytest.mark.cuda
def test_int8_model_counts_its_launches(cuda_device):
    """A 2-layer int8 model at kernel-sized widths: every block launches K2,
    K1, K3 and K4 (K4a + K4b), every focal iteration K5 and K6."""
    from cognitive_aim_tpu_torch.core.precision import policy_from_name
    from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel
    from cognitive_aim_tpu_torch.models.config import ModelArchConfig
    from cognitive_aim_tpu_torch.nn.dinov2 import DinoV2Config

    vit = DinoV2Config(hidden_size=128, num_layers=2, num_heads=2, pretrain_image_size=56,
                       gelu_approx=True)
    arch = ModelArchConfig(num_iterations=2, image_size=70)
    model = CognitiveAimModel(arch, policy_from_name("int8"), vit_cfg=vit)
    assert next(model.parameters()).device.type == "cuda"  # no device argument
    model.init(torch.Generator(device="cuda").manual_seed(0)).prepare_params()
    x = torch.randn(3, 70, 70, 3, device=cuda_device)
    counters = (*TIB.WRAPPERS, TFA.flash_attention_packed, TFO.focal_attention_fused)
    for w in counters:
        w.launches = 0
    out = model(x, guidance=torch.tensor([0, 4, 8], device=cuda_device))
    torch.cuda.synchronize()
    # K2, K5, K3, K4a, K4b, K4, then K13 and K14 (no caller in the model) and K12
    # (the variable is unset), K1, K6
    assert [w.launches for w in counters] == [2, 2, 2, 2, 2, 2, 0, 0, 0, 2, 2]
    model.attn_impl = "plain"
    ref = model(x, guidance=torch.tensor([0, 4, 8], device=cuda_device))
    torch.testing.assert_close(out.depth, ref.depth, atol=0, rtol=2e-2)
    torch.testing.assert_close(out.confidence, ref.confidence, atol=0, rtol=2e-2)


# ------------------------------ the one-pass fc1 GEMM of K4a and K14 ----
# (B, N, K, F): the slice's M 10960, the filtered stream's 8 x 481, ViT-L
# widths, a row count under one tile, and the smallest width
FC1_SHAPES = [(8, 1370, 768, 3072), (8, 481, 768, 3072), (1, 100, 1024, 4096),
              (1, 17, 128, 256), (2, 40, 256, 512)]


def _exact_ln_rows(B, N, D, dev, seed):
    """bf16 rows of integers with a zero mean (each row holds +-1, +-2 in
    equal numbers, shuffled): the layernorm's sums are exact in any order, so
    K4a's prologue gives the plain version's bits and the whole kernel can be
    held to them."""
    r = np.random.RandomState(seed)
    base = np.tile(np.array([1.0, -1.0, 2.0, -2.0], np.float32), D // 4)
    rows = np.stack([r.permutation(base) for _ in range(B * N)]).reshape(B, N, D)
    return torch.from_numpy(rows).to(dev).bfloat16()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FC1_SHAPES, ids=lambda s: "B%d-N%d-D%d-F%d" % s)
@pytest.mark.parametrize("kernel", ["K4a", "K14"])
def test_fc1_gemm_is_bit_equal_to_plain(kernel, shape, cuda_device):
    """One GEMM pass, the rows' maxima exchanged across a thread-block
    cluster: h8 and sh the plain version's bits. K14 on random rows, K4a on
    rows whose layernorm is exact (random rows: test_k4a_kernel_matches_plain)."""
    B, N, D, F = shape
    t = _int8_inputs(B, N, D, F, cuda_device, seed=3)
    if kernel == "K4a":
        x = _exact_ln_rows(B, N, D, cuda_device, seed=4)
        wrapper, plain, args = TIB.int8_fc1_gelu_ln, TIB.int8_fc1_gelu_ln_plain, \
            (x, t["g"], t["be"], *t["fc1"])
    else:
        wrapper, plain, args = TIB.int8_fc1_gelu, TIB.int8_fc1_gelu_plain, (t["x"], *t["fc1"])
    n = wrapper.launches
    h8, sh = wrapper(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == n + 1
    h8p, shp = plain(*args)
    assert torch.equal(h8, h8p) and torch.equal(sh, shp)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K4a", "K14"])
def test_fc1_rows_of_zeros_take_the_scale_floor(kernel, cuda_device):
    """Rows whose hidden is all zero (zero rows, zero biases) get the 1e-12
    floor of the scale and zeros, beside ordinary rows of the same tile."""
    B, N, D, F = 2, 70, 768, 3072
    t = _int8_inputs(B, N, D, F, cuda_device, seed=5)
    x = t["x"].clone()
    x[0, 3] = 0.0
    x[1, 64:] = 0.0
    wq, ws, _ = t["fc1"]
    zero_b, zero_be = torch.zeros_like(t["fc1"][2]), torch.zeros_like(t["be"])
    if kernel == "K4a":
        args = (x, t["g"], zero_be, wq, ws, zero_b)
        h8, sh = TIB.int8_fc1_gelu_ln(*args)
        h8p, shp = TIB.int8_fc1_gelu_ln_plain(*args)
    else:
        args = (x, wq, ws, zero_b)
        h8, sh = TIB.int8_fc1_gelu(*args)
        h8p, shp = TIB.int8_fc1_gelu_plain(*args)
    torch.cuda.synchronize()
    floor = torch.tensor(1e-12, device=cuda_device)
    for b, n in ((0, 3), (1, 64), (1, 69)):
        assert torch.equal(sh[b, n, 0], floor) and not h8[b, n].any()
    diff = (h8.int() - h8p.int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 1e-2
    if kernel == "K14":
        assert torch.equal(h8, h8p) and torch.equal(sh, shp)


@pytest.mark.cuda
@pytest.mark.parametrize("D,F", [(128, 256), (768, 3072), (1024, 4096)])
def test_fc1_cluster_probe_takes_each_rows_scale_from_a_peer(D, F, cuda_device):
    """A cluster probe: one column of large bias planted in each CTA's range
    of columns in turn, so every row's maximum lies in that CTA alone and the
    other CTAs must read it through distributed shared memory. A CTA that
    quantised with its own maximum would clip to +-127 where the plain
    version does not."""
    B, N = 2, 200
    t = _int8_inputs(B, N, D, F, cuda_device, seed=6)
    wq, ws, b = t["fc1"]
    ctas, cols = TIB.fc1_cluster_shape(F)
    assert ctas > 1
    for q in range(ctas):
        planted = b.clone()
        planted[q * cols + cols // 2] = 30.0
        h8, sh = TIB.int8_fc1_gelu(t["x"], wq, ws, planted)
        torch.cuda.synchronize()
        h8p, shp = TIB.int8_fc1_gelu_plain(t["x"], wq, ws, planted)
        assert torch.equal(h8, h8p) and torch.equal(sh, shp)
        # every row's maximum is the planted column's
        assert bool((h8[..., q * cols + cols // 2].int().abs() == 127).all())
        others = torch.cat([h8[..., :q * cols], h8[..., (q + 1) * cols:]], dim=-1)
        assert int(others.int().abs().max()) < 127


@pytest.mark.cuda
def test_fc1_cluster_shape_is_the_librarys(cuda_device):
    """The wrappers' width rule (int8_block.fc1_cluster_shape) and the C
    dispatch (caim_fc1_cluster_size) agree at every width up to 8192."""
    lib = _build.library()
    for F in range(0, 8193, 64):
        shape = TIB.fc1_cluster_shape(F)
        assert lib.caim_fc1_cluster_size(F) == (0 if shape is None else shape[0]), F


@pytest.mark.cuda
def test_fc1_wrappers_raise_on_widths_no_cluster_splits(cuda_device):
    t = _int8_inputs(1, 8, 128, 2176, cuda_device)  # 17 x 128: no cluster of <= 8 CTAs
    assert TIB.fc1_cluster_shape(2176) is None
    before = [w.launches for w in TIB.WRAPPERS]
    with pytest.raises(ValueError):
        TIB.int8_fc1_gelu(t["x"], *t["fc1"])
    with pytest.raises(ValueError):
        TIB.int8_fc1_gelu_ln(t["x"], t["g"], t["be"], *t["fc1"])
    assert [w.launches for w in TIB.WRAPPERS] == before


# ------------------------------------------------------ K13, K14, K15 ----
# (B, N, K, Nout): attn_out, fc1, fc2 (rows 3072 wide: the two-pass prologue),
# qkv, ViT-L widths, ragged N, one row tile
PROJ_SHAPES = [(8, 1370, 768, 768), (8, 1370, 768, 3072), (8, 1370, 3072, 768),
               (8, 1370, 768, 2304), (2, 257, 1024, 4096), (2, 257, 4096, 1024),
               (8, 481, 768, 2304), (8, 257, 768, 768), (1, 17, 128, 256)]


def _proj_inputs(B, N, K, Nout, dev, seed=0):
    r = np.random.RandomState(seed)
    x = torch.from_numpy(r.randn(B, N, K).astype(np.float32)).to(dev).bfloat16()
    w = quantize_weight(torch.from_numpy((r.randn(Nout, K) * 0.05).astype(np.float32)).to(dev))
    b = torch.from_numpy((r.randn(Nout) * 0.01).astype(np.float32)).to(dev).bfloat16().float()
    return x, w, b


@pytest.mark.cuda
@pytest.mark.parametrize("shape", PROJ_SHAPES, ids=lambda s: "B%d-N%d-K%d-N%d" % s)
@pytest.mark.parametrize("kernel", ["K13", "K15"])
def test_int8_linear_kernels_match_plain(kernel, shape, cuda_device):
    """K13 on [B, N, K], K15 on the flattened rows (M 10960 at the slice
    shape, 8 x 481 after the filter) and through ``int8_linear_fused``."""
    B, N, K, Nout = shape
    x, w, b = _proj_inputs(*shape, cuda_device)
    if kernel == "K13":
        n = TIB.int8_proj.launches
        got = TIB.int8_proj(x, w["q"], w["s"], b)
        assert TIB.int8_proj.launches == n + 1
        want = TIB.int8_proj_plain(x, w["q"], w["s"], b)
    else:
        n, n13 = TIG.int8_gemm_fused.launches, TIB.int8_proj.launches
        got2 = TIG.int8_gemm_fused(x.view(B * N, K), w["q"], w["s"], b)
        got = TIG.int8_linear_fused(x, w, b)
        assert TIG.int8_gemm_fused.launches == n + 2 and TIB.int8_proj.launches == n13
        assert torch.equal(got2.view(B, N, Nout), got)
        want = TIG.int8_linear_fused_plain(x, w, b)
    torch.cuda.synchronize()
    assert got.shape == (B, N, Nout)
    _assert_bf16_close(got, want)


# ------------------------------------------ the int8 GEMM's program ----
# K2, K5 (kQKV), K3, K4b (kResidual), K13 and K15 (kPlain) run one
# persistent GEMM program whose tile is 128 rows by
# gemm_tile_cols columns. (D, F): ViT-B's widths, where the rule takes 192 for
# the qkv GEMMs at every row count and for N 768 at 8 x 481 and 8 x 257 rows,
# 128 for N 768 at M 10960 and for N 3072; ViT-L's (128 only); the test width
# 128. Rows: the slice's M 10960, the filtered streams' 8 x 481 and 8 x 257, a
# row count under one tile, one row.
GEMM_WIDTHS = [(768, 3072), (1024, 4096), (128, 512)]
GEMM_ROWS = [10960, 8 * 481, 8 * 257, 17, 1]
GEMM_EPILOGUES = ["K2", "K5", "K3", "K4b", "K13", "K15"]


@pytest.mark.cuda
def test_gemm_tile_cols_is_the_librarys(cuda_device):
    """The wrappers' width rule (int8_block.gemm_tile_cols) and the C
    dispatch (caim_gemm_tile_cols) agree at every width up to 8192, in one
    part and in three (the qkv GEMMs), at the row counts of the slices, of a
    single tile and of one row, on this card's SMs and on 132."""
    lib = _build.library()
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for M in (10960, 10952, 3848, 2056, 17, 1):
        for N in range(0, 8193, 32):
            for parts in (1, 3):
                for n_sm in {sms, 132}:
                    want = TIB.gemm_tile_cols(M, N, parts, n_sm) or 0
                    assert lib.caim_gemm_tile_cols(M, N, parts, n_sm) == want, (M, N, parts)


def _gemm_case(kernel, M, D, F, dev, seed):
    """(wrapper call, plain call, bit-equal?) of one epilogue on M rows: the
    plain version on the same int8 rows gives the kernel's bits but where a
    layernorm's summation order may move an int8 step (K2)."""
    t = _int8_inputs(1, M, D, F, dev, seed=seed)
    x, ctx, g, be, ls = t["x"], t["ctx"], t["g"], t["be"], t["ls"]
    x2 = x.view(M, D)
    h8, sh = TIB.int8_fc1_gelu_ln_plain(x, g, be, *t["fc1"])
    return {
        "K2": (lambda: TIB.int8_qkv_proj_ln(x, g, be, *t["qkv"]),
               lambda: TIB.int8_qkv_proj_ln_plain(x, g, be, *t["qkv"]).unbind(0), False),
        "K5": (lambda: TIB.int8_qkv_proj(x, *t["qkv"]),
               lambda: TIB.int8_qkv_proj_plain(x, *t["qkv"]).unbind(0), True),
        "K3": (lambda: TIB.int8_out_residual(ctx, *t["out"], ls, x),
               lambda: TIB.int8_out_residual_plain(ctx, *t["out"], ls, x), True),
        "K4b": (lambda: TIB.int8_out_residual_prequant(h8, sh, *t["fc2"], ls, x),
                lambda: TIB.int8_out_residual_prequant_plain(h8, sh, *t["fc2"], ls, x), True),
        "K13": (lambda: TIB.int8_proj(x, *t["fc1"]),
                lambda: TIB.int8_proj_plain(x, *t["fc1"]), True),
        "K15": (lambda: TIG.int8_gemm_fused(x2, *t["qkv"]),
                lambda: TIG.int8_gemm_fused_plain(x2, *t["qkv"]), True),
    }[kernel]


@pytest.mark.cuda
@pytest.mark.parametrize("M", GEMM_ROWS)
@pytest.mark.parametrize("D,F", GEMM_WIDTHS, ids=lambda v: str(v))
@pytest.mark.parametrize("kernel", GEMM_EPILOGUES)
def test_gemm_epilogues_match_plain_at_every_tile_width_and_row_count(kernel, D, F, M,
                                                                       cuda_device):
    """Every epilogue of the GEMM program at each tile width and ragged row
    count: the plain version's bits on the same int8 rows (K2 within
    the layernorm's tolerance)."""
    kern, plain, exact = _gemm_case(kernel, M, D, F, cuda_device, seed=M % 97 + D)
    got = kern()
    torch.cuda.synchronize()
    want = plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if exact:
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        _assert_bf16_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K3", "K13"])
def test_gemm_tile_counts_below_at_and_above_the_resident_ctas(kernel, cuda_device):
    """The persistent grid holds caim_gemm_resident_ctas CTAs at most: tile
    counts one under it (a CTA a tile, some SMs idle), equal to it, one over
    it (one CTA takes two tiles) and twice over it plus a ragged row tile
    give the plain version's bits. N 128: one column tile, so tiles = row
    tiles."""
    R = _build.library().caim_gemm_resident_ctas(128)
    assert TIB.gemm_tile_cols(1, 128) == 128
    assert R > 0
    for M in (128 * (R - 1) - 5, 128 * R, 128 * R + 1, 128 * 2 * R + 77):
        x, w, b = _proj_inputs(1, M, 256, 128, cuda_device, seed=M % 89)
        if kernel == "K13":
            got, want = TIB.int8_proj(x, w["q"], w["s"], b), TIB.int8_proj_plain(x, w["q"],
                                                                                 w["s"], b)
        else:
            res = torch.randn(1, M, 128, device=cuda_device).bfloat16()
            ls = torch.full((128,), 0.5, device=cuda_device)
            wo, x2 = quantize_weight(torch.randn(128, 256, device=cuda_device) * 0.05), x
            got = TIB.int8_out_residual(x2, wo["q"], wo["s"], b, ls, res)
            want = TIB.int8_out_residual_plain(x2, wo["q"], wo["s"], b, ls, res)
        torch.cuda.synchronize()
        assert torch.equal(got, want), M


@pytest.mark.cuda
@pytest.mark.parametrize("D", [768, 1024, 128])
@pytest.mark.parametrize("M", [17, 8 * 481, 10960])
def test_gemm_stores_no_row_past_m(D, M, cuda_device):
    """The TMA stores go through tensor maps of exactly M rows: an output that
    is the first M rows of a larger buffer leaves the rows past M as they
    were (kResidual, kPlain), and q, k, v in one [3, M, D] buffer followed by
    more memory leave that memory alone (kQKV)."""
    from cognitive_aim_tpu_torch.kernels._launch import ptr, stream_of

    lib = _build.library()
    t = _int8_inputs(1, M, D, 4 * D, cuda_device, seed=D + M)
    x, ls = t["x"].view(M, D), t["ls"]
    xq, sx = TIB.quantize_activations(t["ctx"].view(M, D).float())
    sx = sx.contiguous()
    sentinel = torch.tensor(-3.0e38, device=cuda_device).bfloat16()
    for name in ("K3", "K13"):
        big = torch.full((M + 200, D), float(sentinel), device=cuda_device,
                         dtype=torch.bfloat16)
        wq, ws, b = t["out"]
        if name == "K3":
            err = lib.caim_int8_out_residual(None, ptr(xq), ptr(sx), ptr(wq), ptr(ws), ptr(b),
                                             ptr(ls), ptr(x), ptr(big), M, D, D,
                                             stream_of(x))
            want = TIB.int8_out_residual_prequant_plain(xq, sx, wq, ws, b, ls, x)
        else:
            scratch = torch.empty_like(xq), torch.empty_like(sx)
            err = lib.caim_int8_proj(ptr(t["ctx"]), ptr(scratch[0]), ptr(scratch[1]), ptr(wq),
                                     ptr(ws), ptr(b), ptr(big), M, D, D, stream_of(x))
            want = TIB.int8_proj_plain(t["ctx"].view(M, D), wq, ws, b)
        torch.cuda.synchronize()
        assert err == 0
        assert torch.equal(big[:M], want)
        assert bool((big[M:] == sentinel).all()), name
    tail = 4096
    buf = torch.full((3 * M * D + tail,), float(sentinel), device=cuda_device,
                     dtype=torch.bfloat16)
    wq, ws, b = t["qkv"]
    scratch = torch.empty_like(xq), torch.empty_like(sx)
    err = lib.caim_int8_qkv(ptr(x), None, None, 0.0, ptr(wq), ptr(ws), ptr(b), ptr(buf),
                            ptr(scratch[0]), ptr(scratch[1]), M, D, stream_of(x))
    torch.cuda.synchronize()
    assert err == 0
    want = TIB.int8_qkv_proj_plain(x, wq, ws, b)
    for i in range(3):
        assert torch.equal(buf[i * M * D:(i + 1) * M * D].view(M, D), want[i])
    assert bool((buf[3 * M * D:] == sentinel).all())


@pytest.mark.cuda
def test_gemm_wrappers_raise_on_widths_no_tile_divides(cuda_device):
    """Output widths that neither 192 nor 128 divides (320 = 5 x 64) raise
    before any launch, on every wrapper of the GEMM program."""
    assert TIB.gemm_tile_cols(40, 320) is None
    x, w, b = _proj_inputs(1, 40, 256, 320, cuda_device)
    res = torch.zeros(1, 40, 320, device=cuda_device, dtype=torch.bfloat16)
    ls = torch.ones(320, device=cuda_device)
    before = [f.launches for f in (*TIB.WRAPPERS, *TIG.WRAPPERS)]
    with pytest.raises(ValueError):
        TIB.int8_proj(x, w["q"], w["s"], b)
    with pytest.raises(ValueError):
        TIG.int8_gemm_fused(x.view(40, 256), w["q"], w["s"], b)
    with pytest.raises(ValueError):
        TIB.int8_out_residual(x, w["q"], w["s"], b, ls, res)
    assert [f.launches for f in (*TIB.WRAPPERS, *TIG.WRAPPERS)] == before


@pytest.mark.cuda
def test_wide_rows_quantise_as_narrow_ones(cuda_device):
    """The two-pass prologue (K > 1024) and the register prologue give the
    same int8 rows: a [M, 2048] input whose right half is zero projects as its
    left half does through the left half of the weight."""
    x, w, b = _proj_inputs(2, 300, 1024, 256, cuda_device, seed=3)
    wide_x = torch.cat([x, torch.zeros_like(x)], dim=-1)
    wide_w = torch.cat([w["q"], torch.zeros_like(w["q"])], dim=-1).contiguous()
    assert torch.equal(TIB.int8_proj(wide_x, wide_w, w["s"], b),
                       TIB.int8_proj(x, w["q"], w["s"], b))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "B%d-N%d-D%d-F%d" % s)
def test_k14_kernel_matches_plain_on_raw_and_layernormed_rows(shape, cuda_device):
    t = _int8_inputs(*shape, cuda_device, seed=1)
    args = (t["x"], *t["fc1"])
    n, n4a = TIB.int8_fc1_gelu.launches, TIB.int8_fc1_gelu_ln.launches
    h8, sh = TIB.int8_fc1_gelu(*args)
    torch.cuda.synchronize()
    assert TIB.int8_fc1_gelu.launches == n + 1 and TIB.int8_fc1_gelu_ln.launches == n4a
    h8p, shp = TIB.int8_fc1_gelu_plain(*args)
    assert h8.dtype == torch.int8 and sh.dtype == torch.float32 and sh.shape == shp.shape
    diff = (h8.int() - h8p.int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 1e-2
    srel = (sh - shp).abs() / shp
    assert float((srel > 2e-4).float().mean()) < 1e-3 and float(srel.max()) <= 5e-3
    # rows that the plain layernorm normalised, as the JAX package's tests feed it
    normed = TIB._ln_f32(t["x"].float(), t["g"], t["be"], 1e-6).bfloat16()
    a8, sa = TIB.int8_fc1_gelu(normed, *t["fc1"])
    b8, sb = TIB.int8_fc1_gelu_plain(normed, *t["fc1"])
    d2 = (a8.int() - b8.int()).abs()
    assert int(d2.max()) <= 1 and float((d2 > 0).float().mean()) < 1e-2
    assert float(((sa - sb).abs() / sb).max()) <= 5e-3


@pytest.mark.cuda
def test_int8_linear_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    x, w, b = _proj_inputs(2, 40, 256, 512, cuda_device)
    before = [f.launches for f in (*TIB.WRAPPERS, *TIG.WRAPPERS)]
    with pytest.raises(TypeError):  # f32 rows
        TIB.int8_proj(x.float(), w["q"], w["s"], b)
    with pytest.raises(TypeError):
        TIG.int8_linear_fused(x.float(), w, b)
    with pytest.raises(TypeError):  # the kernel writes bf16 only
        TIG.int8_gemm_fused(x.view(80, 256), w["q"], w["s"], b, torch.float32)
    with pytest.raises(TypeError):
        TIB.int8_fc1_gelu(x.float(), w["q"], w["s"], b)
    strided = torch.empty(2, 40, 512, device=cuda_device, dtype=torch.bfloat16)[..., :256]
    with pytest.raises(ValueError):
        TIB.int8_proj(strided, w["q"], w["s"], b)
    with pytest.raises(ValueError):  # a [M, K] view with a row stride
        TIG.int8_gemm_fused(strided[0], w["q"], w["s"], b)
    narrow = _proj_inputs(1, 8, 192, 384, cuda_device)  # widths not multiples of 128
    with pytest.raises(ValueError):
        TIB.int8_proj(narrow[0], narrow[1]["q"], narrow[1]["s"], narrow[2])
    with pytest.raises(ValueError):  # bf16 bias: the kernels read f32
        TIB.int8_proj(x, w["q"], w["s"], b.bfloat16())
    assert [f.launches for f in (*TIB.WRAPPERS, *TIG.WRAPPERS)] == before


# ------------------------------------------------ the adapter path ----
ADAPTER_CASES = {
    # name: (policy, attn_impl, fold, [K1, K8, K15, K2, K3, K4] launches in one forward)
    "default_attn_out": ("default", "pallas_packed", False, [2, 0, 0, 0, 0, 0]),
    "default_heads_route": ("default", "pallas", False, [0, 2, 0, 0, 0, 0]),
    "int8_live_adapters": ("int8", "pallas_packed", False, [2, 0, 2, 0, 0, 0]),
    "int8_folded": ("int8", "pallas_packed", True, [2, 0, 0, 2, 2, 2]),
    "int8_heads_route": ("int8", "pallas", False, [0, 2, 0, 0, 0, 0]),
}
PLAIN_OF = {"pallas_packed": "plain", "pallas": "plain_heads"}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ADAPTER_CASES))
def test_adapter_model_counts_its_launches(case, cuda_device):
    """A 2-layer model with rank-8 adapters on all four targets and non-zero
    B: live adapters under int8 take the unchained block (K15, no K2-K4), the
    fold brings the chained block back, ``attn_impl="pallas"`` takes K8."""
    from cognitive_aim_tpu_torch.core.precision import policy_from_name
    from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel
    from cognitive_aim_tpu_torch.models.config import ModelArchConfig
    from cognitive_aim_tpu_torch.nn.dinov2 import DinoV2Config

    policy, impl, fold, want = ADAPTER_CASES[case]
    vit = DinoV2Config(hidden_size=128, num_layers=2, num_heads=2, pretrain_image_size=56,
                       gelu_approx=True)
    arch = ModelArchConfig(num_iterations=2, image_size=70, use_lora=True, lora_rank=8,
                           lora_alpha=16, lora_targets=("qkv", "attn_out", "fc1", "fc2"))
    model = CognitiveAimModel(arch, policy_from_name(policy), impl, vit_cfg=vit)
    g = torch.Generator(device="cuda").manual_seed(0)
    model.init(g)
    for blk in model.backbone.layers:
        for target in ("qkv", "attn_out", "fc1", "fc2"):
            blk.adapter(target)[1].data.normal_(0.0, 0.05, generator=g)
    if fold:
        model.merge_lora_params()
    model.prepare_params()
    x = torch.randn(3, 70, 70, 3, device=cuda_device)
    gi = torch.tensor([0, 4, 8], device=cuda_device)
    counters = (TFA.flash_attention_packed, TFA.flash_attention, TIG.int8_gemm_fused,
                TIB.int8_qkv_proj_ln, TIB.int8_out_residual, TIB.int8_mlp_ln)
    for w in counters:
        w.launches = 0
    out = model(x, guidance=gi)
    torch.cuda.synchronize()
    assert [w.launches for w in counters] == want
    model.attn_impl = PLAIN_OF[impl]
    ref = model(x, guidance=gi)
    torch.testing.assert_close(out.depth, ref.depth, atol=0, rtol=2e-2)
    torch.testing.assert_close(out.confidence, ref.confidence, atol=0, rtol=2e-2)


# ------------------------------------------------------ K9, K11, K12 ----
FUSED_ATTN_SHAPES = [(8, 1370, 12), (8, 481, 12), (8, 257, 12), (2, 257, 16), (1, 33, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H", FUSED_ATTN_SHAPES)
def test_k9_kernel_matches_plain(B, N, H, cuda_device):
    """K9 through the ``int8_dots`` keyword of K1's wrapper: its own launch
    count, bf16 outputs within atol 2e-2 of the float32 plain version."""
    D = 64
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in _arrays((B, N, H * D), seed=N))
    n1, n9 = TFA.flash_attention_packed.launches, TFA.flash_attention_packed_int8.launches
    got = TFA.flash_attention_packed(q, k, v, D ** -0.5, H, int8_dots=True)
    torch.cuda.synchronize()
    assert TFA.flash_attention_packed_int8.launches == n9 + 1
    assert TFA.flash_attention_packed.launches == n1
    want = TFA.flash_attention_packed_int8_plain(q.float(), k.float(), v.float(), D ** -0.5, H)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert float((got.float() - want).abs().max()) <= 2e-2


@pytest.mark.cuda
def test_k9_zero_heads_take_the_scale_floor(cuda_device):
    """All-zero q and k quantise with the 1e-12 floor to zeros: the scores
    are 0, not NaN, and the output is the mean of v over the N valid keys."""
    z = torch.zeros(2, 70, 128, device=cuda_device, dtype=torch.bfloat16)
    v = torch.from_numpy(_arrays((2, 70, 128), n=1)[0]).to(cuda_device, torch.bfloat16)
    got = TFA.flash_attention_packed_int8(z, z, v, 0.125, 2)
    torch.cuda.synchronize()
    want = v.float().mean(dim=1, keepdim=True).expand(-1, 70, -1)
    assert bool(torch.isfinite(got).all())
    assert float((got.float() - want).abs().max()) <= 2e-2


def _k11_inputs(B, N, H, dev, seed=0):
    HD = H * 64
    q, k, v, res = (torch.from_numpy(a).to(dev, torch.bfloat16)
                    for a in _arrays((B, N, HD), n=4, seed=seed))
    r = np.random.RandomState(seed + 1)
    w = quantize_weight(torch.from_numpy((r.randn(HD, HD) * 0.05).astype(np.float32)).to(dev))
    b = torch.from_numpy((r.randn(HD) * 0.01).astype(np.float32)).to(dev)
    ls = torch.from_numpy((r.randn(HD) * 0.1 + 0.9).astype(np.float32)).to(dev)
    return q, k, v, w["q"], w["s"], b, ls, res


# K11 beside the fused shapes: the lengths around its 64-row tiles at ViT-B's
# heads, and every head count its cluster rule takes (one CTA a head)
K11_SHAPES = FUSED_ATTN_SHAPES + [(2, N, 12) for N in (1, 63, 64, 65, 1369)] + [
    (2, 65 + 64 * (H % 3), H) for H in range(1, 17) if H not in (2, 12, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,H", K11_SHAPES)
def test_k11_kernel_matches_plain(B, N, H, cuda_device):
    """The kernel rounds the un-normalised P to bf16, the plain version the
    normalised P: under 10% of the int8 context values sit one step apart
    (measured 6-7%), the row scales within 1e-2, the output within
    1e-2 max(1, |plain|)."""
    args = _k11_inputs(B, N, H, cuda_device, seed=N)
    n = TFA.flash_attention_packed_out_res.launches
    got, c8, sc = TFA.flash_attention_packed_out_res(*args, 0.125, H, return_quantised=True)
    torch.cuda.synchronize()
    assert TFA.flash_attention_packed_out_res.launches == n + 1
    _assert_bf16_close(got, TFA.flash_attention_packed_out_res_plain(*args, 0.125, H))
    p8, ps = TIB.quantize_activations(TFA.attention_context_f32(*args[:3], 0.125, H))
    diff = (c8.int() - p8.int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 1e-1
    assert float(((sc - ps).abs() / ps).max()) <= 1e-2
    assert torch.equal(got, TFA.flash_attention_packed_out_res(*args, 0.125, H))


@pytest.mark.cuda
@pytest.mark.parametrize("H", [3, 12])
def test_k11_zero_context_takes_the_scale_floor(H, cuda_device):
    """v = 0 in one batch element: its context is 0, so c8 is 0, the scale
    is the floor 1e-12 and out = res + ls b with one rounding, bit for bit
    the plain version's; the other element is unaffected."""
    args = list(_k11_inputs(2, 70, H, cuda_device, seed=H))
    args[2][0] = 0.0
    got, c8, sc = TFA.flash_attention_packed_out_res(*args, 0.125, H, return_quantised=True)
    want = TFA.flash_attention_packed_out_res_plain(*args, 0.125, H)
    torch.cuda.synchronize()
    res, b, ls = args[7][0].float(), args[5], args[6]
    assert not bool(c8[0].any()) and bool((sc[0] == 1e-12).all())
    assert torch.equal(got[0], (res + ls * b).bfloat16()) and torch.equal(got[0], want[0])
    _assert_bf16_close(got[1], want[1])


@pytest.mark.cuda
def test_k11_is_one_device_kernel_a_call(cuda_device):
    """Attention, quantisation and projection in one launch: torch.profiler
    sees one device kernel a call, the attention program's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    args = _k11_inputs(8, 1370, 12, cuda_device)
    TFA.flash_attention_packed_out_res(*args, 0.125, 12)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        TFA.flash_attention_packed_out_res(*args, 0.125, 12)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and "flash_wgmma_kernel" in names[0], names


@pytest.mark.cuda
def test_k11_cluster_rule_is_the_librarys(cuda_device):
    """The wrapper's rule (out_res_cluster_size) and the C one agree at every
    head count up to 32, and the card holds at least one cluster of each
    size the rule takes."""
    lib = _build.library()
    for H in range(0, 33):
        assert lib.caim_out_res_cluster_size(H) == TFA.out_res_cluster_size(H), H
    for H in range(1, 17):
        assert lib.caim_out_res_active_clusters(H) >= 1, H


# K12's one kernel: the rows of the exact slice, of the filtered streams, a row
# count under one 64-row tile and one row, at the widths it takes (ViT-B,
# ViT-L, the tests' 128 / 512)
K12_ROWS = [10960, 8 * 481, 8 * 257, 17, 1]
K12_WIDTHS = [(768, 3072), (1024, 4096), (128, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("M", K12_ROWS)
@pytest.mark.parametrize("D,F", K12_WIDTHS, ids=lambda v: str(v))
def test_k12_kernel_matches_plain_and_is_not_k3_then_k4(D, F, M, cuda_device):
    """Within 1e-2 max(1, |plain|) of its plain version (the layernorm's sums
    run in another order), within 2e-2 of K3 -> K4 and never equal to it (the
    pair rounds the residual to bf16 between the halves); rows of zeros in
    ctx and the residual; one launch counted, on K12's counter only."""
    t = _int8_inputs(1, M, D, F, cuda_device, seed=M % 89 + D)
    if M > 4:  # rows of zeros: the scale's floor in quant(ctx)
        t["ctx"][0, 3], t["x"][0, 3] = 0.0, 0.0
        t["ctx"][0, M // 2:] = 0.0
    ls2 = (t["ls"] * 0.9).bfloat16().float()
    args = (t["ctx"], *t["out"], t["ls"], t["x"], t["g"], t["be"], *t["fc1"], *t["fc2"], ls2)
    others = [w for w in TIB.WRAPPERS if w is not TIB.int8_attnout_mlp_ln]
    before = [w.launches for w in others]
    n = TIB.int8_attnout_mlp_ln.launches
    got = TIB.int8_attnout_mlp_ln(*args)
    torch.cuda.synchronize()
    assert TIB.int8_attnout_mlp_ln.launches == n + 1
    assert [w.launches for w in others] == before  # K12 is not K3's or K4's entry
    _assert_bf16_close(got, TIB.int8_attnout_mlp_ln_plain(*args))
    x = TIB.int8_out_residual(t["ctx"], *t["out"], t["ls"], t["x"])
    pair = TIB.int8_mlp_ln(x, t["g"], t["be"], *t["fc1"], *t["fc2"], ls2)
    assert not torch.equal(got, pair)  # the f32 carry: other bits than the bf16 round trip
    lim = 2e-2 * max(1.0, float(pair.float().abs().max()))
    assert float((got.float() - pair.float()).abs().max()) <= lim


@pytest.mark.cuda
def test_k12_is_one_device_kernel_a_call(cuda_device):
    """The whole post-attention half in one launch: torch.profiler sees one
    device kernel a call, K12's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t = _int8_inputs(8, 1370, 768, 3072, cuda_device)
    args = (t["ctx"], *t["out"], t["ls"], t["x"], t["g"], t["be"], *t["fc1"], *t["fc2"], t["ls"])
    TIB.int8_attnout_mlp_ln(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        TIB.int8_attnout_mlp_ln(*args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and "attnout_mlp_kernel" in names[0], names


@pytest.mark.cuda
def test_k12_shape_rule_is_the_librarys(cuda_device):
    """The wrapper's shape rule (int8_block.attnout_mlp_shape) and the C one
    (caim_attnout_mlp_cluster_size) agree at every width pair up to 2048 x
    8192, and the card holds at least one cluster of each instantiation."""
    lib = _build.library()
    for K in range(0, 2049, 64):
        for F in range(0, 8193, 128):
            want = TIB.attnout_mlp_shape(K, F)
            assert lib.caim_attnout_mlp_cluster_size(K, F) == (want[0] if want else 0), (K, F)
    for K, F in K12_WIDTHS:
        assert lib.caim_attnout_mlp_active_clusters(K, F) >= 1


@pytest.mark.cuda
def test_fused_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    t = _int8_inputs(2, 40, 128, 512, cuda_device)
    k12 = [t["ctx"], *t["out"], t["ls"], t["x"], t["g"], t["be"], *t["fc1"], *t["fc2"], t["ls"]]
    a = list(_k11_inputs(2, 40, 2, cuda_device))
    q, k, v = a[:3]
    wrappers = (TIB.int8_attnout_mlp_ln, TFA.flash_attention_packed_int8,
                TFA.flash_attention_packed_out_res, TFA.flash_attention_packed)
    before = [w.launches for w in wrappers]

    def swapped(args, i, value):
        return [value if j == i else x for j, x in enumerate(args)]

    with pytest.raises(TypeError):  # float32 activations
        TIB.int8_attnout_mlp_ln(*swapped(k12, 0, k12[0].float()))
    with pytest.raises(ValueError):  # a residual that is not contiguous
        TIB.int8_attnout_mlp_ln(*swapped(k12, 5, k12[5].transpose(0, 1).contiguous()
                                         .transpose(0, 1)))
    with pytest.raises(ValueError):  # an fc2 weight of the wrong shape
        TIB.int8_attnout_mlp_ln(*swapped(k12, 11, k12[8]))
    for D, F in ((2048, 2048), (256, 512)):  # widths no instantiation of K12 takes
        wide = _int8_inputs(1, 8, D, F, cuda_device)
        with pytest.raises(ValueError):
            TIB.int8_attnout_mlp_ln(wide["ctx"], *wide["out"], wide["ls"], wide["x"], wide["g"],
                                    wide["be"], *wide["fc1"], *wide["fc2"], wide["ls"])
    with pytest.raises(TypeError):  # K9 takes bfloat16 only
        TFA.flash_attention_packed(q.float(), k.float(), v.float(), 0.125, 2, int8_dots=True)
    with pytest.raises(ValueError):  # a strided q
        TFA.flash_attention_packed_int8(q.repeat(1, 1, 2)[..., :128], k, v, 0.125, 2)
    with pytest.raises(ValueError):  # 128 is not 3 heads of 64
        TFA.flash_attention_packed_int8(q, k, v, 0.125, 3)
    with pytest.raises(TypeError):  # a float32 residual
        TFA.flash_attention_packed_out_res(*swapped(a, 7, a[7].float()), 0.125, 2)
    with pytest.raises(ValueError):  # a float weight
        TFA.flash_attention_packed_out_res(*swapped(a, 3, a[3].float()), 0.125, 2)
    with pytest.raises(ValueError):  # a scale that is not positive
        TFA.flash_attention_packed_out_res(*a, 0.0, 2)
    big = _k11_inputs(1, 8, 17, cuda_device)
    with pytest.raises(ValueError):  # 17 heads: more CTAs than a cluster takes
        TFA.flash_attention_packed_out_res(*big, 0.125, 17)
    assert [w.launches for w in wrappers] == before


@pytest.mark.cuda
def test_fused_int8_model_counts_its_launches(cuda_device, monkeypatch):
    """Under ``CAIM_FUSE_AOMLP=1`` every block launches K2, K1 and K12, and
    neither K3 nor K4; the variable is read at each call."""
    from cognitive_aim_tpu_torch.core.precision import policy_from_name
    from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel
    from cognitive_aim_tpu_torch.models.config import ModelArchConfig
    from cognitive_aim_tpu_torch.nn.dinov2 import DinoV2Config

    vit = DinoV2Config(hidden_size=128, num_layers=2, num_heads=2, pretrain_image_size=56,
                       gelu_approx=True)
    model = CognitiveAimModel(ModelArchConfig(num_iterations=2, image_size=70),
                              policy_from_name("int8"), vit_cfg=vit)
    model.init(torch.Generator(device="cuda").manual_seed(0)).prepare_params()
    x = torch.randn(3, 70, 70, 3, device=cuda_device)
    gidx = torch.tensor([0, 4, 8], device=cuda_device)
    counters = (*TIB.WRAPPERS, TFA.flash_attention_packed, TFO.focal_attention_fused)

    def run():
        for w in counters:
            w.launches = 0
        out = model(x, guidance=gidx)
        torch.cuda.synchronize()
        return out, [w.launches for w in counters]

    monkeypatch.delenv("CAIM_FUSE_AOMLP", raising=False)
    unfused, counts = run()
    assert counts == [2, 2, 2, 2, 2, 2, 0, 0, 0, 2, 2]
    monkeypatch.setenv("CAIM_FUSE_AOMLP", "1")
    fused, counts = run()
    # K2, K5, K3, K4a, K4b, K4, K13, K14, K12, K1, K6
    assert counts == [2, 2, 0, 0, 0, 0, 0, 0, 2, 2, 2]
    torch.testing.assert_close(fused.depth, unfused.depth, atol=0, rtol=2e-2)
    model.attn_impl = "plain"
    ref, counts = run()
    assert counts == [0] * 11  # the plain twin launches no kernel
    torch.testing.assert_close(fused.depth, ref.depth, atol=0, rtol=2e-2)
    torch.testing.assert_close(fused.confidence, ref.confidence, atol=0, rtol=2e-2)


# ------------------------------------------------- backward (training) ----
@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K1_int8_dots", "K7", "K10", "K10b", "K6"])
def test_kernel_backward_is_the_plain_recompute(kernel, cuda_device):
    """The forward launches the kernel (one counted launch); the gradient is
    the float plain version's, recomputed from the saved inputs, so it is
    bit for bit autograd's through that plain version on the same inputs
    (K10, K10b and K9 straight through their quantisation)."""
    B, N, H, D = 2, 257, 12, 64
    q, k, v, w = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                  for a in _arrays((B, N, H * D), n=4, seed=3))
    bias = torch.log(torch.arange(1, N + 1, device=cuda_device, dtype=torch.float32)
                     ).expand(B, N).contiguous()
    s = D ** -0.5
    calls = {
        "K1": (lambda a, b, c, d: TFA.flash_attention_packed(a, b, c, s, H),
               lambda a, b, c, d: TFA.flash_attention_packed_plain(a, b, c, s, H),
               TFA.flash_attention_packed),
        "K1_int8_dots": (lambda a, b, c, d: TFA.flash_attention_packed(a, b, c, s, H,
                                                                       int8_dots=True),
                         lambda a, b, c, d: TFA.flash_attention_packed_plain(a, b, c, s, H),
                         TFA.flash_attention_packed_int8),
        "K7": (lambda a, b, c, d: TFA.flash_attention_packed_bias(a, b, c, d, s, H),
               lambda a, b, c, d: TFA.flash_attention_packed_bias_plain(a, b, c, d, s, H),
               TFA.flash_attention_packed_bias),
        "K10": (lambda a, b, c, d: TFA.flash_attention_packed_i8qk(a, b, c, s, H),
                lambda a, b, c, d: TFA.flash_attention_packed_plain(a, b, c, s, H),
                TFA.flash_attention_packed_i8qk),
        "K10b": (lambda a, b, c, d: TFA.flash_attention_packed_i8qk_bias(a, b, c, d, s, H),
                 lambda a, b, c, d: TFA.flash_attention_packed_bias_plain(a, b, c, d, s, H),
                 TFA.flash_attention_packed_i8qk_bias),
        "K6": (lambda a, b, c, d: TFO.focal_attention_fused(
                   *(t[:, 1:].contiguous() for t in (a, b, c)), 96 ** 0.5)[0],
               lambda a, b, c, d: TFO.focal_attention_plain(
                   *(t[:, 1:].contiguous() for t in (a, b, c)), 96 ** 0.5)[0],
               TFO.focal_attention_fused),
    }
    kern, plain, wrapper = calls[kernel]
    grads = []
    with torch.enable_grad():
        for fn in (kern, plain):
            args = [t.clone().requires_grad_(True) for t in (q, k, v, bias)]
            n = wrapper.launches
            out = fn(*args)
            torch.cuda.synchronize()
            assert wrapper.launches == n + (fn is kern)
            wo = w[:, 1:] if kernel == "K6" else w
            grads.append(torch.autograd.grad(out, args[:3] + args[3:] * (kernel in ("K7", "K10b")),
                                             wo))
    for a, b in zip(*grads):
        assert torch.equal(a, b)
        assert bool(torch.isfinite(a.float()).all()) and float(a.float().abs().max()) > 0


@pytest.mark.cuda
def test_gradless_kernels_raise_under_grad_on_the_card(cuda_device):
    """The int8 kernels, K8, K11 and the quantisers have no backward: on a
    CUDA input that requires grad they raise before any launch."""
    x = torch.randn(1, 64, 128, device=cuda_device, dtype=torch.bfloat16)
    wq = quantize_weight(torch.randn(384, 128, device=cuda_device))
    calls = [lambda t: TIB.int8_qkv_proj(t, wq["q"], wq["s"], torch.zeros(384, device=cuda_device)),
             lambda t: TFA.flash_attention(*(t.view(1, 64, 2, 64),) * 3, 0.125),
             lambda t: TFA.quantize_rows(t, t),
             lambda t: TFA.quantize_heads(t, 2, t),
             lambda t: TIG.int8_gemm_fused(t[0], wq["q"], wq["s"],
                                           torch.zeros(384, device=cuda_device))]
    with torch.enable_grad():
        for call in calls:
            with pytest.raises(RuntimeError, match="no backward"):
                call(x.clone().requires_grad_(True))


# ------------------------------------------------------- the parallel layer ----
@pytest.mark.cuda
@pytest.mark.parametrize("N", [257, 1370])
@pytest.mark.parametrize("H", [6, 8])
def test_k1_at_tensor_parallel_head_counts(N, H, cuda_device):
    """A rank of a tensor-parallel pair runs K1 on half the heads: 6 of
    ViT-B's 12, 8 of ViT-L's 16 (atol 1e-2, as at every length above)."""
    B, D = 2, 64
    q, k, v = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
               for a in _arrays((B, N, H * D), seed=N + H))
    want = TFA.flash_attention_packed_plain(q.float(), k.float(), v.float(), D ** -0.5, H)
    got = TFA.flash_attention_packed(q, k, v, D ** -0.5, H)
    torch.cuda.synchronize()
    assert float((got.float() - want).abs().max()) <= 1e-2


class _nccl_world1:
    """NCCL at world 1 from a file rendezvous, stopped on the way out. The
    mesh=None references run before it: inside, mesh=None builds a mesh whose
    collectives run."""

    def __init__(self, tmp_path):
        self.path = tmp_path / "rendezvous"

    def __enter__(self):
        from cognitive_aim_tpu_torch.core.mesh import initialize_distributed, make_mesh

        initialize_distributed(device="cuda", init_method=f"file://{self.path}", rank=0,
                               world_size=1)
        return make_mesh()

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.destroy_process_group()


SMALL_VIT = dict(hidden_size=128, num_layers=2, num_heads=2, patch_size=14,
                 pretrain_image_size=56)


@pytest.mark.cuda
def test_data_parallel_engine_at_world_1_is_mesh_none(cuda_device, tmp_path):
    """predict_paths_batched(mesh=make_mesh()) on NCCL at world 1, int8,
    sampled noise, mixed instructions, a padded tail chunk: bit for bit the
    list mesh=None returns."""
    import json

    from PIL import Image

    from cognitive_aim_tpu_torch.api import CognitiveAimInference
    from cognitive_aim_tpu_torch.nn.dinov2 import DinoV2Config

    rng = np.random.RandomState(3)
    paths = []
    for i in range(7):
        p = str(tmp_path / f"im{i}.png")
        Image.fromarray(rng.randint(0, 256, (60 + 4 * i, 70, 3), dtype=np.uint8)).save(p)
        paths.append(p)
    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as f:
        json.dump({"cognitive_modules": ["ambient_stream", "iterative_focal_stream",
                                         "exif_prior_database"],
                   "dataset": {"image_size": 56}, "focal_config": {"num_iterations": 2}}, f)
    engine = CognitiveAimInference(cfg, None, policy="int8", noise_mode="sample", seed=5,
                                   save_images=False, vit_cfg=DinoV2Config(**SMALL_VIT))
    instructions = ["center", "left", "top", "right", "bottom", "top-left", "center"]
    want = engine.predict_paths_batched(paths, instructions=instructions, batch_size=4)
    engine._draws = 0  # the same noise streams again
    with _nccl_world1(tmp_path) as mesh:
        got = engine.predict_paths_batched(paths, instructions=instructions, batch_size=4,
                                           mesh=mesh)
    assert got == want and all(np.isfinite(want).ravel())


@pytest.mark.cuda
def test_trainer_on_a_world_1_mesh_is_the_meshless_trainer(cuda_device, tmp_path):
    """Two float32 steps with tensor_parallel on make_mesh() (NCCL, world 1:
    every collective of the data- and tensor-parallel path runs) against
    the trainer without a mesh, same weights and generator: losses and
    parameters within 1e-6 relative."""
    from cognitive_aim_tpu_torch.core.precision import STRICT_F32
    from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel
    from cognitive_aim_tpu_torch.models.config import ModelArchConfig
    from cognitive_aim_tpu_torch.nn.dinov2 import DinoV2Config
    from cognitive_aim_tpu_torch.train.trainer import TrainConfig, Trainer

    arch = ModelArchConfig(num_iterations=2, image_size=56, use_lora=True,
                           freeze_backbone=False)
    vit = DinoV2Config(**SMALL_VIT, use_lora=True, lora_rank=4)
    B = 8
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = {"images": torch.randn(B, 56, 56, 3, generator=g, device="cuda"),
             "depths": torch.rand(B, generator=g, device="cuda") + 0.5}

    def run(mesh):
        model = CognitiveAimModel(arch, STRICT_F32, "pallas_packed", vit_cfg=vit)
        model.init(torch.Generator(device="cuda").manual_seed(1))
        with torch.no_grad():
            for blk in model.backbone.layers:
                blk.lora_B.normal_(0.0, 0.02, generator=torch.Generator(device="cuda")
                                   .manual_seed(2))
        tr = Trainer(model, TrainConfig(learning_rate=1e-3, epochs=1, steps_per_epoch=2,
                                        freeze_backbone=False, tensor_parallel=True),
                     output_dir=str(tmp_path / "t"), mesh=mesh)
        gen = torch.Generator(device="cuda").manual_seed(3)
        with torch.enable_grad():
            losses = [tr.train_step(batch, gen)["loss"] for _ in range(2)]
        return losses, {n: p.detach().clone() for n, p in model.named_parameters()}

    want_loss, want = run(None)
    with _nccl_world1(tmp_path) as mesh:
        got_loss, got = run(mesh)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-6)
    for n, p in want.items():
        assert float((got[n] - p).abs().max()) <= 1e-6 * float(p.abs().max()), n


# ---------------------------------------------------- caim ops, torch.export ----
def _op_cases(dev):
    """caim op -> its arguments on the card at ViT-B widths (D 768, H 12,
    F 3072), N 257: shapes each kernel takes."""
    B, N, H, D, F = 2, 257, 12, 768, 3072
    t = _int8_inputs(B, N, D, F, dev, seed=7)
    x, ctx, g, be, ls = t["x"], t["ctx"], t["g"], t["be"], t["ls"]
    q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16) for a in _arrays((B, N, D), seed=8))
    bias = torch.from_numpy(_arrays((B, N), n=1, seed=9)[0]).to(dev)
    h8, sh = TIB.int8_fc1_gelu_ln_plain(x, g, be, *t["fc1"])
    fused = torch.from_numpy(_arrays((B, N, 3, H, 64), n=1, seed=10)[0]).to(dev, torch.bfloat16)
    bf = torch.bfloat16
    return {
        "flash_attention_packed": (q, k, v, 0.125, H),
        "flash_attention_packed_bias": (q, k, v, bias, 0.125, H),
        "flash_attention_packed_int8": (q, k, v, 0.125, H),
        "flash_attention_packed_i8qk": (q, k, v, 0.125, H),
        "flash_attention_packed_i8qk_bias": (q, k, v, bias, 0.125, H),
        "flash_attention_packed_out_res": (q, k, v, *t["out"], ls, ctx, 0.125, H, True),
        "flash_attention": (*fused.unbind(2), 0.125),
        "quantize_rows": (q, k),
        "quantize_heads": (q, H, k),
        "focal_attention_fused": (q, k, v, 27.7),
        "int8_qkv_proj_ln": (x, g, be, *t["qkv"], 1e-6, bf),
        "int8_qkv_proj": (x, *t["qkv"], bf),
        "int8_out_residual": (ctx, *t["out"], ls, x),
        "int8_out_residual_prequant": (h8, sh, *t["fc2"], ls, x),
        "int8_fc1_gelu_ln": (x, g, be, *t["fc1"], 1e-6),
        "int8_fc1_gelu": (x, *t["fc1"]),
        "int8_proj": (x, *t["fc1"], bf),
        "int8_attnout_mlp_ln": (ctx, *t["out"], ls, x, g, be, *t["fc1"], *t["fc2"], ls, 1e-6),
        "int8_gemm_fused": (x.view(B * N, D), *t["qkv"], bf),
    }


CAIM_OPS = ["flash_attention", "flash_attention_packed", "flash_attention_packed_bias",
            "flash_attention_packed_i8qk", "flash_attention_packed_i8qk_bias",
            "flash_attention_packed_int8", "flash_attention_packed_out_res",
            "focal_attention_fused", "int8_attnout_mlp_ln", "int8_fc1_gelu",
            "int8_fc1_gelu_ln", "int8_gemm_fused", "int8_out_residual",
            "int8_out_residual_prequant", "int8_proj", "int8_qkv_proj", "int8_qkv_proj_ln",
            "quantize_heads", "quantize_rows"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CAIM_OPS)
def test_opcheck_every_caim_op_on_the_card(name, cuda_device):
    """torch.library.opcheck on CUDA inputs: the kernel's outputs against the
    fake's shapes, dtypes and strides, no aliasing, the op under aot_autograd
    with dynamic shapes; the kernel launched and counted."""
    from cognitive_aim_tpu_torch.kernels import _library

    wrappers = {w.__name__: w for w in TFA.WRAPPERS + TIB.WRAPPERS + TIG.WRAPPERS
                + (TFO.focal_attention_fused,)}
    cases = _op_cases(cuda_device)
    assert sorted(cases) == sorted(_library.OPS) == CAIM_OPS
    n = wrappers[name].launches
    torch.library.opcheck(_library.OPS[name], cases[name])
    torch.cuda.synchronize()
    assert wrappers[name].launches > n


@pytest.mark.cuda
def test_two_layer_vit_b_width_model_exports_and_reloads_on_the_card(cuda_device, tmp_path):
    """A 2-layer D 768 int8 model at 224x224 through scripts/torch_export_model.py's
    path on the card: one caim node a launch, saved, loaded and rebuilt from
    the npz; one forward of the loaded program launches the kernels (K4's
    own count, outside any op, stays 0) and equals the live forward."""
    import os
    import sys

    from cognitive_aim_tpu_torch.core.rng import NoiseMode
    from cognitive_aim_tpu_torch.core.precision import INT8_BACKBONE
    from cognitive_aim_tpu_torch.kernels._library import op_counts
    from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel
    from cognitive_aim_tpu_torch.models.config import ModelArchConfig
    from cognitive_aim_tpu_torch.nn.dinov2 import DinoV2Config

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "scripts"))
    import torch_export_model as EXP

    vit = DinoV2Config(hidden_size=768, num_layers=2, num_heads=12, patch_size=14,
                       pretrain_image_size=518, gelu_approx=True)
    model = CognitiveAimModel(ModelArchConfig(num_iterations=2, image_size=224),
                              INT8_BACKBONE, "pallas_packed", vit_cfg=vit)
    model.init(torch.Generator(device="cuda").manual_seed(0))
    serve = EXP.Serve(model.prepare_params(), NoiseMode.ZEROS).requires_grad_(False)
    args = EXP.serving_inputs(4, 224, cuda_device, EXP.roundtrip_images(4, 224, cuda_device))
    serve(*args)
    program = torch.export.export(serve, args)
    want = {"int8_qkv_proj_ln": 2, "flash_attention_packed": 2, "int8_out_residual": 2,
            "int8_fc1_gelu_ln": 2, "int8_out_residual_prequant": 2, "int8_qkv_proj": 2,
            "focal_attention_fused": 2}
    assert dict(op_counts(program.graph)) == want
    path = str(tmp_path / "vitb2.pt2")
    torch.export.save(program, path)
    EXP.save_params(program, path + ".params.npz")
    loaded = EXP.load_program(path)
    d0, c0 = serve(*args)
    counters = {w.__name__: w for w in TFA.WRAPPERS + TIB.WRAPPERS + TIG.WRAPPERS
                + (TFO.focal_attention_fused,)}
    for w in counters.values():
        w.launches = 0
    d1, c1 = loaded(*args)
    torch.cuda.synchronize()
    assert {n: w.launches for n, w in counters.items() if w.launches} == want
    torch.testing.assert_close(d1, d0, rtol=EXP.RTOL, atol=EXP.ATOL)
    torch.testing.assert_close(c1, c0, rtol=EXP.RTOL, atol=EXP.ATOL)


# ------------------------------------------------------- compiled forward ----
COMPILED_VIT = dict(hidden_size=128, num_layers=4, num_heads=2, patch_size=14,
                    pretrain_image_size=56)
# name: (policy, attn_impl, token filter, fold adapters), tests/test_torch_compiled.py's
COMPILED_CONFIGS = {
    "default": ("default", "pallas_packed", "", False),
    "int8_exact": ("int8", "pallas_packed", "", False),
    "int8_2:0.35": ("int8", "pallas_packed", "2:0.35", False),
    "int8_2:0.35@p_i8qk": ("int8", "pallas_packed_i8qk", "2:0.35@p", False),
    "int8_2:0.35@m@p": ("int8", "pallas_packed", "2:0.35@m@p", False),
    "int8_2:0.35@d": ("int8", "pallas_packed", "2:0.35@d", False),
    "int8_folded_2:0.35": ("int8", "pallas_packed", "2:0.35", True),
}


def _compiled_engine(tmp_path, name, noise="sample", seed=0):
    import json

    from cognitive_aim_tpu_torch.api import CognitiveAimInference
    from cognitive_aim_tpu_torch.nn.dinov2 import DinoV2Config

    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as f:
        json.dump({"cognitive_modules": ["ambient_stream", "iterative_focal_stream",
                                         "exif_prior_database"],
                   "dataset": {"image_size": 56}, "exif_config": {"num_cameras": 5},
                   "focal_config": {"num_iterations": 2}}, f)
    policy, impl, spec, fold = COMPILED_CONFIGS[name]
    eng = CognitiveAimInference(cfg, None, policy=policy, attn_impl=impl, token_filter=spec,
                                noise_mode=noise, seed=seed, save_images=False,
                                vit_cfg=DinoV2Config(**COMPILED_VIT))
    if fold:
        rng = np.random.RandomState(3)
        L, D, r = COMPILED_VIT["num_layers"], COMPILED_VIT["hidden_size"], 4
        eng._materialize(None, {"backbone/layers/lora_A": rng.randn(L, r, D).astype(np.float32)
                                * 0.1,
                                "backbone/layers/lora_B": rng.randn(L, D, r).astype(np.float32)
                                * 0.1}, (r, r))
    return eng


def _compiled_inputs(seed, B, uint8, guided, dev):
    rng = np.random.RandomState(seed)
    if uint8:
        x = torch.from_numpy(rng.randint(0, 256, (B, 56, 56, 3)).astype(np.uint8)).to(dev)
    else:
        x = torch.from_numpy(rng.randn(B, 56, 56, 3).astype(np.float32)).to(dev)
    exif = {"camera_idx": torch.from_numpy(rng.randint(0, 5, B).astype(np.int32)).to(dev),
            "focal_length": torch.full((B,), 35.0, device=dev),
            "aperture": torch.full((B,), 2.8, device=dev),
            "iso": torch.full((B,), 200.0, device=dev)}
    g = torch.from_numpy(rng.randint(0, 9, B)).to(dev) if guided else None
    return x, exif, g


def _launches():
    from cognitive_aim_tpu_torch.kernels import counters

    torch.cuda.synchronize()
    return {c.__name__: c.launches for c in counters()}


@pytest.mark.cuda
@pytest.mark.parametrize("uint8", [False, True], ids=["float", "uint8"])
@pytest.mark.parametrize("guided", [True, False], ids=["guided", "unguided"])
@pytest.mark.parametrize("name", list(COMPILED_CONFIGS))
def test_compiled_replay_is_the_eager_forward(name, guided, uint8, cuda_device, tmp_path):
    """Each serving configuration, sampled noise: a replay of the engine's
    graph equals ``engine.model(...)`` with a generator seeded as the
    replay's, bit for bit, in every output. A replay runs no wrapper, so
    what it launched is read from the device: under ``torch.profiler`` it
    runs the caim kernels that the eager forward's wrappers launch, in the
    same order."""
    from cognitive_aim_tpu_torch.io.preprocess import normalize_u8
    from cognitive_aim_tpu_torch.utils.profiling import traced_kernels

    eng = _compiled_engine(tmp_path, name)

    def eager(x, exif, g, s):
        return eng.model(normalize_u8(x) if uint8 else x, exif, guidance=g,
                         generator=torch.Generator(cuda_device).manual_seed(s),
                         noise_mode=eng.noise_mode)

    for seed in (1, 2):  # the first call captures, the second replays only
        x, exif, g = _compiled_inputs(seed, 3, uint8, guided, cuda_device)
        got = eng._forward(x, exif, g)
        want = eager(x, exif, g, eng._seed_of(eng._draws - 1))
        for f in ("depth", "confidence", "attention", "curiosity", "fused_features"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
    counts = {}

    def counted(tag, fn):
        before = _launches()
        fn()
        counts[tag] = {k: v - before[k] for k, v in _launches().items()}

    (_, eager_kernels), (_, replayed) = traced_kernels(
        lambda: counted("eager", lambda: eager(x, exif, g, 0)),
        lambda: counted("replay", lambda: eng._forward(x, exif, g)))
    assert not any(counts["replay"].values())  # no wrapper ran
    assert replayed == eager_kernels and sum(counts["eager"].values()) > 0
    assert len(eng.compiled.graphs) == 1 and eng.compiled.pool_bytes() > 0


@pytest.mark.cuda
def test_compiled_forward_serves_two_threads_at_once(cuda_device, tmp_path):
    """predict (its B 1 graphs captured while the server replays its own)
    and the server's dispatcher from two threads at once: each answer is
    the one it gets alone."""
    from PIL import Image

    from cognitive_aim_tpu_torch.serve import BatchingServer

    eng = _compiled_engine(tmp_path, "int8_2:0.35", noise="zeros")
    rng = np.random.RandomState(8)
    paths = []
    for i in range(3):
        p = str(tmp_path / f"im{i}.png")
        Image.fromarray(rng.randint(0, 256, (50 + 5 * i, 60, 3), dtype=np.uint8)).save(p)
        paths.append(p)
    server = BatchingServer(eng, max_batch=4, max_delay_ms=1.0)
    try:
        img = rng.randn(56, 56, 3).astype(np.float32)
        exif = {"camera_idx": 0, "focal_length": 50.0, "aperture": 2.8, "iso": 100.0}
        alone_server = server.submit(img, exif, "right")
        n_graphs = len(eng.compiled.graphs)
        errors = []

        def predicts():
            for _ in range(6):
                for p, instr in zip(paths, ("left", None, "top")):
                    got = eng.predict(p, instr)[:2]
                    if got != alone[(p, instr)]:
                        errors.append(("predict", p, instr, got, alone[(p, instr)]))

        def submits():
            for _ in range(12):
                got = server.submit(img, exif, "right")
                if got != alone_server:
                    errors.append(("server", got, alone_server))

        alone = {(p, i): eng.predict(p, i)[:2] for p, i in zip(paths, ("left", None, "top"))}
        eng.compiled.graphs = {k: v for k, v in list(eng.compiled.graphs.items())[:n_graphs]}
        threads = [threading.Thread(target=predicts), threading.Thread(target=submits)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]
        assert len(eng.compiled.graphs) == n_graphs + 2  # B 1 guided and unguided again
    finally:
        server.stop()
    # the server's records hold its own replays' split, never predict's captures
    recs = list(server.batches)
    assert sum(b["n"] for b in recs) == 13 and not any(b["captured"] for b in recs)
    for b in recs:
        assert b["engine"][0] <= b["lock_wait"][0] <= b["copy_out"][1] <= b["engine"][1]


# ----------------------------------------------------- compiled training ----
LORA_TRAIN = dict(use_lora=True, lora_rank=4, lora_targets=("attn_out", "fc1"))
# name: (TrainConfig overrides, arch overrides), tests/test_torch_train.py's STEP_CASES
STEP_GROUPS = {
    "cosine": (dict(scheduler="cosine"), {}),
    "warmup_cosine": (dict(scheduler="warmup_cosine", warmup_epochs=1, steps_per_epoch=2,
                           epochs=3), {}),
    "step": (dict(scheduler="step", steps_per_epoch=1), {}),
    "accumulation_steps_2": (dict(accumulation_steps=2), {}),
    "freeze_backbone": (dict(freeze_backbone=True), LORA_TRAIN),
    "train_only_lora": (dict(train_only_lora=True), LORA_TRAIN),
    "sandwich_heads_lr": (dict(train_only_lora=True, sandwich_heads=True, heads_lr=1e-3),
                          LORA_TRAIN),
}
TRAIN_BASE = dict(learning_rate=3e-3, epochs=1, batch_size=8, steps_per_epoch=30,
                  freeze_backbone=False, weight_decay=0.015, attention_entropy_weight=0.01,
                  beta_schedule="cosine", beta_start=0.05, beta_end=1.5, guided_training=True)


def _train_model(arch_kw, seed=1, filtered=False):
    import dataclasses

    from cognitive_aim_tpu_torch.core.precision import DEFAULT_POLICY
    from cognitive_aim_tpu_torch.models.cognitive_aim import CognitiveAimModel
    from cognitive_aim_tpu_torch.models.config import ModelArchConfig
    from cognitive_aim_tpu_torch.nn.dinov2 import DinoV2Config

    arch = ModelArchConfig(num_iterations=2, image_size=56, freeze_backbone=False, **arch_kw)
    if filtered:
        arch = dataclasses.replace(arch, token_filter_layer=1, token_filter_keep=0.5,
                                   token_filter_train=True)
    model = CognitiveAimModel(arch, DEFAULT_POLICY, "pallas_packed",
                              vit_cfg=DinoV2Config(**SMALL_VIT))
    g = torch.Generator(device="cuda").manual_seed(seed)
    model.init(g)
    with torch.no_grad():  # lora_B 0 (its init) would leave lora_A's gradient 0
        for name, p in model.named_parameters():
            if "lora" in name and name.endswith("B"):
                p.normal_(0.0, 0.02, generator=g)
    return model


def _train_batches(n=2, B=8):
    g = torch.Generator(device="cuda").manual_seed(7)
    return [{"images": torch.randn(B, 56, 56, 3, generator=g, device="cuda"),
             "depths": torch.rand(B, generator=g, device="cuda") + 0.5,
             "exif": {"camera_idx": torch.zeros(B, dtype=torch.int32, device="cuda"),
                      "focal_length": torch.full((B,), 0.25, device="cuda"),
                      "aperture": torch.full((B,), 0.127, device="cuda"),
                      "iso": torch.full((B,), 0.016, device="cuda")}} for _ in range(n)]


def _assert_replays_are_eager(tr, steps=6):
    """``steps`` micro-steps from the trainer's weights and a fresh
    optimizer, eager twice and through the graphs twice (the first run
    captures each kind at its first call): each replayed run bit for bit
    the eager one where eager repeats its bits, else within twice eager's
    own spread (losses and parameters)."""
    start = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    batches = _train_batches()

    def run(eager):
        with torch.no_grad():
            for n, p in tr.model.named_parameters():
                p.copy_(start[n])
        tr.reset_params()
        losses = [tr.train_step(batches[i % 2], torch.Generator(device="cuda").manual_seed(i),
                                fetch_logs=False, eager=eager)["loss"] for i in range(steps)]
        return (torch.stack(losses), {n: p.detach().clone()
                                      for n, p in tr.model.named_parameters()})

    def apart(a, b):
        return (float((a[0] - b[0]).abs().max()),
                max(float((a[1][n] - b[1][n]).abs().max()) for n in a[1]))

    eager, again = run(True), run(True)
    spread = apart(eager, again)
    for replayed in (run(False), run(False)):
        d = apart(replayed, eager)
        if spread == (0.0, 0.0):
            assert d == (0.0, 0.0), d
        else:
            assert d[0] <= 2 * spread[0] and d[1] <= 2 * spread[1], (d, spread)
    assert torch.isfinite(eager[0]).all()
    return tr.graphs


@pytest.mark.cuda
@pytest.mark.parametrize("remat", ["1", "0"])
@pytest.mark.parametrize("group", list(STEP_GROUPS))
def test_compiled_step_replays_the_eager_step(group, remat, cuda_device, tmp_path,
                                              monkeypatch):
    """Each option group of the trainer's step (schedules, MultiSteps,
    parameter groups; guided sampling and noise on), per-block recompute on
    and off (read at capture): the replayed micro-steps against the eager
    ones, one graph a micro-step kind."""
    from cognitive_aim_tpu_torch.train.trainer import TrainConfig, Trainer

    monkeypatch.setenv("CAIM_TRAIN_REMAT", remat)
    over, arch_kw = STEP_GROUPS[group]
    tr = Trainer(_train_model(arch_kw), TrainConfig(**{**TRAIN_BASE, **over}),
                 output_dir=str(tmp_path / "t"))
    graphs = _assert_replays_are_eager(tr)
    k = tr.cfg.accumulation_steps
    assert len(graphs.graphs) == (2 if k > 1 else 1)
    assert all(len(e.generators) == 5 for e in graphs.graphs.values())  # noise + guided draw


@pytest.mark.cuda
def test_compiled_alt_model_pair_replays_the_eager_steps(cuda_device, tmp_path):
    """The token filter in training, alternating with the model without it
    on the same parameters, accumulating 3 micro-steps: four graphs (each
    model accumulating and updating) and the eager steps' results."""
    from cognitive_aim_tpu_torch.train.trainer import TrainConfig, Trainer

    alt = _train_model({}, seed=9)
    tr = Trainer(_train_model({}, filtered=True), TrainConfig(**{**TRAIN_BASE,
                                                                 "accumulation_steps": 3}),
                 output_dir=str(tmp_path / "t"), alt_model=alt)
    graphs = _assert_replays_are_eager(tr, steps=8)
    assert sorted((k.alt, k.update) for k, _ in graphs.graphs) == [
        (False, False), (False, True), (True, False), (True, True)]


@pytest.mark.cuda
def test_compiled_step_on_a_world_1_nccl_mesh(cuda_device, tmp_path):
    """tensor_parallel on make_mesh() (NCCL, world 1): the gathers of the
    loss, the gradient all-reduce and the clip's all-reduce inside the
    graph; the replays against the eager steps, and the eval forward's
    graph against its eager run."""
    from cognitive_aim_tpu_torch.train.trainer import TrainConfig, Trainer

    with _nccl_world1(tmp_path) as mesh:
        tr = Trainer(_train_model(LORA_TRAIN), TrainConfig(**{**TRAIN_BASE,
                                                               "tensor_parallel": True}),
                     output_dir=str(tmp_path / "t"), mesh=mesh)
        assert tr.mesh.distributed and tr.graphs is not None
        _assert_replays_are_eager(tr)
        x = _train_batches(1)[0]
        got = tr.eval_forward(x["images"], x["exif"])
        want = tr.eval_forward(x["images"], x["exif"], eager=True)
        assert torch.equal(got.depth, want.depth) and torch.equal(got.attention, want.attention)


@pytest.mark.cuda
def test_certification_loops_replay_the_trainers_graphs(cuda_device, tmp_path):
    """The callers that reach the compiled step with no change of their own:
    certify.pretrain with --train-filter (the filtered step and the exact
    one in turns, two models on one set of parameters) and synth_train's
    loop over staged batches; each trains through the trainer's graphs
    (one a micro-step kind, replayed after its first call), finite losses."""
    import numpy as np

    from cognitive_aim_tpu_torch.certify import pretrain as PT
    from cognitive_aim_tpu_torch.certify import synth_train as ST
    from cognitive_aim_tpu_torch.train.trainer import StepKey, TrainConfig, Trainer

    # ViT-B's width at 4 blocks (--tiny's heads of 16 are no K1 shape)
    summ = PT.main(["--layers", "4", "--guided", "--steps", "8", "--n-images", "16",
                    "--batch", "4", "--image-size", "56", "--n-eval", "4", "--eval-every", "8",
                    "--train-filter", "2:0.35", "--ckpt-dir", str(tmp_path / "ck"),
                    "--data-cache", str(tmp_path / "dc")])
    graphs = summ["trainer"].graphs.graphs
    steps = {k: e for (k, _), e in graphs.items() if isinstance(k, StepKey)}
    assert {k.alt for k in steps} == {False, True}
    assert sum(e.replays for e in steps.values()) == 8 - len(steps)
    assert np.isfinite([float(x) for x in summ["losses"]]).all()

    tr = Trainer(_train_model({}), TrainConfig(epochs=1, batch_size=4, steps_per_epoch=6,
                                               learning_rate=1e-4, freeze_backbone=False),
                 output_dir=str(tmp_path / "st"))
    rng = np.random.RandomState(2)
    imgs01 = rng.rand(8, 56, 56, 3).astype(np.float32)
    staged = ST.stage_batches(tr, (imgs01 - 0.5) / 0.25, ST.depth_law(imgs01), 4)
    losses = ST.run_training(tr, staged, 6)
    assert len(tr.graphs.graphs) == 1 and next(iter(tr.graphs.graphs.values())).replays == 5
    assert np.isfinite(losses).all()
