"""K11's launch rule in the port, on the CPU.

K11 (``flash_attention_packed_out_res``) runs on the card as a thread-block
cluster of one CTA a head over a 64-row tile, so its kernel takes 1 to 16
heads of 64 (16 CTAs is the largest cluster the card takes) and a positive
scale. ``out_res_cluster_size`` is that rule (the card tests hold it equal
to the C library's ``caim_out_res_cluster_size``) and ``_check_out_res``
raises, before any launch, on what the kernel does not take. CPU tensors
take the plain version at any head count and count no launch. The plain
version itself is held to the JAX kernel in tests/test_torch_fused.py.
"""

import math

import numpy as np
import pytest
import torch

from cognitive_aim_tpu_torch.kernels import flash_attention as TFA
from cognitive_aim_tpu_torch.kernels.int8_ops import quantize_weight


@pytest.mark.parametrize("H", range(0, 21))
def test_k11_cluster_rule_and_what_it_raises_on(H):
    """One CTA a head: 1 to 16 heads, a cluster of H CTAs; any other count
    raises ValueError."""
    want = H if 1 <= H <= 16 else 0
    assert TFA.out_res_cluster_size(H) == want
    if want:
        TFA._check_out_res("k11", H * 64, H, 0.125)
    else:
        with pytest.raises(ValueError, match="heads"):
            TFA._check_out_res("k11", H * 64, H, 0.125)


@pytest.mark.parametrize("scale", [0.0, -0.125, math.nan])
def test_k11_raises_on_a_scale_that_is_not_positive(scale):
    with pytest.raises(ValueError, match="positive scale"):
        TFA._check_out_res("k11", 768, 12, scale)


@pytest.mark.parametrize("HD,H", [(768, 6), (96, 1), (1024, 12)])
def test_k11_raises_on_a_width_that_is_not_its_heads_of_64(HD, H):
    with pytest.raises(ValueError, match="heads of 64"):
        TFA._check_out_res("k11", HD, H, 0.125)


@pytest.mark.parametrize("H", [3, 17])
def test_k11_cpu_takes_any_head_count_and_counts_no_launch(H):
    """The plain version has no cluster: 3 and 17 heads run on the CPU, as
    K1 then K3 on the f32 context, and count no kernel launch."""
    rng = np.random.RandomState(H)
    B, N, HD = 1, 9, H * 64
    q, k, v, res = (torch.from_numpy((rng.randn(B, N, HD) * 0.5).astype(np.float32))
                    for _ in range(4))
    w = quantize_weight(torch.from_numpy((rng.randn(HD, HD) * 0.05).astype(np.float32)))
    b = torch.from_numpy((rng.randn(HD) * 0.01).astype(np.float32))
    ls = torch.from_numpy((rng.randn(HD) * 0.1 + 0.9).astype(np.float32))
    n = TFA.flash_attention_packed_out_res.launches
    out, c8, sc = TFA.flash_attention_packed_out_res(q, k, v, w["q"], w["s"], b, ls, res,
                                                     0.125, H, return_quantised=True)
    assert TFA.flash_attention_packed_out_res.launches == n
    assert out.shape == (B, N, HD) and c8.shape == (B, N, HD) and sc.shape == (B, N, 1)
    assert torch.equal(out, TFA.flash_attention_packed_out_res_plain(
        q, k, v, w["q"], w["s"], b, ls, res, 0.125, H))
