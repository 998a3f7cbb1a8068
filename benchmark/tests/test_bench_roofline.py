"""The roofline and mfu arithmetic against hand counts at the cells' shapes."""

import json

import pytest

from benchmark import spec
from benchmark.roofline import peaks, work

REF = spec.reference(spec.ROOT, "vitb14_518_int8")


def dims(name):
    return spec.reference(spec.ROOT, name).dims(spec.config(spec.ROOT, spec.bench(), name))


def test_int8_operations_per_image_match_hand_counts():
    # per block 2 N (3 D^2 + D^2 + 2 D F) at N = 1 + 37^2
    b, l = dims("vitb14_518_int8"), dims("vitl14_518_int8")

    def backbone(d):
        return sum(u.ops for u in REF.units(d, 1) if u.kernel in ("K2", "K3", "K4"))

    assert backbone(b) == pytest.approx(2.327e11, rel=1e-3)
    assert backbone(b) == 12 * 2 * 1370 * (4 * 768 ** 2 + 2 * 768 * 3072)
    assert backbone(l) == 24 * 2 * 1370 * (4 * 1024 ** 2 + 2 * 1024 * 4096)
    assert backbone(l) == pytest.approx(8.275e11, rel=1e-3)
    focal = sum(u.ops for u in REF.units(b, 1) if u.kernel == "K5")
    assert focal == 2 * 2 * 1369 * 768 * 3 * 768


def test_attention_operations_and_tokens():
    b = dims("vitb14_518_int8")
    k1 = sum(u.ops for u in REF.units(b, 1) if u.kernel == "K1")
    assert k1 == pytest.approx(6.92e10, rel=1e-3)
    assert work.block_tokens(b, None) == [1370] * 12
    # 2:0.35 keeps round(0.35 * 1369) = 479 patches, plus CLS and the fused token
    assert work.block_tokens(b, (2, 0.35)) == [1370] * 2 + [481] * 10
    k6 = sum(u.ops for u in REF.units(b, 1) if u.kernel == "K6")
    assert k6 == 2 * 4 * 1369 ** 2 * 768


def test_least_time_is_the_larger_bound():
    u = work.Unit("int8_block", "K2", 1370, bytes=3.35e9, ops=1979e12, kind="int8")
    assert u.least_s == pytest.approx(1.0)
    u = work.Unit("int8_block", "K2", 1370, bytes=3.35e12, ops=1.0, kind="int8")
    assert u.least_s == pytest.approx(1.0)
    assert peaks.OPS_PER_S["int8"] == pytest.approx(2 * peaks.OPS_PER_S["bf16"], rel=1e-3)


def test_mfu_numerator_at_vit_b_b16():
    # int8 projections (backbone and focal) at the int8 peak, attention,
    # focal attention and patch embedding at the bf16 peak
    b = dims("vitb14_518_int8")
    ops = work.matmul_ops(REF, b, 16)
    int8 = 16 * (12 * 2 * 1370 * (4 * 768 ** 2 + 2 * 768 * 3072) + 2 * 2 * 1369 * 3 * 768 ** 2)
    bf16 = 16 * (12 * 4 * 1370 ** 2 * 768 + 2 * 4 * 1369 ** 2 * 768 + 2 * 1369 * 588 * 768)
    assert ops == {"int8": int8, "bf16": bf16, "f32": 0.0}
    assert work.matmul_least_s(REF, b, 16) == pytest.approx(int8 / 1979e12 + bf16 / 989e12)
    # the filter's float32 key projection appears only with the filter
    assert work.matmul_ops(REF, b, 16, (2, 0.35))["f32"] == 2 * 16 * (1370 * 768 ** 2 + 768 ** 2
                                                                   + 1370 * 768)


def test_family_least_time_sums_its_units():
    l = dims("vitl14_518_int8")
    fam = work.family_least_s(REF, l, 24)
    assert set(fam) == {"int8_block", "flash_attention", "focal_attention"}
    assert sum(fam.values()) == pytest.approx(sum(u.least_s for u in REF.units(l, 24)))


def test_every_roofline_reader_names_a_family():
    b = spec.bench()
    for m in b["per_layer"]:
        if m["name"].startswith("roofline_pct."):
            family = m["name"].split(".", 1)[1]
            assert family in work.family_least_s(REF, dims("vitb14_518_int8"), 1)
            assert m["unit"] == "%" and m["source"] == "device_trace"
    json.dumps(b)
