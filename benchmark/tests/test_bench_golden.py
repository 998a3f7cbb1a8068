"""What the benchmark reads for the two configurations, held bit for bit to
values recorded before the reference became a property of the
configuration (``benchmark/configs/<config>.reference.json``), so that the
move changed no weight, no reference output and no count of work:

  * the parameter layout at full widths (SHA-256 of the sorted keys and
    shapes);
  * the seeded weight buffer at the tests' tiny widths on the CPU, two
    seeds (the draw's keys, order and rules);
  * the reference's outputs on one seeded batch at tiny widths on the CPU,
    unguided and guided, exact and under the ``2:0.35`` filter, and the
    int4 control's (SHA-256 of each float32 output; one thread, as
    recorded with torch 2.13 on an x86-64 CPU: another CPU kernel build
    may round a product otherwise);
  * each cell's units of work (every unit's bytes and operations), its
    families' least times and the mfu numerator, at the cell's batch and
    filter (exact floats).
"""

import hashlib
import json

import numpy as np
import pytest
import torch

from benchmark import inputs, spec
from benchmark.harness import tiny_config
from benchmark.roofline import work
from conftest import TINY

CONFIGS = ["vitb14_518_int8", "vitl14_518_int8"]
SHAPES = {"vitb14_518_int8": "0976b1bc3d86c7938036c5bc82901dde21b27bd166073bc60cb96464005944fb",
          "vitl14_518_int8": "8564a8a11905c20c37bef4a60481522aa2c9d866516c0478338a59799e7003ad"}
# the two configurations are alike at the tiny widths
WEIGHTS = {3: "e363f345a625dc3ccd7ff06baff8ea31efccbe62d233543a027e58747f2a1923",
           2 ** 31 + 7: "0dd2f781da44dc288d78bc83f61a45a543ad9444720d89a06cd47eb7548e0966"}
FORWARD = {
    ("unguided", None, 8): {
        "attention": "39a36eb41917090fbe7bcff866ef7d7380b74dc5ab18035ee02dcfadf4deab59",
        "confidence": "e19c0722cb063e2d90f50cdfaa19fa0c6dd5d7250c9928e3b955211c5ad39d08",
        "curiosity": "e52c09bc0b4a18d00797e2d04ec9fb3400bf61c3eb3fd874b08409420a115af4",
        "depth": "371630c084702efd0ef1028a7ea6d5f024b1f1be886d9afbdac0367325d8f1f9",
        "focal_attention": "39a36eb41917090fbe7bcff866ef7d7380b74dc5ab18035ee02dcfadf4deab59"},
    ("unguided", (2, 0.35), 8): {
        "attention": "c520af727b1fdeb4b6386ef9d634d20ac50b45cad3bd53c965f2592c7f2eabbf",
        "confidence": "2c4e014cb828fc7a42180a66a016fd573217065a8f2f071d2b6d14843866bd65",
        "curiosity": "779bc530a0ef9fde32a2b46e196056d8d9f64a496c111b1aa1311a715509fc04",
        "depth": "e3a4353f17ae802e38847372e85549a287133532d3405327e3f489b4e99b2cdb",
        "focal_attention": "c520af727b1fdeb4b6386ef9d634d20ac50b45cad3bd53c965f2592c7f2eabbf"},
    ("guided", None, 8): {
        "attention": "0fe03ea628e90f16c27a44fad1f64ee95b8750ef211de9b8bac2700e07598e1c",
        "confidence": "462f4d1de8e85ecff88a65002294ee8c7d094e8e1cadf85e7bac4699efab794c",
        "curiosity": "e52c09bc0b4a18d00797e2d04ec9fb3400bf61c3eb3fd874b08409420a115af4",
        "depth": "599c035137f7ba702c46d96edb1a728d5015c76751986e04944d206f90f4e96c",
        "focal_attention": "39a36eb41917090fbe7bcff866ef7d7380b74dc5ab18035ee02dcfadf4deab59"},
    ("guided", (2, 0.35), 8): {
        "attention": "bae2f82ee43a3af6b24c732141fe26ab3dde4e3806b8066ed6d98f6a9e9b1c6a",
        "confidence": "34cd330f3a77a0ecc1199e1641e59f67126457eef438ba064eb5cf25ba228714",
        "curiosity": "a882343b2d6bada37e12327844ef068d1d1bfd7a4ff81e49eb318cfdcc6b2f30",
        "depth": "bfdacb56ae69ec06fd755ca1608e4a210132594416d2176e35f8705150526e54",
        "focal_attention": "7108642c8994f7142cd89e9cc9e885f1d347336e18af7e3c1cdbe4eedd16d19f"},
    ("guided", None, 4): {
        "attention": "766a66294664895cd2e30080152c09bfefc3106061270b2452ce36ff6b9c54c0",
        "confidence": "3fd577a305f3c0a3e2fd9e5488637630465dd20f914e563f14dccf074ba2a21f",
        "curiosity": "f75f2e4aed39be65920692b3c4c5fff6480fc7927f947a768429cd8a2bf1d310",
        "depth": "4b53e21ee47a39a140928dc2f9d3f225419537f91d97290c328cdf313951460a",
        "focal_attention": "b0906e06b0d69cbd647e1b807b8dd66942090fda89d3d1b3d08ab40f2457eadd"},
}
# cell -> (config, batch, filter), SHA-256 of its units, family least times, mfu numerator
WORK = {
    "vitb14_518_int8.offline_b16": (
        ("vitb14_518_int8", 16, None),
        "9fe4262d226ff8f0e300e4182d64a6aaf1c432b7f0330c3fa33fbca8fa74c427",
        {"int8_block": "0x1.1edc6060dac37p-9", "flash_attention": "0x1.256e8ba3f2a01p-10",
         "focal_attention": "0x1.86abe5d9182e6p-13"},
        "0x1.aea34e0430e4ap-9"),
    "vitl14_518_int8.served_b16": (
        ("vitl14_518_int8", 16, None),
        "8ed0422e3f489f8e67e74a3e08ee76fe7902952155a9128720011789d9ec3bea",
        {"int8_block": "0x1.dabfab85d3fb8p-8", "flash_attention": "0x1.873e0f8543806p-9",
         "focal_attention": "0x1.0472993b65744p-12"},
        "0x1.4a99bd79cf21dp-7"),
    "vitb14_518_int8.filter235_b16": (
        ("vitb14_518_int8", 16, (2, 0.35)),
        "0fe595ef88418ae5a685996566cbcb10b83534666eb28835d2bab766cd0cb435",
        {"int8_block": "0x1.143c2ec26de2dp-10", "flash_attention": "0x1.579fdf6f73035p-12",
         "focal_attention": "0x1.86abe5d9182e6p-13"},
        "0x1.e18d6190ce0bbp-10"),
    "vitl14_518_int8.offline_b24": (
        ("vitl14_518_int8", 24, None),
        "8cbf2aeb2b83e6cdbc9715ac64ea4e5343d0653b4a6bcf1462bd3450764b1d30",
        {"int8_block": "0x1.63efdff7e31e6p-7", "flash_attention": "0x1.256e8ba3f2a01p-8",
         "focal_attention": "0x1.86abe5d9182e6p-12"},
        "0x1.efe69c36b6b2ap-7"),
}


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _ref(name):
    return spec.reference(spec.ROOT, name)


def _cfg(name):
    return spec.config(spec.ROOT, spec.bench(), name)


@pytest.mark.parametrize("name", CONFIGS)
def test_parameter_layout(name):
    ref = _ref(name)
    shapes = ref.param_shapes(ref.dims(_cfg(name)))
    assert _sha(json.dumps(sorted((k, list(v)) for k, v in shapes.items())).encode()) \
        == SHAPES[name]


@pytest.mark.parametrize("seed", sorted(WEIGHTS))
@pytest.mark.parametrize("name", CONFIGS)
def test_weight_buffer(name, seed):
    ref = _ref(name)
    host, _ = inputs.weights(ref, ref.dims(tiny_config(_cfg(name), TINY)), seed, "cpu")
    assert _sha(host.tobytes()) == WEIGHTS[seed]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("guided,token_filter,bits", sorted(FORWARD, key=str))
def test_reference_outputs(guided, token_filter, bits, one_thread):
    ref = _ref("vitb14_518_int8")
    d = ref.dims(tiny_config(_cfg("vitb14_518_int8"), TINY))
    _, flat = inputs.weights(ref, d, 3, "cpu")
    B = 6
    images = inputs.images_u8(B, d.image, 3, "golden", "cpu")
    exif = {k: torch.from_numpy(v) for k, v in inputs.exif(B, 3, "golden", d.num_cameras).items()}
    gidx = torch.from_numpy(inputs.instructions(B, 3, "golden").astype(np.int64))
    out = ref.forward(inputs.on_device(flat, "cpu"), d, images, exif,
                      gidx if guided == "guided" else None, token_filter=token_filter, bits=bits)
    got = {k: _sha(v.contiguous().numpy().tobytes()) for k, v in sorted(out.items())}
    assert got == FORWARD[(guided, token_filter, bits)]


@pytest.mark.parametrize("cell", sorted(WORK))
def test_work_counts(cell):
    (name, B, tf), units, family, mfu = WORK[cell]
    ref = _ref(name)
    d = ref.dims(_cfg(name))
    rows = [(u.family, u.kernel, u.tokens, float(u.bytes).hex(), float(u.ops).hex(), u.kind)
            for u in ref.units(d, B, tf)]
    assert _sha(json.dumps(rows).encode()) == units
    assert {k: v.hex() for k, v in work.family_least_s(ref, d, B, tf).items()} == family
    assert work.matmul_least_s(ref, d, B, tf).hex() == mfu
