"""The benchmark's CPU tests: the harness at tiny widths through the
program's plain paths (``device="cpu"``), the roofline arithmetic, and the
reference against the program's CPU forward.

    python -m pytest -q benchmark/tests

Tests marked ``cuda`` need the card and skip without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

# a test's tiny widths: 3 blocks of D 64, 2 heads, 56 x 56 images (4 x 4 patches)
TINY = {"hidden_size": 64, "num_hidden_layers": 3, "num_attention_heads": 2, "image_size": 56}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
