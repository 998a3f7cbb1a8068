"""The port's training benchmarks (scripts/torch_bench_train.py,
scripts/torch_bench_train_table.py) on the CPU at a tiny width: the bench's
two lines, each with the eager step beside it, and its numbers; the table's
parsing of those lines. The numbers are host clocks of a CPU run, where the
step runs eagerly, and say nothing of the card."""

import os
import re
import sys

import pytest
import torch

from cognitive_aim_tpu_torch.nn.dinov2 import DinoV2Config

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import torch_bench_train as BT  # noqa: E402
import torch_bench_train_table as BTT  # noqa: E402

TINY = DinoV2Config(hidden_size=64, num_layers=2, num_heads=4, patch_size=14,
                    pretrain_image_size=28)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("frozen,spec", [("1", ""), ("0", "1:0.5")], ids=["lora", "full_filter"])
def test_bench_train_prints_both_lines_with_the_eager_step(frozen, spec, capsys):
    env = {"TB_B": "4", "TB_S": "28", "TB_FROZEN": frozen, "TB_FILTER": spec}
    got = BT.main(["--steps", "2", "--device-steps", "2", "--device", "cpu"], vit_cfg=TINY,
                  env=env)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "cpu"
    step, dev = BTT.STEP.search(lines[1]), BTT.DEV.search(lines[2])
    assert step and dev
    assert float(step.group(1)) == pytest.approx(got["step_ms"], abs=0.05)
    assert re.search(r"; eager [\d.]+ ms/step \(\d+ img/s\)", lines[1])
    assert re.search(r"; eager [\d.]+ ms/step \(\d+ img/s\)", lines[2])
    assert got["device"] == "cpu" and got["batch"] == 4 and got["frozen"] == (frozen == "1")
    assert got["token_filter"] == spec and "graphs" not in got  # the CPU trainer runs eagerly
    for k in ("step_ms", "eager_ms", "device_only_step_ms", "device_only_eager_ms"):
        assert got[k] > 0
    assert lines[-1].startswith("{")


def test_table_rows_are_the_jax_scripts():
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "jax_table", os.path.join(root, "scripts", "bench_train_table.py"))
    jax_table = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_table)  # imports no jax: it only runs subprocesses
    assert BTT.ROWS == jax_table.ROWS
