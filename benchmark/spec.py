"""Everything of a cell is found by its name in ``BENCHMARK.json``:

  * its configuration: the ``file`` of its ``configs`` entry;
  * its configuration's plain reference: the module under
    ``benchmark/reference/`` that ``benchmark/configs/<config>.reference.json``
    names (``{"reference": "benchmark/reference/<module>.py"}``), which
    holds everything that depends on the block: the sizes, the parameter
    layout and draws, the forward, the units of work and the program's
    backbone settings at a test's tiny widths (``reference/dinov2_gelu.py``
    lists them). The name sits beside the configuration file and not in
    it, since the program reads that file;
  * its traffic: ``benchmark/traffic/<cell>.json``, the driver's kind and its
    parameters, and the limits of the outputs' comparison;
  * its driver: ``benchmark/drivers/<kind>.py`` (``run(ctx) -> Outcome``);
  * its per-layer metrics: ``benchmark/metrics/<metric>.py`` for each
    ``per_layer`` entry whose ``workloads`` list the cell; each holds
    ``read(records) -> float | None``.

A later cell, configuration, block kind, traffic mix or metric is new files
and new entries: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]


def bench(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json", encoding="utf-8") as f:
        return json.load(f)


def cell(b: dict, name: str) -> dict:
    for w in b["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(cells: {', '.join(w['name'] for w in b['workloads'])})")


def config_entry(b: dict, name: str) -> dict:
    return next(c for c in b["configs"] if c["name"] == name)


def config(root: Path, b: dict, name: str) -> dict:
    with open(root / config_entry(b, name)["file"], encoding="utf-8") as f:
        return json.load(f)


def traffic(root: Path, cell_name: str) -> dict:
    with open(root / "benchmark" / "traffic" / f"{cell_name}.json", encoding="utf-8") as f:
        return json.load(f)


def _load(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # a dataclass in the module looks itself up there
    spec.loader.exec_module(mod)
    return mod


def reference(root: Path, config_name: str) -> ModuleType:
    """The plain reference module of a configuration."""
    with open(root / "benchmark" / "configs" / f"{config_name}.reference.json",
              encoding="utf-8") as f:
        path = Path(json.load(f)["reference"])
    if path.parent != Path("benchmark/reference") or path.suffix != ".py":
        raise ValueError(f"{config_name}'s reference {path} is not a module of "
                         f"benchmark/reference/")
    return _load(root / path, "benchmark_reference_" + path.stem)


def driver(root: Path, kind: str) -> ModuleType:
    return _load(root / "benchmark" / "drivers" / f"{kind}.py", f"benchmark_driver_{kind}")


def metric(root: Path, name: str) -> ModuleType:
    return _load(root / "benchmark" / "metrics" / f"{name}.py",
                 "benchmark_metric_" + name.replace(".", "_"))


def reports(entry: dict, cell_name: str) -> bool:
    """Whether a metric entry is reported in a cell (no ``workloads``: in
    every cell)."""
    return "workloads" not in entry or cell_name in entry["workloads"]


def end_to_end(b: dict, cell_name: str) -> List[dict]:
    return [m for m in b["end_to_end"] if reports(m, cell_name)]


def per_layer(b: dict, cell_name: str) -> List[dict]:
    return [m for m in b["per_layer"] if reports(m, cell_name)]


def cells(root: Path = ROOT) -> Dict[str, dict]:
    """Each cell with what it resolves to; raises where a file is missing."""
    b = bench(root)
    out = {}
    for w in b["workloads"]:
        t = traffic(root, w["name"])
        config(root, b, w["config"])
        ref = reference(root, w["config"])
        driver(root, t["driver"])
        for m in per_layer(b, w["name"]):
            metric(root, m["name"])
        out[w["name"]] = {"config": w["config"], "reference": Path(ref.__file__).name,
                          "driver": t["driver"], "chips": w["chips"],
                          "per_layer": [m["name"] for m in per_layer(b, w["name"])]}
    return out
