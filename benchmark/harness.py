"""One run of one cell: ``run(cell, seed, seconds, trace)``.

The cell's driver sets the system up, measures the window, and hands back
its end-to-end numbers, the records the per-layer readers read, and the
comparison of the window's outputs with the plain reference. This module
turns that into the result: stderr's last lines are the numbers compared,
each beside its limit; stdout's last line is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``).

A run that finds no card (or fewer than the cell asks for), or finds JAX
or the JAX package loaded once its window has closed, prints no result and
exits with another code than 0.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

from benchmark import spec, system
from benchmark.reference.layout import Dims

EXIT_NO_DEVICE, EXIT_FORBIDDEN = 5, 6


def _log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def process_age_s() -> float:
    """Seconds since this process started, by the kernel's clock
    (/proc/self/stat's start time against /proc/uptime)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


@dataclasses.dataclass
class Ctx:
    """What a driver is given."""
    root: Path
    cell: dict
    config_file: str
    cfg: dict
    ref: ModuleType  # the configuration's plain reference module
    traffic: dict
    dims: Dims
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    tiny: Optional[dict] = None  # tests: the configuration's tiny widths
    cleanup: List[str] = dataclasses.field(default_factory=list)

    log = staticmethod(_log)

    @property
    def token_filter(self):
        """(layer, keep) of the traffic's fused single-stage token filter,
        or None."""
        spec_ = self.traffic.get("token_filter", "")
        if not spec_:
            return None
        layer, keep = spec_.split(":")
        return int(layer), float(keep)

    def setup_s(self) -> float:
        return process_age_s()


@dataclasses.dataclass
class Outcome:
    """What a driver hands back."""
    e2e: Dict[str, float]  # the end-to-end numbers but setup_s
    setup_s: float
    attempted: int
    failed: int  # answers that never came
    numbers: Dict[str, float]  # the comparison with the reference
    memory_peak_bytes: int
    records: dict  # what the per-layer readers read
    stretch: object = None  # trace.Stretch of a --trace 1 run
    cases: list = None  # the compared (inputs, outputs) batches
    flat: dict = None  # the weights, for a control computed on the same cases


def tiny_config(cfg: dict, tiny: dict) -> dict:
    """The configuration at a test's tiny widths and image size."""
    cfg = json.loads(json.dumps(cfg))
    cfg["backbone"].update({k: v for k, v in tiny.items() if k != "image_size"})
    cfg["dataset"]["image_size"] = tiny["image_size"]
    return cfg


def _finite(v):
    return v if v is not None and math.isfinite(v) else None


def verdict(numbers: Dict[str, float], limits: Dict[str, float], failed: int) -> bool:
    """Every number that has a limit is there, finite and within it, and no
    answer was lost."""
    return failed == 0 and all(
        k in numbers and math.isfinite(numbers[k]) and numbers[k] <= v
        for k, v in limits.items())


def context(cell_name: str, seed: int, seconds: float, trace: bool, *,
            root: Path = spec.ROOT, device: str = "cuda", tiny: Optional[dict] = None) -> Ctx:
    import torch

    b = spec.bench(root)
    cell = spec.cell(b, cell_name)
    cfg = spec.config(root, b, cell["config"])
    if tiny is not None:
        cfg = tiny_config(cfg, tiny)
    ref = spec.reference(root, cell["config"])
    return Ctx(root=root, cell=cell, config_file=spec.config_entry(b, cell["config"])["file"],
               cfg=cfg, ref=ref, traffic=spec.traffic(root, cell_name), dims=ref.dims(cfg),
               seed=seed, seconds=seconds, trace=trace, device=torch.device(device), tiny=tiny)


def execute(cell_name: str, seed: int, seconds: float, trace: bool, *, root: Path = spec.ROOT,
            device: str = "cuda", tiny: Optional[dict] = None):
    """(exit code, the result line or None, the driver's Outcome or None)."""
    import torch

    b = spec.bench(root)
    cell = spec.cell(b, cell_name)
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell["chips"]):
        _log(f"{cell_name} needs {cell['chips']} CUDA device(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
        return EXIT_NO_DEVICE, None, None
    ctx = context(cell_name, seed, seconds, trace, root=root, device=device, tiny=tiny)
    drv = spec.driver(root, ctx.traffic["driver"])
    readers = {m["name"]: spec.metric(root, m["name"]) for m in spec.per_layer(b, cell_name)}
    try:
        res = drv.run(ctx)
    finally:
        for path in ctx.cleanup:
            os.remove(path)
    bad = system.forbidden_modules()
    if bad:
        _log(f"forbidden modules loaded: {', '.join(bad)}")
        return EXIT_FORBIDDEN, None, res

    units = {m["name"]: m["unit"] for m in b["end_to_end"] + b["per_layer"]}
    if trace:
        values = {}
        for name, reader in readers.items():
            v = reader.read(res.records)
            if v is not None:
                values[name] = v
    else:
        values = {m["name"]: ({**res.e2e, "setup_s": res.setup_s})[m["name"]]
                  for m in spec.end_to_end(b, cell_name)}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(res.memory_peak_bytes)}
    limits = ctx.traffic["limits"]
    line = {"correct": verdict(res.numbers, limits, res.failed), "attempted": res.attempted,
            "failed": res.failed,
            "metrics": {k: {"value": v, "unit": units[k]} for k, v in values.items()},
            "device": dev}
    if res.stretch is not None:
        dev.update(busy_s=res.stretch.busy_s, window_s=res.stretch.window_s)
        line["breakdown"] = res.stretch.breakdown
    unjudged = {k: v for k, v in res.numbers.items() if k not in limits}
    if unjudged:  # numbers with no limit (no control reading above them): logged only
        _log(f"not compared (no limit): {unjudged}")
    line["checks"] = {k: {"value": _finite(res.numbers.get(k)), "limit": v}
                      for k, v in limits.items()}
    line["checks"]["answers_lost"] = {"value": res.failed, "limit": 0}
    return 0, line, res


def run(cell_name: str, seed: int, seconds: float, trace: bool, **kw) -> int:
    """One run: the numbers compared as stderr's last lines, the result as
    stdout's last line."""
    rc, line, _ = execute(cell_name, seed, seconds, trace, **kw)
    if line is not None:
        for k, c in line["checks"].items():
            _log(f"check {k}: {c['value']!r} limit {c['limit']!r}")
        print(json.dumps(line), flush=True)
    return rc


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    return run(a.workload, a.seed, a.seconds, bool(a.trace))
