"""Logging setup (counterpart of cognitive_aim_tpu/utils/logging.py): file
and console handlers writing training.log with the reference's format
string, the experiment directory layout, and parameter counts of an
``nn.Module`` or of a flat parameter dict."""

from __future__ import annotations

import logging
import os
from typing import Mapping, Union

import numpy as np
from torch import nn


def setup_logging(output_dir: str, log_level: int = logging.INFO) -> logging.Logger:
    os.makedirs(output_dir, exist_ok=True)
    log_file = os.path.join(output_dir, "training.log")
    formatter = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
    )
    root = logging.getLogger()
    root.setLevel(log_level)
    # avoid duplicate handlers on repeated setup
    root.handlers = [
        h for h in root.handlers
        if not isinstance(h, (logging.FileHandler, logging.StreamHandler))
    ]
    fh = logging.FileHandler(log_file)
    fh.setLevel(log_level)
    fh.setFormatter(formatter)
    ch = logging.StreamHandler()
    ch.setLevel(log_level)
    ch.setFormatter(formatter)
    root.addHandler(fh)
    root.addHandler(ch)
    return logging.getLogger("cognitive_aim_tpu_torch")


def setup_experiment_directory(output_dir: str, config: dict) -> str:
    """The reference's experiment layout: checkpoints/ logs/ predictions/
    tensorboard/ subdirectories plus a config.yaml snapshot of the config."""
    import yaml

    for subdir in ("checkpoints", "logs", "predictions", "tensorboard"):
        os.makedirs(os.path.join(output_dir, subdir), exist_ok=True)
    with open(os.path.join(output_dir, "config.yaml"), "w") as f:
        yaml.dump(config, f, default_flow_style=False)
    return output_dir


Params = Union[nn.Module, Mapping[str, np.ndarray]]


def _leaves(params: Params):
    if isinstance(params, nn.Module):
        return [p for p in params.parameters()]
    return list(params.values())


def count_parameters(params: Params) -> tuple[int, int]:
    """(total, total): every parameter of a module or flat dict; as in the
    JAX package, trainability is the optimizer's business, not counted here."""
    total = sum(int(np.prod(x.shape)) for x in _leaves(params))
    return total, total


def get_model_size_mb(params: Params) -> float:
    def nbytes(x):
        if isinstance(x, np.ndarray):
            return x.nbytes
        return x.numel() * x.element_size()

    return sum(nbytes(x) for x in _leaves(params)) / 1024 / 1024
