"""Depth metric suite (a copy of cognitive_aim_tpu/train/metrics.py, which
imports nothing of jax; this package imports none of that one).

Implements the full validation vocabulary the reference declares but never
wires (ref:src/utils.py:74-133 formulas; configs/experiment_B.yaml
validation.metrics names: rmse, mae, abs_rel, sq_rel, log10, delta1/2/3,
threshold_acc). Vectorized with validity masking (target>0, pred>0, finite);
returns the reference's names plus the config names as aliases."""

from __future__ import annotations

from typing import Dict

import numpy as np


def calculate_depth_metrics(pred, target, mask=None) -> Dict[str, float]:
    pred = np.asarray(pred, np.float64).reshape(-1)
    target = np.asarray(target, np.float64).reshape(-1)
    if mask is not None:
        m = np.asarray(mask).reshape(-1).astype(bool)
        pred, target = pred[m], target[m]

    valid = (target > 0) & (pred > 0) & np.isfinite(pred) & np.isfinite(target)
    pred, target = pred[valid], target[valid]
    if pred.size == 0:
        inf = float("inf")
        return {
            "rmse": inf, "mae": inf, "delta_1": 0.0, "delta_2": 0.0,
            "delta_3": 0.0, "rel_error": inf, "log_error": inf,
            "abs_rel": inf, "sq_rel": inf, "log10": inf,
            "delta1": 0.0, "delta2": 0.0, "delta3": 0.0, "threshold_acc": 0.0,
        }

    rmse = float(np.sqrt(np.mean((pred - target) ** 2)))
    mae = float(np.mean(np.abs(pred - target)))
    abs_rel = float(np.mean(np.abs(pred - target) / target))
    sq_rel = float(np.mean(((pred - target) ** 2) / target))
    log_error = float(np.mean(np.abs(np.log(pred + 1e-8) - np.log(target + 1e-8))))
    log10 = float(np.mean(np.abs(np.log10(pred + 1e-8) - np.log10(target + 1e-8))))
    ratio = np.maximum(pred / target, target / pred)
    d1 = float(np.mean(ratio < 1.25))
    d2 = float(np.mean(ratio < 1.25**2))
    d3 = float(np.mean(ratio < 1.25**3))
    # threshold_acc: fraction within the config-declared 5cm precision target
    # (configs/experiment_B.yaml precision_optimization.target_accuracy_threshold)
    thr = float(np.mean(np.abs(pred - target) < 0.05))

    return {
        # reference names (ref:src/utils.py:125-133)
        "rmse": rmse, "mae": mae, "rel_error": abs_rel, "log_error": log_error,
        "delta_1": d1, "delta_2": d2, "delta_3": d3,
        # config vocabulary aliases (validation.metrics)
        "abs_rel": abs_rel, "sq_rel": sq_rel, "log10": log10,
        "delta1": d1, "delta2": d2, "delta3": d3, "threshold_acc": thr,
    }
