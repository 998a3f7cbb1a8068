"""Carry the JAX package's weights into this package's modules.

``load_flat_params(model, flat)`` takes the JAX package's flat interchange:
the ``api.flatten_tree`` keys (``backbone/layers/q/w``,
``focal_stream/streams/0/query_proj/w``, ...) mapped to numpy arrays. The
same dict comes from ``np.load`` of a JAX trainer ``.npz``, so it needs no
jax. It handles

  * the stacked [L, ...] layer axis of the backbone -> one Block per layer;
  * JAX's [in, out] Linear weights -> PyTorch's [out, in], transposed once;
  * q/k/v concatenated into the fused ``qkv`` projection, as the JAX
    backbone's ``apply`` concatenates them;
  * layernorm ``scale`` -> ``weight``, embedding ``table`` -> ``weight``;
  * the backbone's adapters ``backbone/layers/lora_*`` [L, ...] -> each
    Block's adapter parameters, untransposed (A [r, in], B [out, r] in both
    packages). A model built without ``use_lora`` takes them too and its
    forward ignores them, as the JAX package's exact path does; its
    ``merge_lora_params(rank, alpha)`` can still fold them;

and raises on a key it did not consume or a parameter it left unset.

The token filter and the attention kernels it reaches (K7, K10, K10b) add no
weights: a filtered model loads the same interchange as an exact one.
"""

from __future__ import annotations

from typing import Dict, Iterable, Set

import numpy as np
import torch
from torch import nn

from cognitive_aim_tpu_torch.nn.dinov2 import LORA_TARGETS, adapter_names

_LAYERS = "backbone/layers/"
_QKV = ("q", "k", "v")


def _torch_name(parts: Iterable[str]) -> tuple[str, bool]:
    """JAX path parts -> (parameter name, transpose?)."""
    *mod, leaf = parts
    transpose = leaf == "w"
    leaf = {"w": "weight", "b": "bias", "scale": "weight", "table": "weight"}.get(leaf, leaf)
    return ".".join([*mod, leaf]), transpose


@torch.no_grad()
def load_flat_params(model: nn.Module, flat: Dict[str, np.ndarray]) -> nn.Module:
    params = dict(model.named_parameters())
    assigned: Set[str] = set()

    def put(name: str, value, transpose: bool = False):
        if name not in params:
            raise KeyError(f"no parameter {name!r} in {type(model).__name__}")
        t = torch.from_numpy(np.array(value, np.float32))
        if transpose:
            t = t.T
        p = params[name]
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(p.shape)}")
        p.copy_(t)
        assigned.add(name)

    consumed: Set[str] = set()
    stacked: Dict[str, np.ndarray] = {}
    for key, value in flat.items():
        if key.startswith("__meta__/"):  # provenance strings, not parameters
            consumed.add(key)
        elif key.startswith(_LAYERS):
            stacked[key[len(_LAYERS):]] = value
        else:
            name, tr = _torch_name(key.split("/"))
            put(name, value, tr)
            consumed.add(key)

    if stacked:
        n_layers = len(model.backbone.layers)
        qkv_keys = [f"{n}/{leaf}" for n in _QKV for leaf in ("w", "b")]
        missing = [k for k in qkv_keys if k not in stacked]
        if missing:
            raise KeyError(f"backbone layers lack {missing}")
        depths = {np.shape(v)[0] for v in stacked.values()}
        if depths != {n_layers}:
            raise ValueError(f"stacked layer axis {sorted(depths)} != {n_layers} layers")
        for target in LORA_TARGETS:  # adapters the blocks were not built with
            a_name = adapter_names(target)[0]
            if a_name in stacked:
                for blk in model.backbone.layers:
                    if blk.adapter(target) is None:
                        blk.add_adapter(target, np.shape(stacked[a_name])[1])
        params = dict(model.named_parameters())
        for i in range(n_layers):
            pre = f"backbone.layers.{i}."
            # JAX [L, D, D] per projection -> [3D, D] rows q, k, v
            put(pre + "qkv.weight",
                np.concatenate([stacked[f"{n}/w"][i].T for n in _QKV], 0))
            put(pre + "qkv.bias",
                np.concatenate([stacked[f"{n}/b"][i] for n in _QKV], 0))
            for sub, value in stacked.items():
                if sub.split("/")[0] not in _QKV:
                    name, tr = _torch_name(sub.split("/"))
                    put(pre + name, value[i], tr)
        consumed.update(_LAYERS + s for s in stacked)

    leftover = sorted(set(flat) - consumed)
    unset = sorted(set(params) - assigned)
    if leftover or unset:
        raise ValueError(f"load_flat_params: keys not consumed {leftover}; "
                         f"parameters left unset {unset}")
    return model
