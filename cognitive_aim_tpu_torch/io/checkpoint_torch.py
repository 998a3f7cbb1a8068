"""PyTorch state dict -> flat parameter interchange (the port's copy of
cognitive_aim_tpu/io/checkpoint_torch.py, held equal to it by the tests).

Converts a reference ``cognitive_aim_model.pth`` state dict (or any torch
state dict of the reference architecture) into the flat interchange that
``convert.load_flat_params`` consumes: ``/``-joined keys
(``layers/q/w``, ``streams/0/query_proj/w``, ...) mapped to numpy arrays,
the keys ``api.flatten_tree`` gives the JAX converters' trees. Each
converter returns the keys of its own subtree; ``api`` prefixes them with
the module's name. It keeps the reference's tolerant-loading semantics:

  * container formats: ``model_state_dict`` / ``main_model`` / raw dict;
  * per-tensor shape filtering against the live parameters
    (``filter_and_merge``): mismatched shapes are skipped, missing
    parameters keep their fresh initialization;
  * the optional ``create_model`` prefix skip-list.

Linear weights go from torch's (out, in) to the interchange's (in, out);
the patch-embed conv kernel is reshaped to the patchify-matmul layout.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np

CREATE_MODEL_SKIP_PREFIXES = (
    "decision_head.",
    "confidence_head.",
    "curiosity_module.",
    "global_aligner.",
    "ambient_stream.",
    "focal_stream.",
    "exif_prior.",
    "fusion.",
)

Flat = Dict[str, np.ndarray]


def _np(v):
    if hasattr(v, "detach"):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _sub(prefix: str, flat: Flat) -> Flat:
    """A subtree's keys under ``prefix``."""
    return {f"{prefix}/{k}": v for k, v in flat.items()}


def unwrap_container(ckpt: Mapping) -> Mapping:
    """Container detection: ``model_state_dict``, ``main_model`` or raw."""
    if "model_state_dict" in ckpt:
        return ckpt["model_state_dict"]
    if "main_model" in ckpt:
        return ckpt["main_model"]
    return ckpt


def _lin(sd, name) -> Flat:
    """torch Linear -> {'w': (in, out), 'b': (out,)}"""
    out = {"w": _np(sd[f"{name}.weight"]).T}
    if f"{name}.bias" in sd:
        out["b"] = _np(sd[f"{name}.bias"])
    return out


def _ln(sd, name) -> Flat:
    return {"scale": _np(sd[f"{name}.weight"]), "bias": _np(sd[f"{name}.bias"])}


# ----------------------------------------------------------- backbone -------
def convert_backbone(sd: Mapping, prefix: str = "backbone.") -> Flat:
    """HF Dinov2Model state dict -> the backbone's flat keys (layers stacked
    on a leading [L] axis)."""
    p = prefix
    n_layers = 0
    pat = re.compile(re.escape(p) + r"encoder\.layer\.(\d+)\.")
    for k in sd:
        m = pat.match(k)
        if m:
            n_layers = max(n_layers, int(m.group(1)) + 1)

    conv_w = _np(sd[f"{p}embeddings.patch_embeddings.projection.weight"])
    D, C, ph, pw = conv_w.shape
    # conv (D, C, ph, pw) -> matmul (ph*pw*C, D) with (row, col, channel) order
    w = conv_w.transpose(2, 3, 1, 0).reshape(ph * pw * C, D)

    layer_flats = []
    for i in range(n_layers):
        lp = f"{p}encoder.layer.{i}."
        flat = {
            **_sub("norm1", _ln(sd, f"{lp}norm1")),
            **_sub("q", _lin(sd, f"{lp}attention.attention.query")),
            **_sub("k", _lin(sd, f"{lp}attention.attention.key")),
            **_sub("v", _lin(sd, f"{lp}attention.attention.value")),
            **_sub("attn_out", _lin(sd, f"{lp}attention.output.dense")),
            "ls1": _np(sd[f"{lp}layer_scale1.lambda1"]),
            **_sub("norm2", _ln(sd, f"{lp}norm2")),
            **_sub("fc1", _lin(sd, f"{lp}mlp.fc1")),
            **_sub("fc2", _lin(sd, f"{lp}mlp.fc2")),
            "ls2": _np(sd[f"{lp}layer_scale2.lambda1"]),
        }
        # reference LoRA parameters live OUTSIDE the backbone prefix:
        # lora_layers.{i}.lora_A / lora_B
        if f"lora_layers.{i}.lora_A" in sd:
            flat["lora_A"] = _np(sd[f"lora_layers.{i}.lora_A"])
            flat["lora_B"] = _np(sd[f"lora_layers.{i}.lora_B"])
        layer_flats.append(flat)

    out = {
        "cls_token": _np(sd[f"{p}embeddings.cls_token"]),
        "pos_embed": _np(sd[f"{p}embeddings.position_embeddings"]),
        "patch_embed/w": w,
        "patch_embed/b": _np(sd[f"{p}embeddings.patch_embeddings.projection.bias"]),
        **_sub("final_norm", _ln(sd, f"{p}layernorm")),
    }
    if layer_flats:
        out.update({f"layers/{k}": np.stack([f[k] for f in layer_flats], 0)
                    for k in layer_flats[0]})
    if f"{p}embeddings.mask_token" in sd:
        out["mask_token"] = _np(sd[f"{p}embeddings.mask_token"])
    return out


# ----------------------------------------------------- cognitive modules ----
def _seq_mlp(sd, name, linear_indices) -> Flat:
    """torch nn.Sequential of Linears (at the given indices) -> fc0, fc1, ..."""
    out: Flat = {}
    for j, idx in enumerate(linear_indices):
        out.update(_sub(f"fc{j}", _lin(sd, f"{name}.{idx}")))
    return out


def convert_focal_stream(sd, name) -> Flat:
    """FocalStream parameters."""
    out = {
        **_sub("query_proj", _lin(sd, f"{name}.query_proj")),
        **_sub("key_proj", _lin(sd, f"{name}.key_proj")),
        **_sub("value_proj", _lin(sd, f"{name}.value_proj")),
        # projection: Sequential(Linear, ReLU, Dropout, Linear) -> idx 0, 3
        **_sub("projection", _seq_mlp(sd, f"{name}.projection", (0, 3))),
        "adaptive_weight": _np(sd[f"{name}.adaptive_weight"]),
    }
    if f"{name}.curiosity_modulator.0.weight" in sd:
        out.update(_sub("curiosity_modulator",
                        _seq_mlp(sd, f"{name}.curiosity_modulator", (0, 2))))
    return out


def convert_iterative_focal(sd, name="focal_stream") -> Flat:
    """IterativeFocalStream: N member streams (``streams/<i>/...``), the
    fusion MLP, initial_focus, the optional curiosity_amplifier."""
    n = 0
    pat = re.compile(re.escape(name) + r"\.focal_streams\.(\d+)\.")
    for k in sd:
        m = pat.match(k)
        if m:
            n = max(n, int(m.group(1)) + 1)
    out: Flat = {}
    for i in range(n):
        out.update(_sub(f"streams/{i}", convert_focal_stream(sd, f"{name}.focal_streams.{i}")))
    out.update(_sub("fusion", _seq_mlp(sd, f"{name}.fusion", (0, 2))))
    out["initial_focus"] = _np(sd[f"{name}.initial_focus"])
    if f"{name}.curiosity_amplifier.0.weight" in sd:
        out.update(_sub("curiosity_amplifier",
                        _seq_mlp(sd, f"{name}.curiosity_amplifier", (0, 2))))
    return out


def convert_ambient(sd, name="ambient_stream") -> Flat:
    """AmbientStream MLP: Sequential(L, ReLU, Drop, L, ReLU, L) -> idx 0, 3, 5."""
    return _sub("mlp", _seq_mlp(sd, f"{name}.mlp", (0, 3, 5)))


def convert_exif_prior(sd, name="exif_prior") -> Flat:
    """EXIFPriorDatabase."""
    return {
        "camera_embedding/table": _np(sd[f"{name}.camera_embedding.weight"]),
        **_sub("exif_encoder", _seq_mlp(sd, f"{name}.exif_encoder", (0, 2))),
        **_sub("fusion", _seq_mlp(sd, f"{name}.fusion", (0, 3))),
    }


def convert_curiosity(sd, name="curiosity_module") -> Flat:
    """CuriosityModule."""
    out = {
        **_sub("encoder_mean", _seq_mlp(sd, f"{name}.encoder_mean", (0, 3))),
        **_sub("encoder_logvar", _seq_mlp(sd, f"{name}.encoder_logvar", (0, 3))),
        **_sub("decoder", _seq_mlp(sd, f"{name}.decoder", (0, 3))),
        **_sub("uncertainty_head", _seq_mlp(sd, f"{name}.uncertainty_head", (0, 2))),
    }
    if f"{name}.geometric_curiosity.0.weight" in sd:
        out.update(_sub("geometric_curiosity",
                        _seq_mlp(sd, f"{name}.geometric_curiosity", (0, 2))))
        out.update(_sub("local_curiosity", _seq_mlp(sd, f"{name}.local_curiosity", (0, 2))))
        out["curiosity_weights"] = _np(sd[f"{name}.curiosity_weights"])
    return out


def convert_heads(sd) -> Flat:
    """fusion / decision_head / confidence_head, keyed from the model's root."""
    return {
        **_sub("fusion", _seq_mlp(sd, "fusion", (0,))),
        **_sub("decision_head", _seq_mlp(sd, "decision_head", (0,))),
        **_sub("confidence_head", _seq_mlp(sd, "confidence_head", (0, 2))),
    }


# --------------------------------------------------------------- loading ----
def filter_and_merge(target: Flat, incoming: Flat) -> Tuple[Flat, int, int]:
    """Shape-filter semantics on the flat interchange: an incoming leaf is
    kept only where the target has the same key with the same shape (cast
    to the target's dtype); everything else keeps the target's value.
    Returns (merged, n_loaded, n_skipped); an incoming key the target lacks
    counts as neither."""
    loaded = skipped = 0
    merged: Flat = {}
    for key, tval in target.items():
        ival = incoming.get(key)
        if ival is not None and tuple(np.shape(ival)) == tuple(np.shape(tval)):
            merged[key] = np.asarray(ival, dtype=np.asarray(tval).dtype)
            loaded += 1
        else:
            merged[key] = tval
            if ival is not None:
                skipped += 1
    return merged, loaded, skipped


def apply_skip_prefixes(sd: Mapping, skip_prefixes=CREATE_MODEL_SKIP_PREFIXES):
    """create_model's non-strict prefix skip."""
    return {
        k: v
        for k, v in sd.items()
        if not any(k.startswith(pref) for pref in skip_prefixes)
    }


def load_torch_file(path: str) -> Mapping:
    import torch

    # weights_only=False, as the JAX package loads: reference checkpoints
    # pickle more than tensors (optimizer state, configs)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return unwrap_container(ckpt)
