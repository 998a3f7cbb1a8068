"""The certification toolchain (counterpart of the JAX package's
``scripts/procedural_scenes.py``, ``train_synth_ckpt.py``,
``pretrain_procedural.py``, ``policy_delta.py``, ``attention_stats.py``,
``delta_sweep.py`` and ``certify_filter.py``): procedural training data, the
training runs that give the port weights of its own, and the accuracy
measurements on them (int8 and token-filter deltas against the strict
float32 path, CLS-attention concentration, the certification table).

Each module runs as ``python -m cognitive_aim_tpu_torch.certify.<module>``
with its script's flags, on the CUDA device unless ``--device cpu``.
"""
