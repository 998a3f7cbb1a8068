"""The hand-written Hopper kernels, each a ``caim`` custom op (``_library``).

Importing this package registers every op: a program that ``torch.export``
wrote loads and runs with this import alone, no model module."""

from cognitive_aim_tpu_torch.kernels import (  # noqa: F401  (registers the ops)
    flash_attention,
    focal_attention,
    int8_block,
    int8_gemm,
)


def counters():
    """Every kernel wrapper that counts its launches in ``.launches`` (K4
    ``int8_mlp_ln`` counts its own calls beside K4a's and K4b's)."""
    return (*flash_attention.WRAPPERS, *int8_block.WRAPPERS,
            focal_attention.focal_attention_fused, int8_gemm.int8_gemm_fused)
