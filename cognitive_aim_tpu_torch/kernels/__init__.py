"""The hand-written Hopper kernels, each a ``caim`` custom op (``_library``).

Importing this package registers every op: a program that ``torch.export``
wrote loads and runs with this import alone, no model module."""

from cognitive_aim_tpu_torch.kernels import (  # noqa: F401  (registers the ops)
    flash_attention,
    focal_attention,
    int8_block,
    int8_gemm,
)
