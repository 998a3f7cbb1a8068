"""cognitive_aim_tpu_torch — the PyTorch + CUDA port of ``cognitive_aim_tpu``.

The JAX package beside this one is the reference; every module here keeps
the name and place of its counterpart there so a reader finds each pair:

  core/      precision policy, noise modes (torch.Generator draws), the
             default device, the device mesh
  nn/        layers, initializers, resize matrices, the DINOv2 ViT
  kernels/   hand-written Hopper kernels (CUDA C++ in csrc/), each with a
             plain PyTorch version beside it and a launch counter
  models/    config, guidance masks, curiosity VAE, cognitive streams, full
             model
  parallel/  differentiable collectives, the data- and tensor-parallel
             sharding rules, the GPipe pipeline (torch.distributed)
  io/        uint8 -> normalized NHWC preprocessing
  convert.py the JAX flat-parameter interchange -> this package's modules

Nothing here imports jax or any module of the JAX package: what the port
needs of a module there, it keeps as its own copy (``models/config.py``, the
numpy tables in ``models/``), held equal to the original by the tests.
"""

__version__ = "0.1.0"
