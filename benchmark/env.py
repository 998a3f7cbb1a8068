"""The process environment of a run, set before torch loads: every build
and kernel cache the program or PyTorch may keep goes under ``build/`` in
the checkout, at fixed paths; a library that would load JAX by itself does
not; the host's thread pools keep one thread, so that the run's load is
its own few threads (the loop, the server's dispatcher, the clients)."""

import os
from pathlib import Path


def prepare(root: Path):
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(root / "build" / sub)
    os.environ["USE_FLAX"] = "0"
    # the host's threads: one for each pool the libraries would spread over the cores
    os.environ["OMP_NUM_THREADS"] = "1"
