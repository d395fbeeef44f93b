"""PyTorch / CUDA port of ``opentsdb_tpu`` for NVIDIA Hopper GPUs.

A second package beside the JAX reference. It imports ``torch`` and
numpy, never ``jax`` or anything of ``opentsdb_tpu``; the fused query
kernels are hand-written CUDA C++ under ``csrc/``. Entry points run on
the card unless the caller passes ``tsd.torch.device=cpu``.
"""

from opentsdb_tpu_torch.core.tsdb import TSDB
from opentsdb_tpu_torch.utils.config import Config

__all__ = ["TSDB", "Config"]
