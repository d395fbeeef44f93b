"""PyTorch / CUDA port of ``opentsdb_tpu`` for NVIDIA Hopper GPUs.

A second package beside the JAX reference. It imports ``torch`` and
numpy, never ``jax`` or anything of ``opentsdb_tpu``; the fused query
kernels are hand-written CUDA C++ under ``csrc/``. Entry points run on
the card unless the caller passes ``tsd.torch.device=cpu``.
"""

__version__ = "0.1.0"

from opentsdb_tpu_torch.core.tsdb import TSDB  # noqa: E402
from opentsdb_tpu_torch.utils.config import Config  # noqa: E402

__all__ = ["TSDB", "Config", "__version__"]
