"""Hand-written Hopper kernels of the port.

  topk_dist — streaming masked distance + running top-k (CUDA C++,
              ``sm_90a``), the exact scan tier behind ``exact_scan`` and
              the brute-force ground truth.

Each package ships the launcher (``<name>.py``, which builds the CUDA
source at first use), ``ops.py`` (checks and dispatch: the kernel for CUDA
tensors, the plain version for CPU tensors) and ``ref.py`` (plain PyTorch).
"""
from .topk_dist import topk_dist

__all__ = ["topk_dist"]
