"""The ``count_flags`` wrapper: checks and dispatch.

A CUDA tensor launches the hand-written kernel (``count_flags.py``); a CPU
tensor takes the plain version (``ref.py``). The kernel is no custom op: it
counts what the lockstep search visited while a profiler records, which no
dry run traces.
"""
from __future__ import annotations

import torch

from .count_flags import count_flags_cuda
from .ref import count_flags_ref


def count_flags(flags: torch.Tensor, cols: int) -> torch.Tensor:
    """The number of set flags in ``flags[:, :cols]`` of a contiguous 2-D
    bool tensor, as a 0-d int64 tensor on its device (no host sync)."""
    if flags.dim() != 2 or flags.dtype != torch.bool:
        raise ValueError(f"count_flags takes a 2-D bool tensor, got "
                         f"{flags.dtype} of shape {tuple(flags.shape)}")
    if not 0 <= cols <= flags.shape[1]:
        raise ValueError(f"count_flags: cols {cols} outside 0.."
                         f"{flags.shape[1]}")
    if flags.device.type == "cpu":
        return count_flags_ref(flags, cols)
    if flags.device.type != "cuda":
        raise ValueError(f"count_flags runs on CUDA or CPU tensors, not "
                         f"{flags.device}")
    if not flags.is_contiguous():
        raise ValueError("count_flags kernel takes a contiguous tensor")
    out = count_flags_cuda(flags, cols)
    count_flags.launches += 1
    return out


#: kernel launches so far (CUDA calls only; reset it to 0 to count a run)
count_flags.launches = 0
