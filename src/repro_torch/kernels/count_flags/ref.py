"""Plain PyTorch version of ``count_flags``: the set flags of a matrix's
first columns."""
from __future__ import annotations

import torch


def count_flags_ref(flags: torch.Tensor, cols: int) -> torch.Tensor:
    """The number of set flags in ``flags[:, :cols]``, a 0-d int64 tensor."""
    return flags[:, :cols].sum(dtype=torch.int64)
