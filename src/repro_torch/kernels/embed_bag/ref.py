"""Plain PyTorch version of ``embed_bag``: gather + masked sum.

Sums in f32 whatever the table's type, as the TPU kernel accumulates (the
reference's jnp oracle sums in the table's type, so for a bf16 table the
two differ by bf16 rounding of the partial sums). Indices are valid in
``[0, V)``; ``-1`` is padding, and an index at or past ``V`` contributes
nothing, as in the TPU kernel's one-hot. ``"mean"`` divides by the count
of indices ``>= 0`` (at least 1), as the reference's wrapper does.
"""
from __future__ import annotations

import torch

MODES = ("sum", "mean")


def embed_bag_ref(table: torch.Tensor, indices: torch.Tensor,
                  mode: str = "sum") -> torch.Tensor:
    """``out[b] = reduce_l table[indices[b, l]]`` in f32, ``-1`` = pad."""
    if mode not in MODES:
        raise ValueError(f"unknown embed_bag mode {mode!r}; expected one "
                         f"of {MODES}")
    V = table.shape[0]
    valid = (indices >= 0) & (indices < V)
    rows = table[indices.long().clamp(0, max(V - 1, 0))].float()  # [B, L, D]
    out = torch.sum(rows * valid[..., None], dim=1)
    if mode == "mean":
        cnt = torch.clamp_min(torch.sum(indices >= 0, dim=1, keepdim=True), 1)
        out = out / cnt.float()
    return out
