"""Plain PyTorch version of ``embed_bag``: gather + masked sum.

Sums in f32 whatever the table's type, as the TPU kernel accumulates (the
reference's jnp oracle sums in the table's type, so for a bf16 table the
two differ by bf16 rounding of the partial sums). Indices are valid in
``[0, V)``; ``-1`` is padding, and an index at or past ``V`` contributes
nothing, as in the TPU kernel's one-hot. ``"mean"`` divides by the count
of indices ``>= 0`` (at least 1), as the reference's wrapper does.

``embed_bag_backward_ref`` is the table's gradient: the output gradient
scatter-added into the rows the bags gathered, in f32.
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


def embed_bag_backward_ref(grad_out: torch.Tensor, indices: torch.Tensor,
                           num_rows: int, dtype: torch.dtype,
                           mode: str = "sum") -> torch.Tensor:
    """The gradient of ``embed_bag_ref(table, indices, mode)`` with respect
    to a ``[num_rows, D]`` table of ``dtype``, given ``grad_out[B, D]``.

    Each valid id adds its bag's output gradient to its row (duplicate ids
    accumulate; ``-1`` and ids at or past ``num_rows`` add nothing);
    ``"mean"`` divides by the bag's count of ids ``>= 0``, at least 1. Sums
    in f32 with ``index_add_``, then casts to ``dtype``.
    """
    if mode not in MODES:
        raise ValueError(f"unknown embed_bag mode {mode!r}; expected one "
                         f"of {MODES}")
    g = grad_out.float()
    if mode == "mean":
        cnt = torch.clamp_min(torch.sum(indices >= 0, dim=1, keepdim=True), 1)
        g = g / cnt.float()
    B, L = indices.shape
    grad = torch.zeros((num_rows, g.shape[1]), dtype=torch.float32,
                       device=g.device)
    if num_rows == 0:
        return grad.to(dtype)
    # every shape static, so a dry run traces this on stand-ins: an invalid
    # id adds an exact zero, each to a row of its own (spread over the
    # table, so no row takes every pad's atomic add on the card)
    valid = ((indices >= 0) & (indices < num_rows)).reshape(B * L)
    spread = torch.arange(B * L, device=g.device) % num_rows
    rows = torch.where(valid, indices.long().reshape(B * L), spread)
    src = torch.where(valid[:, None],
                      g[:, None, :].expand(B, L, g.shape[1]).reshape(
                          B * L, g.shape[1]), 0.0)                # [B L, D]
    return grad.index_add_(0, rows, src).to(dtype)
