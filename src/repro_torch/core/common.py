"""Shared numeric utilities for the batched HNSW core.

Every function works on an explicit leading batch dimension where the JAX
reference used ``vmap``. Sorting is always stable, so ties keep index order
(the reference's ``jnp.argsort`` is stable too).
"""
from __future__ import annotations

import torch

INF = float("inf")
INVALID = -1


def pow2_at_least(n: int) -> int:
    """Smallest power of two >= n (host-side; capacities are always pow2)."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def resolve_device(device) -> torch.device:
    """The device an entry point creates its state on.

    ``"cuda"`` (the default everywhere) raises when no GPU is present: the
    port never moves work to the CPU unless the caller asks for it.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch entry points default to device='cuda' "
                           "but no GPU is available; pass device='cpu' to run "
                           "on the CPU")
    return dev


def stable_argsort(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.sort(x, dim=dim, stable=True).indices


def dedup_ids(ids: torch.Tensor, dists: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Invalidate duplicate ids along the last axis of ``ids[..., C]``.

    Keeps the first occurrence in id-sorted order; duplicates become
    ``(-1, INF)``. Invalid (-1) entries stay invalid.
    """
    order = stable_argsort(ids)
    s = torch.gather(ids, -1, order)
    dup_sorted = torch.zeros_like(s, dtype=torch.bool)
    dup_sorted[..., 1:] = (s[..., 1:] == s[..., :-1]) & (s[..., 1:] >= 0)
    dup = torch.zeros_like(dup_sorted).scatter_(-1, order, dup_sorted)
    return (torch.where(dup, INVALID, ids),
            torch.where(dup, INF, dists))


def topk_by_distance(ids: torch.Tensor, dists: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort candidates ascending by distance (stable), return the first k."""
    order = stable_argsort(dists)[..., :k]
    return torch.gather(ids, -1, order), torch.gather(dists, -1, order)


def scatter_or(dst: torch.Tensor, idx: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """``dst[idx] |= valid`` for a bool vector, dropping invalid indices."""
    out = dst.clone()
    out[idx[valid]] = True
    return out


def nonzero_padded(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=fill)`` for a 1-D mask:
    the first ``size`` True positions in ascending order, padded with
    ``fill``."""
    idx = torch.nonzero(mask).reshape(-1)[:size].to(torch.int64)
    if idx.numel() < size:
        idx = torch.cat([idx, torch.full((size - idx.numel(),), fill,
                                         dtype=torch.int64,
                                         device=mask.device)])
    return idx
