"""Unreachable-point detection.

Two criteria:

  * ``indegree_unreachable`` — the paper's Definition 1 verbatim: a live point
    with zero in-edges on every layer (and not the entry point), from one
    ``bincount`` of the adjacency.
  * ``bfs_unreachable`` — graph-search reachability: the closure of the
    entry point under every layer's out-edges, descending through the layers
    (a superset of what HNSW search can visit). The port expands only the
    newly reached frontier per step; the closure equals the reference's
    whole-graph fix-point.
"""
from __future__ import annotations

import torch

from .index import HNSWIndex


def _live(index: HNSWIndex) -> torch.Tensor:
    return (index.levels >= 0) & ~index.deleted


def indegree(index: HNSWIndex) -> torch.Tensor:
    """Total in-edge count per slot across all layers (from any valid slot)."""
    L, N, M0 = index.neighbors.shape
    src_exists = (index.levels >= 0)[None, :, None]
    flat = index.neighbors[(index.neighbors >= 0) & src_exists]
    return torch.bincount(flat.long(), minlength=N).to(torch.int32)


def indegree_unreachable(index: HNSWIndex) -> torch.Tensor:
    """bool[N]: live, not entry, zero in-edges on every layer (Definition 1)."""
    unreach = _live(index) & (indegree(index) == 0)
    unreach[index.entry.long().clamp_min(0)] = False
    return unreach


def _bfs_layer(nbrs_layer: torch.Tensor, reached: torch.Tensor
               ) -> torch.Tensor:
    """Closure of ``reached`` under one layer's out-edges."""
    frontier = reached
    while True:
        src = torch.nonzero(frontier).reshape(-1)
        if src.numel() == 0:
            return reached
        t = nbrs_layer[src].reshape(-1)
        t = t[t >= 0].long()
        new = torch.zeros_like(reached)
        new[t] = True
        frontier = new & ~reached
        reached = reached | new


def bfs_reachable(index: HNSWIndex) -> torch.Tensor:
    """bool[N]: slots visitable by descending search from the entry point."""
    L, N, M0 = index.neighbors.shape
    reached = torch.zeros(N, dtype=torch.bool, device=index.device)
    reached[index.entry.long().clamp_min(0)] = bool(index.entry >= 0)
    for layer in range(L - 1, -1, -1):
        reached = _bfs_layer(index.neighbors[layer], reached)
    return reached


def bfs_unreachable(index: HNSWIndex) -> torch.Tensor:
    """bool[N]: live points that descending graph search can never visit."""
    return _live(index) & ~bfs_reachable(index)


def count_unreachable(index: HNSWIndex) -> tuple[int, int]:
    """(definition1_count, bfs_count) — the paper reports Definition 1."""
    return (int(indegree_unreachable(index).sum()),
            int(bfs_unreachable(index).sum()))
