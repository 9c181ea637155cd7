"""Neighbour-selection heuristics: HNSW Algorithm 4 generalised with alpha-RNG.

The alpha-RNG rule (DiskANN RobustPrune, used by the paper with alpha in
{1.0, 1.1}): scanning candidates in ascending distance-to-query order, keep
candidate ``c`` iff for every already-selected ``r``:

    alpha * d(r, c) > d(q, c)

With alpha = 1 this is the original HNSW select-neighbours heuristic.
Dominance distances are computed lazily against the <= m_out selected
vectors only. Every lane of a ``[A, C]`` batch scans in lockstep; a lane
that is full or out of candidates stops changing.
"""
from __future__ import annotations

import torch

from .common import INF, INVALID, dedup_ids, stable_argsort
from .metrics import dist_point
from .search import CHECK_EVERY


def select_neighbors(
    q,                           # [A, d] query vectors (used only via dists)
    cand_ids: torch.Tensor,      # [A, C] int, -1 = invalid
    cand_vecs: torch.Tensor,     # [A, C, d] (garbage ok if invalid)
    cand_dists: torch.Tensor,    # [A, C] f32 distance(q, cand), INF = invalid
    m_out: int,
    alpha: float = 1.0,
    space: str = "l2",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Select up to ``m_out`` neighbours per lane by the alpha-RNG rule.

    Returns ``(ids[A, min(C, m_out)] i64, dists[A, min(C, m_out)])`` padded
    with (-1, INF), sorted by ascending distance to the query.
    """
    A, C, d = cand_vecs.shape
    dev = cand_vecs.device
    cand_ids, cand_dists = dedup_ids(cand_ids.long(), cand_dists)
    order = stable_argsort(cand_dists)
    ids = cand_ids.gather(1, order)
    dq = cand_dists.gather(1, order)
    vecs = cand_vecs.gather(1, order[..., None].expand(A, C, d))

    rows = torch.arange(A, device=dev)
    slots = torch.arange(m_out, device=dev)
    selected = torch.zeros((A, C), dtype=torch.bool, device=dev)
    sel_vecs = torch.zeros((A, m_out, d), dtype=vecs.dtype, device=dev)
    count = torch.zeros(A, dtype=torch.int64, device=dev)
    for i in range(C):
        running = (count < m_out) & (dq[:, i] < INF)
        if i % CHECK_EVERY == 0 and not bool(running.any()):
            break
        v = vecs[:, i]
        dd = dist_point(space, v, sel_vecs)                  # d(r, c_i)
        active = slots[None, :] < count[:, None]
        dom = torch.any(active & (alpha * dd <= dq[:, i:i + 1]), dim=1)
        keep = running & ~dom
        at = count.clamp_max(m_out - 1)
        sel_vecs[rows, at] = torch.where(keep[:, None], v, sel_vecs[rows, at])
        selected[:, i] = keep
        count = count + keep.long()

    key = torch.where(selected, dq, INF)
    out_order = stable_argsort(key)[:, :m_out]
    key_s = key.gather(1, out_order)
    out_ids = torch.where(key_s < INF, ids.gather(1, out_order), INVALID)
    return out_ids, key_s


def alpha_rng_select(
    cand_ids: torch.Tensor,      # [A, C] int, -1 = invalid
    cand_dists: torch.Tensor,    # [A, C] f32 distance to the query point
    cand_vecs: torch.Tensor,     # [A, C, d] candidate vectors
    m_out: int,
    alpha: float,
    space: str = "l2",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Back-compat wrapper (vector-based since the lazy-scan rewrite)."""
    return select_neighbors(None, cand_ids, cand_vecs, cand_dists, m_out,
                            alpha, space)
