"""Exact k-NN over a live set, and the judge of every served answer.

Plain PyTorch with TF32 off. A served answer is ``labels[n, k]`` and
``dists[n, k]`` for ``n`` answered queries; row ``r`` of ``X`` holds the
vector of label ``r`` (a run draws labels ``0 .. R-1`` in that order), and
each answered query names the query it answers (``qidx``) and the live or
allowed set it was served against (``gidx``, an index into ``groups``, one
boolean mask over the rows each).

The judge recomputes, for every answer, the distance from its query to the
vector of each label it names (float64, point form), and the exact top-k
over its group (float32 matrix products pick 32 candidates, float64 point
distances rank them). The control is the same exact search run in TF32 and
put in the program's place.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .data import normalize

#: candidates the float32 pass keeps for the float64 re-rank
CANDIDATES = 32
#: a served label within this share of the k-th exact distance is a hit
#: (float32 cannot order two distances closer than this)
TIE_RTOL = 1e-6
#: elements of one block of the candidate pass's score matrix
BLOCK_ELEMS = 1 << 28


def prepare(X: np.ndarray, space: str) -> np.ndarray:
    """The rows as the metric sees them, in float64 (cosine: unit rows)."""
    return normalize(X) if space == "cosine" else np.asarray(X, np.float64)


def point_dists(space: str, q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Distance from each ``q[..., d]`` to each of its rows ``x[..., c, d]``."""
    if space == "l2":
        diff = x - q.unsqueeze(-2)
        return (diff * diff).sum(-1)
    return 1.0 - (x * q.unsqueeze(-2)).sum(-1)


def _scores(space: str, q: torch.Tensor, x: torch.Tensor,
            xn: torch.Tensor) -> torch.Tensor:
    """Matrix-product form of the distance (for ``l2`` without ``|q|^2``,
    which orders nothing)."""
    dot = q @ x.T
    return xn[None, :] - 2.0 * dot if space == "l2" else -dot


@dataclasses.dataclass
class Pool:
    """The rows and queries of one run on the reference's device."""
    space: str
    X64: torch.Tensor
    Q64: torch.Tensor
    X32: torch.Tensor
    Q32: torch.Tensor
    xn32: torch.Tensor

    @classmethod
    def make(cls, space: str, X: np.ndarray, Q: np.ndarray,
             device) -> "Pool":
        X64 = torch.from_numpy(prepare(X, space)).to(device)
        Q64 = torch.from_numpy(prepare(Q, space)).to(device)
        X32, Q32 = X64.float(), Q64.float()
        return cls(space, X64, Q64, X32, Q32, (X32 * X32).sum(-1))


def _eligible_rows(mask: torch.Tensor) -> torch.Tensor | None:
    """The rows of a sparse mask (gathered), or None for a dense one (masked
    in place)."""
    n = int(mask.sum())
    return torch.nonzero(mask).squeeze(1) if n * 4 < mask.numel() else None


def exact_topk(pool: Pool, qs: torch.Tensor, mask: torch.Tensor, k: int,
               tf32: bool = False):
    """Exact top-``k`` over the rows ``mask`` allows for queries ``qs``.

    Returns ``(rows[b, k], dists[b, k])``, padded with ``(-1, inf)``. With
    ``tf32`` False the distances are float64 point distances of float32
    candidates; with ``tf32`` True (the control) the ranking and the
    distances are the matrix-product form's, computed in TF32.
    """
    rows_sel = _eligible_rows(mask)
    if rows_sel is None:
        X, xn = pool.X32, pool.xn32
        bad = ~mask
    else:
        X, xn = pool.X32[rows_sel], pool.xn32[rows_sel]
        bad = None
    R = X.shape[0]
    c = min(k if tf32 else CANDIDATES, R)
    b = max(1, BLOCK_ELEMS // max(R, 1))
    out_r = torch.full((qs.numel(), k), -1, dtype=torch.long,
                       device=pool.X64.device)
    out_d = torch.full((qs.numel(), k), float("inf"), dtype=torch.float64,
                       device=pool.X64.device)
    if R == 0 or c == 0:
        return out_r, out_d
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        for lo in range(0, qs.numel(), b):
            qi = qs[lo:lo + b]
            q = pool.Q32[qi]
            s = _scores(pool.space, q, X, xn)
            if tf32 and pool.space == "l2":
                s = s + (q * q).sum(-1, keepdim=True)
            elif tf32:
                s = s + 1.0
            if bad is not None:
                s = s.masked_fill(bad[None, :], float("inf"))
            val, pos = torch.topk(s, c, dim=1, largest=False, sorted=True)
            rows = pos if rows_sel is None else rows_sel[pos]
            rows = torch.where(torch.isinf(val), -1, rows)
            if tf32:
                d = val.double()
            else:
                d = point_dists(pool.space, pool.Q64[qi],
                                pool.X64[rows.clamp_min(0)])
                d = torch.where(rows < 0, float("inf"), d)
                d, o = torch.sort(d, dim=1, stable=True)
                rows = rows.gather(1, o)
            kk = min(k, c)
            out_r[lo:lo + b, :kk] = rows[:, :kk]
            out_d[lo:lo + b, :kk] = d[:, :kk]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return out_r, out_d


@dataclasses.dataclass
class Answers:
    """Served answers: row ``i`` answers query ``qidx[i]`` of the pool
    against group ``gidx[i]``."""
    qidx: np.ndarray
    gidx: np.ndarray
    labels: np.ndarray
    dists: np.ndarray

    @classmethod
    def concat(cls, parts: list["Answers"]) -> "Answers":
        return cls(*(np.concatenate([getattr(p, f.name) for p in parts])
                     for f in dataclasses.fields(cls)))


def _pairs(ans: Answers):
    """Distinct ``(group, query)`` pairs and each answer's pair index."""
    key = ans.gidx.astype(np.int64) * (int(ans.qidx.max()) + 1) + ans.qidx
    uniq, inv = np.unique(key, return_inverse=True)
    span = int(ans.qidx.max()) + 1
    return uniq // span, uniq % span, inv


def kth_exact(pool: Pool, groups: list[torch.Tensor], ans: Answers, k: int,
              tf32: bool = False):
    """Per distinct (group, query) pair: the exact top-k. Returns
    ``(pair_of_answer, rows[p, k], dists[p, k], eligible[p])``."""
    pg, pq, inv = _pairs(ans)
    dev = pool.X64.device
    P = len(pg)
    rows = torch.full((P, k), -1, dtype=torch.long, device=dev)
    dists = torch.full((P, k), float("inf"), dtype=torch.float64, device=dev)
    elig = torch.zeros(P, dtype=torch.long, device=dev)
    for g in np.unique(pg):
        sel = np.nonzero(pg == g)[0]
        qs = torch.from_numpy(pq[sel]).to(dev)
        r, d = exact_topk(pool, qs, groups[int(g)], k, tf32=tf32)
        idx = torch.from_numpy(sel).to(dev)
        rows[idx], dists[idx] = r, d
        elig[idx] = int(groups[int(g)].sum())
    return inv, rows, dists, elig


def judge(pool: Pool, groups: list[torch.Tensor], ans: Answers, k: int,
          gap_limit: float, block: int = 1 << 16) -> dict:
    """Hold every served answer to the reference.

    Readings: ``short_rows`` (fewer labels than ``min(k, eligible)``),
    ``dup_labels`` (a label twice in one answer), ``ineligible`` (a label
    outside the answer's live or allowed set, or no row at all),
    ``dist_gap`` (the widest gap between a served distance and the
    reference's distance to that label, as a share of the latter),
    ``recall_miss`` (1 - recall@k; a label within ``TIE_RTOL`` of the k-th
    exact distance is a hit) and ``failed_rows`` (answers with any fault,
    or a gap over ``gap_limit``).
    """
    dev = pool.X64.device
    n = len(ans.qidx)
    R = pool.X64.shape[0]
    inv, _, kd, elig = kth_exact(pool, groups, ans, k)
    G = torch.stack(groups) if groups else None
    totals = dict(rows=n, short_rows=0, dup_labels=0, ineligible=0,
                  failed_rows=0)
    gap_max, hits_sum = 0.0, 0.0
    for lo in range(0, n, block):
        sl = slice(lo, lo + block)
        lab = torch.from_numpy(ans.labels[sl].astype(np.int64)).to(dev)
        dst = torch.from_numpy(ans.dists[sl].astype(np.float64)).to(dev)
        q = torch.from_numpy(ans.qidx[sl]).to(dev)
        g = torch.from_numpy(ans.gidx[sl].astype(np.int64)).to(dev)
        p = torch.from_numpy(inv[sl]).to(dev)
        served = lab >= 0
        known = served & (lab < R)
        lc = torch.where(known, lab, 0)
        ok = known & G[g[:, None], lc]
        s = torch.sort(torch.where(served, lab, -1 - torch.arange(
            k, device=dev)[None, :]), dim=1).values
        dup = (s[:, 1:] == s[:, :-1]).sum(1)
        d_ref = point_dists(pool.space, pool.Q64[q], pool.X64[lc])
        gap = torch.where(known, (dst - d_ref).abs()
                          / d_ref.abs().clamp_min(1e-12), 0.0)
        gap = torch.where(known & ~torch.isfinite(dst), float("inf"), gap)
        kth = kd[p, k - 1]
        want = elig[p].clamp_max(k)
        hit = ok & (d_ref <= kth[:, None] + TIE_RTOL * kth.abs()[:, None]
                    + 1e-12)
        # a duplicated label is one hit at most
        hits = hit.sum(1) - torch.minimum(dup, hit.sum(1))
        short = served.sum(1) < want
        inel = (served & ~ok).sum(1)
        row_gap = gap.max(1).values
        totals["short_rows"] += int(short.sum())
        totals["dup_labels"] += int(dup.sum())
        totals["ineligible"] += int(inel.sum())
        totals["failed_rows"] += int((short | (dup > 0) | (inel > 0)
                                      | (row_gap > gap_limit)).sum())
        gap_max = max(gap_max, float(row_gap.max()) if len(row_gap) else 0.)
        hits_sum += float((hits.double() / want.clamp_min(1)).sum())
    totals["dist_gap"] = gap_max
    totals["recall_miss"] = 1.0 - hits_sum / max(n, 1)
    return totals


def control_answers(pool: Pool, groups: list[torch.Tensor], ans: Answers,
                    k: int) -> Answers:
    """The control: the exact search in TF32, answering the same queries
    against the same groups as ``ans``, in the program's place."""
    inv, rows, dists, _ = kth_exact(pool, groups, ans, k, tf32=True)
    inv_t = torch.from_numpy(inv).to(rows.device)
    return Answers(ans.qidx, ans.gidx,
                   rows[inv_t].cpu().numpy().astype(np.int32),
                   dists[inv_t].float().cpu().numpy())


def live_mask(birth: np.ndarray, death: np.ndarray, applied: int
              ) -> np.ndarray:
    """Labels live once the first ``applied`` ops of a stream are applied
    (op ``j`` born or killed a label when ``j < applied``)."""
    return (birth < applied) & ~(death < applied)
