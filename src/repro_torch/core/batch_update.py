"""Wave-scheduled batch update executor: conflict-free vectorized ingest.

The sequential op tape applies one insert/replace at a time. This module
batches the tape into a few *waves* and applies every op of a wave at once
against the pre-wave state (FreshDiskANN's batched-consolidation discipline
applied to the write path):

  1. **Tape compiler** (:func:`compile_tape`, host numpy) — dedupe duplicate
     labels (last-write-wins), split the tape into phases: all deletes
     first, then the insert/replace set sliced into conflict-free waves whose
     sizes grow with the graph (``O(log N)`` waves for a full build).
  2. **Delete phase** — one vectorized label match marks every deleted slot.
  3. **Wave executor** (:func:`_apply_wave`) — per wave: vectorized slot
     assignment (replaces reuse mark-deleted slots from a rotating cursor),
     batched levels, a batched strategy-driven repair around every replaced
     slot, candidate generation (an exact ``[W, N]`` scan for small waves,
     else a lockstep beam search), batched alpha-RNG selection, and a
     vectorized commit whose colliding reverse ``(target, candidate)`` pairs
     are resolved by a lexsort/segment-rank pass.
  4. :func:`build_batch` — the same executor pointed at an empty index.

The port runs each layer's beam search only on the lanes active at that
layer; the reference searches every lane and discards the inactive ones,
so the result is the same. Waves update the index in place.

Draws: each wave takes ``(start_d, start_f, fresh_levels)`` — the reuse
cursors for deleted and free slots and the levels of fresh inserts — and
the empty-graph bootstrap insert takes ``(slot, level)``. They come from a
``torch.Generator`` unless ``draws=`` supplies them (the reference's, in
parity tests).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import spans
from .common import (INF, INVALID, dedup_ids, nonzero_padded, pow2_at_least,
                     resolve_device, stable_argsort, storage_tensor)
from .hnsw import _pad_row, insert
from .index import HNSWIndex, HNSWParams, empty_index, sample_level, \
    sample_levels
from .metrics import dist_pairwise, dist_point
from .prune import select_neighbors
from .search import _descend, search_layer
from .strategies import get_strategy, register_executor
from .update import (OP_DELETE, OP_INSERT, OP_NOP, OP_REPLACE,
                     first_free_slot, reuse_cursor)

#: default smallest wave — below this the lanes don't amortise dispatch
MIN_WAVE = 8
#: default largest wave — caps per-wave memory
MAX_WAVE = 1024
#: candidate tier crossover: ``W * N`` at/below this uses the exact scan tier
SCAN_TIER_MAX_ELEMS = 1 << 25
#: sort-key penalty that ranks mark-deleted candidates after every live one
#: while keeping them finite (the all-deleted link-through fallback)
_DELETED_PENALTY = 1e30


# ---------------------------------------------------------------------------
# tape compiler (host side)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WavePlan:
    """A compiled tape: one delete phase + conflict-free insert/replace waves.

    ``waves`` holds ``(ops, labels, X)`` numpy triples (unpadded);
    ``deduped`` counts ops dropped by last-write-wins label collapsing.
    """
    del_labels: np.ndarray
    waves: tuple[tuple[np.ndarray, np.ndarray, np.ndarray], ...]
    deduped: int = 0

    @property
    def num_waves(self) -> int:
        return len(self.waves)

    @property
    def num_deletes(self) -> int:
        return int(self.del_labels.shape[0])

    @property
    def num_writes(self) -> int:
        return sum(int(o.shape[0]) for o, _, _ in self.waves)


def _dedup_last_write_wins(ops: np.ndarray, labels: np.ndarray):
    """Collapse duplicate labels: per label keep the LAST op; any label with
    an earlier op (or an explicit delete) also emits a delete so the final
    write never coexists with a stale live slot. Returns
    ``(del_labels, write_indices, n_dropped)`` with write order preserved."""
    keep = ops != OP_NOP
    n_live = int(keep.sum())
    live_labels = labels[keep]
    if (len(np.unique(live_labels)) == n_live
            and not np.any(ops[keep] == OP_DELETE)):
        return (np.empty((0,), np.int32), np.nonzero(keep)[0], 0)

    last: dict[int, int] = {}
    n_ops: dict[int, int] = {}
    saw_delete: set[int] = set()
    for i in np.nonzero(keep)[0]:
        lbl = int(labels[i])
        last[lbl] = int(i)
        n_ops[lbl] = n_ops.get(lbl, 0) + 1
        if ops[i] == OP_DELETE:
            saw_delete.add(lbl)
    del_labels, write_idx = [], []
    for lbl, i in last.items():          # dict order == first occurrence
        if ops[i] == OP_DELETE:
            del_labels.append(lbl)
        else:
            if lbl in saw_delete or n_ops[lbl] > 1:
                del_labels.append(lbl)
            write_idx.append(i)
    write_idx.sort()                     # tape order among surviving writes
    return (np.asarray(del_labels, np.int32),
            np.asarray(write_idx, np.int64), n_live - len(last))


def compile_tape(ops, labels, X, *, built: int, min_wave: int = MIN_WAVE,
                 max_wave: int = MAX_WAVE) -> WavePlan:
    """Group a drained tape into a delete phase + conflict-free waves.

    ``built`` is the current allocated-slot count — wave ``k``'s width is
    ``min(remaining, max(min_wave, graph_size_so_far), max_wave)``.
    """
    with spans.span("wave.compile"):
        return _compile_tape(ops, labels, X, built, min_wave, max_wave)


def _compile_tape(ops, labels, X, built: int, min_wave: int,
                  max_wave: int) -> WavePlan:
    ops = np.asarray(ops, np.int32).reshape(-1)
    labels = np.asarray(labels, np.int32).reshape(-1)
    X = np.asarray(X, np.float32)
    del_labels, write_idx, dropped = _dedup_last_write_wins(ops, labels)

    waves = []
    lo, g = 0, max(int(built), 0)
    while lo < len(write_idx):
        w = 1 if g == 0 else min(len(write_idx) - lo,
                                 max(min_wave, g), max_wave)
        sel = write_idx[lo:lo + w]
        waves.append((ops[sel], labels[sel], X[sel]))
        g += w
        lo += w
    return WavePlan(del_labels, tuple(waves), dropped)


# ---------------------------------------------------------------------------
# delete phase
# ---------------------------------------------------------------------------

def _apply_deletes(index: HNSWIndex, del_labels: torch.Tensor) -> HNSWIndex:
    """Vectorized markDelete of every allocated slot whose label is listed."""
    hit = torch.isin(index.labels, del_labels) & (index.levels >= 0)
    index.deleted |= hit
    return index


# ---------------------------------------------------------------------------
# wave executor building blocks
# ---------------------------------------------------------------------------

def _ranked_slots(mask: torch.Tensor, start: int):
    """Slots where ``mask`` in rotated order starting at ``start``; returns
    ``(order[N], count)`` — ``order[:count]`` are the eligible slots."""
    N = mask.shape[0]
    rank = (torch.arange(N, device=mask.device) - start) % N
    order = stable_argsort(torch.where(mask, rank, N))
    return order, torch.sum(mask)


def _group_pairs_by_target(e_ids: torch.Tensor, cands: torch.Tensor,
                           dists: torch.Tensor, N: int, K: int):
    """Resolve colliding ``(target, candidate)`` pairs into per-target lists.

    Lexsort the flat pair list by (target, distance), rank each pair inside
    its target segment with a cummax scan, and scatter the ``K`` nearest
    candidates per target into dense ``[N, K]`` id/dist buffers (-1 / inf
    padded). Invalid pairs carry target ``N`` and drop.
    """
    P = e_ids.shape[0]
    dev = e_ids.device
    o1 = stable_argsort(dists)
    order = o1[stable_argsort(e_ids[o1])]
    e_s, c_s, d_s = e_ids[order], cands[order], dists[order]
    idx = torch.arange(P, device=dev)
    is_start = torch.ones(P, dtype=torch.bool, device=dev)
    is_start[1:] = e_s[1:] != e_s[:-1]
    rank = idx - torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    ok = (e_s >= 0) & (e_s < N) & (rank < K)
    tgt = torch.where(ok, e_s, N)
    col = rank.clamp(0, K - 1)
    out_ids = torch.full((N + 1, K), INVALID, dtype=torch.int64, device=dev)
    out_ids[tgt, col] = torch.where(ok, c_s, INVALID)
    out_d = torch.full((N + 1, K), INF, device=dev)
    out_d[tgt, col] = torch.where(ok, d_s, INF)
    return out_ids[:N], out_d[:N]


def _scatter_mask(targets: torch.Tensor, valid: torch.Tensor,
                  N: int) -> torch.Tensor:
    out = torch.zeros(N + 1, dtype=torch.bool, device=targets.device)
    out[torch.where(valid, targets, N).reshape(-1)] = True
    return out[:N]


def _fit_cols(x: torch.Tensor, m: int, fill) -> torch.Tensor:
    """Pad (with ``fill``) or cut the last axis of ``x`` to ``m`` columns."""
    if x.shape[-1] >= m:
        return x[..., :m]
    pad = torch.full(x.shape[:-1] + (m - x.shape[-1],), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad], dim=-1)


def _batched_rng_prune(cand_ids: torch.Tensor, cand_vecs: torch.Tensor,
                       cand_d: torch.Tensor, m_out: int, alpha: float,
                       space: str):
    """Single-pass batched α-RNG over ``[A, C]`` candidate lists.

    The matrix form of RobustPrune: sort each lane by distance, build the
    ``[C, C]`` candidate-pairwise matrix in one batched contraction, and
    prune any candidate α-dominated by a closer KEPT candidate, refined from
    the optimistic start in two fixed-point rounds. Lanes short of ``m_out``
    survivors backfill with the nearest pruned candidates. Returns
    ``(ids[A, m_out], dists[A, m_out])`` padded with (-1, inf).
    """
    A, C = cand_ids.shape
    d = cand_vecs.shape[-1]
    order = stable_argsort(cand_d)
    ids = cand_ids.gather(1, order)
    dq = cand_d.gather(1, order)
    vecs = cand_vecs.gather(1, order[..., None].expand(A, C, d))
    pair = dist_pairwise(space, vecs, vecs)                    # [A, C, C]
    closer = torch.triu(torch.ones((C, C), dtype=torch.bool,
                                   device=ids.device), diagonal=1)
    valid = dq < INF
    dom = closer[None] & valid[:, :, None] & (alpha * pair <= dq[:, None, :])
    keep = valid
    for _ in range(2):
        keep = valid & ~torch.any(dom & keep[:, :, None], dim=1)
    rank = torch.where(keep, 0, C) + torch.arange(C, device=ids.device)
    order2 = stable_argsort(rank)
    ids2 = ids.gather(1, order2)[:, :m_out]
    d2 = dq.gather(1, order2)[:, :m_out]
    ok2 = valid.gather(1, order2)[:, :m_out]
    return (_fit_cols(torch.where(ok2, ids2, INVALID), m_out, INVALID),
            _fit_cols(torch.where(ok2, d2, INF), m_out, INF))


def _repair_wave_layer(params: HNSWParams, layer_nbrs: torch.Tensor,
                       vectors: torch.Tensor, alive: torch.Tensor,
                       R: torch.Tensor, r_list: torch.Tensor, strategy,
                       layer: int) -> torch.Tensor:
    """Strategy-driven repair of the neighbourhoods around every replaced
    slot, one vectorized pass per layer (the batched analogue of
    ``core.update._repair_layer``); updates ``layer_nbrs`` in place.

    ``R`` marks the slots whose point was just replaced; ``r_list[Wr]`` is
    the compacted slot-id list (capacity-padded). Every repaired vertex
    re-selects from its own row, the old row of its first replaced
    out-neighbour and the replaced slots pointing at it, under the
    strategy's α-RNG.
    """
    N, M0 = layer_nbrs.shape
    Wr = r_list.shape[0]
    m_l = params.m_for_layer(layer)

    valid = layer_nbrs >= 0
    points_at_R = torch.any(valid & R[layer_nbrs.clamp_min(0)], dim=1)
    rows_R = layer_nbrs[r_list.clamp(0, N - 1)].long()          # [Wr, M0]
    rows_R_ok = (rows_R >= 0) & (r_list < N)[:, None]
    out_of_R = _scatter_mask(rows_R.clamp_min(0), rows_R_ok, N)

    if strategy.repair_set == "one_hop":
        repair = out_of_R
        a_cap = Wr * M0
    elif strategy.repair_set == "mutual":
        repair = out_of_R & points_at_R
        a_cap = Wr * M0
    else:  # mutual_thn: + two-hop vertices that point back at a replaced slot
        oh_list = nonzero_padded(out_of_R, min(N, Wr * M0), N)
        rows_oh = layer_nbrs[oh_list.clamp(0, N - 1)].long()
        rows_oh_ok = (rows_oh >= 0) & (oh_list < N)[:, None]
        two_hop = _scatter_mask(rows_oh.clamp_min(0), rows_oh_ok, N)
        repair = (out_of_R | two_hop) & points_at_R
        a_cap = min(N, Wr * M0 * (M0 + 1))
    repair &= alive & ~R
    a_cap = min(N, a_cap)

    # replaced slots that point at v — so non-mutual one-hop vertices still
    # see the new point as a candidate
    in_ids, _ = _group_pairs_by_target(
        torch.where(rows_R_ok, rows_R, N).reshape(-1),
        r_list[:, None].expand(Wr, M0).reshape(-1),
        torch.zeros(Wr * M0, device=vectors.device), N, max(M0 // 4, 4))

    aff = torch.nonzero(repair).reshape(-1)[:a_cap]          # repaired lanes
    if aff.numel() == 0:
        return layer_nbrs
    A = aff.shape[0]
    own = layer_nbrs[aff].long()                               # [A, M0]
    ownc = own.clamp_min(0)
    is_r = (own >= 0) & R[ownc]
    j = is_r.to(torch.uint8).argmax(dim=1)
    first_r = ownc[torch.arange(A, device=aff.device), j]
    drow = torch.where(torch.any(is_r, dim=1, keepdim=True),
                       layer_nbrs[first_r].long(), INVALID)
    pool = torch.cat([own, drow, in_ids[aff]], dim=1)          # [A, 2M0+K]
    pc = pool.clamp_min(0)
    ok = (pool >= 0) & alive[pc] & (pool != aff[:, None])
    dq = torch.where(ok, dist_point(params.space, vectors[aff], vectors[pc]),
                     INF)
    pool_ids, pool_d = dedup_ids(torch.where(ok, pool, INVALID), dq)
    sel, _ = _batched_rng_prune(pool_ids, vectors[pool_ids.clamp_min(0)],
                                pool_d, m_l, strategy.repair_alpha,
                                params.space)
    layer_nbrs[aff] = _fit_cols(sel, M0, INVALID).to(layer_nbrs.dtype)
    return layer_nbrs


def _merge_reverse_layer(params: HNSWParams, layer_nbrs: torch.Tensor,
                         vectors: torch.Tensor, new_ids: torch.Tensor,
                         new_d: torch.Tensor, a_cap: int,
                         layer: int) -> torch.Tensor:
    """Fold the per-target reverse-candidate lists into the adjacency, in
    place. Rows with head-room append every (deduped) candidate —
    hnswlib's unconditional append — and full rows re-select from
    row ∪ candidates under α-RNG (the shrink rule of ``add_reverse_edges``).
    Only affected rows (at most ``a_cap``) pay."""
    N, M0 = layer_nbrs.shape
    m_l = params.m_for_layer(layer)

    affected = torch.any(new_ids >= 0, dim=1)
    aff = torch.nonzero(affected).reshape(-1)[:min(N, a_cap)]
    if aff.numel() == 0:
        return layer_nbrs
    A = aff.shape[0]
    rows = layer_nbrs[aff].long()                              # [A, M0]
    cands, cand_d = new_ids[aff], new_d[aff]                   # [A, K]
    dup = torch.any(cands[:, :, None] == rows[:, None, :], dim=2)
    ok_c = (cands >= 0) & ~dup
    cands = torch.where(ok_c, cands, INVALID)
    cand_d = torch.where(ok_c, cand_d, INF)
    n_new = torch.sum(ok_c, dim=1)
    degree = torch.sum(rows >= 0, dim=1)

    # head-room rows append every candidate (hnswlib's unconditional append)
    pos = degree[:, None] + torch.cumsum(ok_c.long(), dim=1) - 1
    appended = torch.cat([rows, torch.full((A, 1), INVALID,
                                           dtype=torch.int64,
                                           device=rows.device)], dim=1)
    appended.scatter_(1, torch.where(ok_c, pos, M0).clamp_max(M0), cands)
    appended = appended[:, :M0]

    # full rows re-select from row ∪ candidates under the batched α-RNG
    row_d = torch.where(rows >= 0, dist_point(params.space, vectors[aff],
                                              vectors[rows.clamp_min(0)]),
                        INF)
    all_ids = torch.cat([rows, cands], dim=1)                  # [A, M0+K]
    all_d = torch.cat([row_d, cand_d], dim=1)
    sel, _ = _batched_rng_prune(all_ids, vectors[all_ids.clamp_min(0)],
                                all_d, m_l, params.alpha, params.space)
    shrunk = _fit_cols(sel, M0, INVALID)

    merged = torch.where((degree + n_new <= m_l)[:, None], appended, shrunk)
    merged = torch.where((n_new > 0)[:, None], merged, rows)
    layer_nbrs[aff] = merged.to(layer_nbrs.dtype)
    return layer_nbrs


# ---------------------------------------------------------------------------
# candidate tiers: exact scan vs lockstep beam search
# ---------------------------------------------------------------------------

def _upper_cap(W: int, M: int, layer: int) -> int:
    """Static lane bound for layers > 0: levels are Geometric(1/M), so the
    expected active-lane count at ``layer`` is ``W / M**layer`` — bound it
    at mean + 4σ (pow2-rounded); an overflowing lane skips its wiring at
    that layer (it stays fully wired below)."""
    mean = W / (M ** layer)
    return int(min(W, pow2_at_least(int(np.ceil(mean + 4 * np.sqrt(mean)
                                                + 4)))))


def _scan_candidates(params: HNSWParams, vectors: torch.Tensor,
                     levels: torch.Tensor, deleted: torch.Tensor,
                     xq: torch.Tensor, pid: torch.Tensor, lvl: torch.Tensor,
                     active: torch.Tensor, max_layer: torch.Tensor) -> list:
    """Exact-scan candidate tier: ONE ``[W, N]`` distance contraction serves
    every layer. Per layer: slots at that layer rank by true distance with
    mark-deleted candidates behind every live one, the top ``ef`` (ties to
    the lowest slot) feed the batched α-RNG. Wave-mates are candidates too.
    Layers > 0 run on lanes compacted to :func:`_upper_cap`."""
    N = vectors.shape[0]
    W = xq.shape[0]
    D = dist_pairwise(params.space, xq, vectors)                  # [W, N]
    D[torch.arange(W, device=D.device), pid.clamp_min(0)] = INF   # never self
    del_pen = torch.where(deleted, _DELETED_PENALTY, 0.0)[None, :]
    ef = min(max(params.ef_construction, params.M0), N)

    sel_layers = []
    for layer in range(params.num_layers - 1, -1, -1):
        m_l = params.m_for_layer(layer)
        act_l = active & (lvl >= layer) & (layer <= max_layer)
        elig = (levels >= layer)[None, :]
        if layer > 0:
            lane = nonzero_padded(act_l, _upper_cap(W, params.M, layer), W)
            Dl = D[lane.clamp(0, W - 1)]
        else:
            lane, Dl = None, D
        key = torch.sort(torch.where(elig, Dl + del_pen, INF), dim=1,
                         stable=True)
        ids = key.indices[:, :ef]
        ok = key.values[:, :ef] < INF
        dq = Dl.gather(1, ids)
        alive_c = ok & ~deleted[ids]
        ok = torch.where(torch.any(alive_c, dim=1, keepdim=True), alive_c, ok)
        dq = torch.where(ok, dq, INF)
        idsm = torch.where(ok, ids, INVALID)
        sel_c, seld_c = _batched_rng_prune(idsm, vectors[ids], dq, m_l,
                                           params.alpha, params.space)
        if lane is None:
            sel, seld = sel_c, seld_c
        else:
            safe = torch.where(lane < W, lane, W)
            sel = torch.full((W + 1, m_l), INVALID, dtype=torch.int64,
                             device=D.device)
            seld = torch.full((W + 1, m_l), INF, device=D.device)
            sel[safe] = sel_c
            seld[safe] = seld_c
            sel, seld = sel[:W], seld[:W]
        sel_layers.append((layer, m_l, sel, seld, act_l))
    return sel_layers


def _beam_candidates(params: HNSWParams, view: HNSWIndex, xq: torch.Tensor,
                     pid: torch.Tensor, lvl: torch.Tensor,
                     active: torch.Tensor) -> list:
    """Beam-search candidate tier: batched greedy ``_descend`` plus a
    lockstep ``search_layer`` per layer against the pre-wave graph, on the
    lanes active at that layer. Memory stays O(W·(N + ef))."""
    W = xq.shape[0]
    dev = xq.device
    eps = _descend(params, view, xq, lvl.clamp_min(0))
    sel_layers = []
    for layer in range(params.num_layers - 1, -1, -1):
        m_l = params.m_for_layer(layer)
        act_l = active & (lvl >= layer) & (layer <= view.max_layer)
        sel = torch.full((W, m_l), INVALID, dtype=torch.int64, device=dev)
        seld = torch.full((W, m_l), INF, device=dev)
        lanes = torch.nonzero(act_l).reshape(-1)
        if lanes.numel():
            x, ep, p = xq[lanes], eps[lanes], pid[lanes]
            ids, dists = search_layer(params, view, x, ep, layer,
                                      params.ef_construction)
            ok = (ids >= 0) & (ids != p[:, None])
            # prefer live candidates; all-deleted links through (hnswlib)
            alive_c = ok & ~view.deleted[ids.clamp_min(0)]
            ok = torch.where(torch.any(alive_c, dim=1, keepdim=True),
                             alive_c, ok)
            dists = torch.where(ok, dists, INF)
            ids = torch.where(ok, ids, INVALID)
            s, sd = select_neighbors(x, ids, view.vectors[ids.clamp_min(0)],
                                     dists, m_l, params.alpha, params.space)
            sel[lanes] = _fit_cols(s, m_l, INVALID)
            seld[lanes] = _fit_cols(sd, m_l, INF)
            j = torch.argmin(dists, dim=1)
            idj = ids[torch.arange(lanes.numel(), device=dev), j]
            eps[lanes] = torch.where(idj >= 0, idj.clamp_min(0), ep)
        sel_layers.append((layer, m_l, sel, seld, act_l))
    return sel_layers


# ---------------------------------------------------------------------------
# the wave executor
# ---------------------------------------------------------------------------

def _apply_wave(params: HNSWParams, index: HNSWIndex, ops: torch.Tensor,
                labels: torch.Tensor, X: torch.Tensor, variant: str,
                rotate_slots: bool, do_repair: bool, candidates: str,
                draw) -> HNSWIndex:
    """Apply one conflict-free wave of insert/replace ops to ``index`` in
    place. ``draw = (start_d, start_f, fresh_levels[W])``."""
    strategy = get_strategy(variant)
    N, M0, L = index.capacity, params.M0, params.num_layers
    W = ops.shape[0]
    dev = index.device
    start_d, start_f, fresh_lvl = draw
    if not rotate_slots:
        start_d = start_f = 0

    # --- vectorized slot assignment (distinct slots per wave member) -------
    with spans.span("wave.slots"):
        is_replace = ops == OP_REPLACE
        is_write = is_replace | (ops == OP_INSERT)
        live_del = index.deleted & (index.levels >= 0)
        free = index.levels < 0
        del_order, n_del = _ranked_slots(live_del, start_d)
        free_order, n_free = _ranked_slots(free, start_f)

        r_idx = torch.cumsum(is_replace.long(), 0) - 1
        reuse_rep = is_replace & (r_idx < n_del)
        needs_free = is_write & ~reuse_rep
        f_idx = torch.cumsum(needs_free.long(), 0) - 1
        got_free = needs_free & (f_idx < n_free)
        # capacity-pressure fallback: a write with no free slot left reuses
        # a deleted slot the replaces didn't claim
        n_rep_used = torch.minimum(is_replace.long().sum(), n_del)
        need_fb = needs_free & ~got_free
        fb_idx = torch.cumsum(need_fb.long(), 0) - 1
        got_fb = need_fb & (n_rep_used + fb_idx < n_del)
        reuse = reuse_rep | got_fb        # both inherit the slot's level
        fb_slot = del_order[(n_rep_used + fb_idx).clamp(0, N - 1)]
        pid = torch.where(
            reuse_rep, del_order[r_idx.clamp(0, N - 1)],
            torch.where(got_free, free_order[f_idx.clamp(0, N - 1)],
                        torch.where(got_fb, fb_slot, INVALID)))
        active = is_write & (pid >= 0)    # an exhausted index drops the op

        # --- levels: replaces inherit (paper Algorithm 3) -------------------
        fresh_lvl = torch.tensor(np.asarray(fresh_lvl), dtype=torch.int32,
                                 device=dev)
        lvl = torch.where(reuse, index.levels[pid.clamp_min(0)], fresh_lvl)
        lvl = torch.where(active, lvl, -1)

        xq = X.to(index.vectors.dtype)
        a_pid = pid[active]
        index.vectors[a_pid] = xq[active]
        index.labels[a_pid] = labels[active].to(torch.int32)
        index.levels[a_pid] = lvl[active].to(torch.int32)
        index.deleted[a_pid] = False

    # --- batched strategy repair around the replaced slots -----------------
    nbrs = index.neighbors
    if do_repair:
        with spans.span("wave.repair"):
            R = _scatter_mask(pid, reuse, N)
            r_list = nonzero_padded(R, min(N, W), N)
            alive = (index.levels >= 0) & ~index.deleted
            for layer in range(L):
                _repair_wave_layer(params, nbrs[layer], index.vectors, alive,
                                   R, r_list, strategy, layer)

    # --- candidate generation + α-RNG neighbour selection ------------------
    with spans.span("wave.candidates"):
        if candidates == "scan":
            sel_layers = _scan_candidates(params, index.vectors,
                                          index.levels, index.deleted, xq,
                                          pid, lvl, active, index.max_layer)
        else:
            sel_layers = _beam_candidates(params, index, xq, pid, lvl,
                                          active)

    # --- vectorized commit: forward scatter + segment-resolved reverse -----
    with spans.span("wave.commit"):
        for layer, m_l, sel, seld, act_l in sel_layers:
            layer_nbrs = nbrs[layer]
            layer_nbrs[pid[act_l]] = _pad_row(sel[act_l], M0).to(
                layer_nbrs.dtype)
            pair_ok = act_l[:, None] & (sel >= 0)
            # a target takes at most m_l/2 new reverse edges per wave
            # (nearest first); only lanes that can be active at this layer
            # contribute
            lanes = W if layer == 0 else _upper_cap(W, params.M, layer)
            new_ids, new_d = _group_pairs_by_target(
                torch.where(pair_ok, sel, N).reshape(-1),
                pid[:, None].expand(sel.shape).reshape(-1),
                torch.where(pair_ok, seld, INF).reshape(-1), N,
                max(m_l // 2, 4))
            _merge_reverse_layer(params, layer_nbrs, index.vectors,
                                 new_ids, new_d, lanes * m_l, layer)

        # --- entry / max_layer / count invariants --------------------------
        masked = torch.where(active, lvl, -1)
        wave_max = masked.max()
        top = pid[masked.argmax()]
        grow = wave_max > index.max_layer
        index.entry.copy_(torch.where(grow, top, index.entry))
        index.max_layer.copy_(torch.maximum(index.max_layer, wave_max))
        index.count += torch.sum(active & ~reuse).to(torch.int32)
    return index


# ---------------------------------------------------------------------------
# host drivers
# ---------------------------------------------------------------------------

def _pad_pow2(a: np.ndarray, fill, min_len: int = 1) -> np.ndarray:
    b = max(pow2_at_least(len(a)), min_len)
    if b == len(a):
        return a
    pad_shape = (b - len(a),) + a.shape[1:]
    return np.concatenate([a, np.full(pad_shape, fill, a.dtype)])


def apply_plan(params: HNSWParams, index: HNSWIndex, plan: WavePlan,
               variant: str = "mn_ru_gamma", rotate_slots: bool = True, *,
               generator: torch.Generator | None = None, draws=None,
               scan_max_elems: int = SCAN_TIER_MAX_ELEMS) -> HNSWIndex:
    """Execute a compiled :class:`WavePlan` on ``index`` in place: the delete
    phase, then every wave (each padded to its pow2 bucket).

    ``draws`` (optional) lists the bootstrap ``(slot, level)`` — when the
    index is empty — and then one ``(start_d, start_f, fresh_levels)`` per
    wave; otherwise they come from ``generator``. ``scan_max_elems`` is the
    ``W * N`` crossover between the scan and beam candidate tiers.
    """
    get_strategy(variant)
    dev = index.device
    draws = iter(draws) if draws is not None else None
    if plan.num_deletes:
        with spans.span("wave.deletes"):
            _apply_deletes(index, torch.as_tensor(plan.del_labels).to(dev))
    waves = list(plan.waves)
    allocated = int(index.count)    # ONE host sync; waves book-keep below
    if waves and allocated == 0:
        # empty-graph bootstrap: the first point inserts sequentially (it
        # has nothing to search against), the rest ride the waves
        ops0, labels0, X0 = waves[0]
        if draws is not None:
            p0, lvl0 = next(draws)
        else:
            p0 = (first_free_slot(index, generator=generator)
                  if rotate_slots else 0)
            lvl0 = sample_level(generator, params)
        insert(params, index, torch.as_tensor(X0[0]).to(dev), max(p0, 0),
               int(labels0[0]), level_override=lvl0)
        waves[0] = (ops0[1:], labels0[1:], X0[1:])
        allocated = 1
    N = index.capacity
    for ops_w, labels_w, X_w in waves:
        if not len(ops_w):
            continue
        ops_p = _pad_pow2(ops_w, OP_NOP)
        W = len(ops_p)
        tier = "scan" if W * N <= scan_max_elems else "beam"
        # the repair sweep must also run when inserts can spill into
        # mark-deleted slots (capacity pressure); ``allocated`` is a
        # host-side upper bound, so the check can only over-trigger
        may_reuse = bool(np.any(ops_w == OP_REPLACE)) \
            or len(ops_w) > N - allocated
        if draws is not None:
            draw = next(draws)
        else:
            draw = (reuse_cursor(index, generator),
                    reuse_cursor(index, generator),
                    sample_levels(generator, params, W))
        with spans.span("wave", W=W, tier=tier):
            _apply_wave(params, index, torch.as_tensor(ops_p).to(dev),
                        torch.as_tensor(_pad_pow2(labels_w, -1)).to(dev),
                        torch.as_tensor(_pad_pow2(X_w, 0.0)).to(dev),
                        variant, rotate_slots, may_reuse, tier, draw)
        allocated = min(N, allocated + len(ops_w))
    return index


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def apply_update_batch_wave(params: HNSWParams, index: HNSWIndex, ops,
                            labels, X, variant: str = "mn_ru_gamma",
                            min_wave: int = MIN_WAVE,
                            max_wave: int = MAX_WAVE, *,
                            generator: torch.Generator | None = None,
                            draws=None,
                            scan_max_elems: int = SCAN_TIER_MAX_ELEMS
                            ) -> HNSWIndex:
    """Wave-executed drop-in for ``apply_update_batch``: compile the tape
    on the host, run the phases."""
    plan = compile_tape(_host(ops), _host(labels), _host(X),
                        built=int(index.count), min_wave=min_wave,
                        max_wave=max_wave)
    return apply_plan(params, index, plan, variant, generator=generator,
                      draws=draws, scan_max_elems=scan_max_elems)


def build_batch(params: HNSWParams, vectors, labels=None, seed: int = 0,
                capacity: int | None = None, min_wave: int = MIN_WAVE,
                max_wave: int = MAX_WAVE, *,
                generator: torch.Generator | None = None, draws=None,
                scan_max_elems: int = SCAN_TIER_MAX_ELEMS,
                device="cuda") -> HNSWIndex:
    """Construct a whole index in ``O(log N)`` geometrically-growing waves.

    Slots are assigned in ascending order (no reuse-cursor rotation), so
    point ``i`` lands in slot ``i``. Levels come from ``generator``
    (default: a CPU generator seeded with ``seed``) or from ``draws``. The
    index stores the vectors in their own dtype, as ``build`` does.
    """
    dev = resolve_device(device)
    X = storage_tensor(vectors)
    n, d = X.shape
    labels = np.arange(n, dtype=np.int32) if labels is None else _host(labels)
    index = empty_index(params, capacity or n, d, seed, dtype=X.dtype,
                        device=dev)
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    # the tape carries f32 (as the reference's); a wave casts its lanes back
    # to the storage dtype, exactly, since they were widened from it
    plan = compile_tape(np.full((n,), OP_INSERT, np.int32),
                        np.asarray(labels, np.int32), X.float().numpy(),
                        built=0, min_wave=min_wave, max_wave=max_wave)
    return apply_plan(params, index, plan, rotate_slots=False,
                      generator=generator, draws=draws,
                      scan_max_elems=scan_max_elems)


register_executor("wave", apply_update_batch_wave)
