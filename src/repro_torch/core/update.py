"""Real-time update algorithms: markDelete + replaced_update family.

  * ``hnsw_ru``     — baseline hnswlib ``replaced_update``: repair EVERY one-hop
                      neighbour of the deleted point from the shared one-hop ∪
                      two-hop candidate pool.
  * ``mn_ru_alpha`` — repair only MUTUAL neighbours, same shared two-hop pool.
  * ``mn_ru_beta``  — mutual neighbours, per-vertex pool N(v) ∪ N(d) ∪ {new},
                      alpha = 1.0 (paper Algorithm 2).
  * ``mn_ru_gamma`` — beta with alpha-RNG alpha = 1.1.
  * ``mn_thn_ru``   — gamma + also repair two-hop vertices that point at d.

All variants finish with the layer-inheriting re-insert (paper Algorithm 3).
The vertices of one repair are pruned together as lanes of one batch.

Updates work in place on the index's tensors (see ``core.hnsw``). Slot
reuse starts at a rotating cursor drawn from an explicit
``torch.Generator``; ``slot=``/``slots=`` and ``level=``/``levels=``
overrides take the reference's draws instead.
"""
from __future__ import annotations

from typing import Sequence

import torch

from .common import INF, INVALID, dedup_ids, stable_argsort
from .hnsw import _pad_row, connect_at_layer, insert
from .index import HNSWIndex, HNSWParams
from .metrics import dist_point
from .prune import alpha_rng_select, select_neighbors
from .search import greedy_layer
from .strategies import get_executor, get_strategy, register_executor

OP_NOP = 0      # padding — leaves the index untouched
OP_DELETE = 1   # mark_delete(label)
OP_REPLACE = 2  # replaced_update(x, label) — reuses a deleted slot, else fresh
OP_INSERT = 3   # fresh insert of (x, label) into the first free slot


def slot_of_label(index: HNSWIndex, label: int) -> int:
    """Return the slot holding ``label`` (-1 if absent). O(N) masked scan."""
    hits = (index.labels == int(label)) & (index.levels >= 0)
    slot = int(hits.to(torch.uint8).argmax())
    return slot if bool(hits[slot]) else INVALID


def mark_delete(index: HNSWIndex, label: int) -> HNSWIndex:
    """Paper 'Deletion': flag the point; it stays traversable until replaced."""
    slot = slot_of_label(index, label)
    if slot >= 0:
        index.deleted[slot] = True
    return index


def reuse_cursor(index: HNSWIndex,
                 generator: torch.Generator | None) -> int:
    """A random start for slot reuse, so that reused slots (and repairs)
    spread over the graph instead of hammering the lowest ids."""
    return int(torch.randint(0, index.capacity, (1,), generator=generator))


def _first_slot_from(mask: torch.Tensor, start: int) -> int:
    """First True slot at/after ``start`` in rotated order (wrapping)."""
    capacity = mask.shape[0]
    rank = (torch.arange(capacity, device=mask.device) - start) % capacity
    m = int(torch.where(mask, rank, capacity).min())
    return INVALID if m == capacity else (start + m) % capacity


def first_deleted_slot(index: HNSWIndex, start: int | None = None,
                       generator: torch.Generator | None = None) -> int:
    """Next mark-deleted slot to reuse (-1 if none), from cursor ``start``
    (drawn from ``generator`` when not given)."""
    if start is None:
        start = reuse_cursor(index, generator)
    return _first_slot_from(index.deleted & (index.levels >= 0), start)


def first_free_slot(index: HNSWIndex, start: int | None = None,
                    generator: torch.Generator | None = None) -> int:
    """Next free slot for a fresh insert (-1 if full), from cursor ``start``."""
    if start is None:
        start = reuse_cursor(index, generator)
    return _first_slot_from(index.levels < 0, start)


def num_deleted(index: HNSWIndex) -> int:
    return int(torch.sum(index.deleted & (index.levels >= 0)))


# ---------------------------------------------------------------------------
# repair phase
# ---------------------------------------------------------------------------

def _repair_layer(params: HNSWParams, nbrs: torch.Tensor,
                  vectors: torch.Tensor, deleted: torch.Tensor, pid: int,
                  layer: int, variant: str) -> torch.Tensor:
    """Repair the neighbourhood around replaced slot ``pid`` at one layer.

    ``nbrs``: full [L, N, M0] adjacency, updated in place (and returned).
    ``vectors[pid]`` already holds the NEW point's vector.
    """
    strategy = get_strategy(variant)
    if strategy.repair_fn is not None:
        return strategy.repair_fn(params, nbrs, vectors, deleted, pid, layer,
                                  strategy)
    M0 = params.M0
    m_l = params.m_for_layer(layer)
    dev = vectors.device
    layer_nbrs = nbrs[layer]
    pid_t = torch.tensor([pid], dtype=torch.int64, device=dev)

    N1 = layer_nbrs[pid].long()                           # [M0] one-hop of d
    n1c = N1.clamp_min(0)
    valid1 = (N1 >= 0) & ~deleted[n1c]
    rows1 = layer_nbrs[n1c].long()                        # [M0, M0]
    mutual = torch.any(rows1 == pid, dim=1) & valid1      # v with edge v->d

    if strategy.repair_set == "one_hop":
        p_ids = torch.where(valid1, N1, INVALID)
    elif strategy.repair_set == "mutual":
        p_ids = torch.where(mutual, N1, INVALID)
    else:                                                 # mutual_thn
        two_hop = rows1.reshape(-1)
        thc = two_hop.clamp_min(0)
        th_valid = (two_hop >= 0) & ~deleted[thc]
        th_valid &= valid1.repeat_interleave(M0)
        th_points_at_d = torch.any(layer_nbrs[thc] == pid, dim=1)
        th_ids = torch.where(th_valid & th_points_at_d, two_hop, INVALID)
        # compact to a bounded repair budget (3*M0), valid first
        th_ids, _ = dedup_ids(th_ids, torch.where(th_ids >= 0, 0.0, INF))
        th_ids = th_ids[stable_argsort((th_ids < 0).to(torch.int8))][:3 * M0]
        p_ids = torch.cat([torch.where(mutual, N1, INVALID), th_ids])

    v = p_ids[p_ids >= 0]                                  # repaired lanes
    if v.numel() == 0:
        return nbrs
    P = v.shape[0]
    q = vectors[v]
    if strategy.candidate_pool == "two_hop":
        two_hop = rows1.reshape(-1)
        th_valid = (two_hop >= 0) & valid1.repeat_interleave(M0)
        pool = torch.cat([torch.where(valid1, N1, INVALID),
                          torch.where(th_valid, two_hop, INVALID), pid_t])
        poolc = pool.clamp_min(0)
        pool_ok = (pool >= 0) & ~deleted[poolc]
        pool_vecs = vectors[poolc]                         # [C, d]
        ok = pool_ok[None, :] & (pool[None, :] != v[:, None])
        dq = torch.where(ok, dist_point(params.space, q, pool_vecs), INF)
        ids = torch.where(ok, pool[None, :], INVALID)
        sel, _ = alpha_rng_select(ids, dq,
                                  pool_vecs.expand(P, *pool_vecs.shape),
                                  m_l, strategy.repair_alpha, params.space)
    else:                          # per_vertex: C(v) = N(v) ∪ N(d) ∪ {new}
        own = layer_nbrs[v].long()                         # [P, M0]
        pool = torch.cat([own, N1[None].expand(P, M0),
                          pid_t[None].expand(P, 1)], dim=1)
        poolc = pool.clamp_min(0)
        ok = (pool >= 0) & ~deleted[poolc] & (pool != v[:, None])
        pool_vecs = vectors[poolc]
        dq = torch.where(ok, dist_point(params.space, q, pool_vecs), INF)
        ids = torch.where(ok, pool, INVALID)
        sel, _ = select_neighbors(q, ids, pool_vecs, dq, m_l,
                                  strategy.repair_alpha, params.space)
    layer_nbrs[v] = _pad_row(sel, M0).to(layer_nbrs.dtype)
    return nbrs


# ---------------------------------------------------------------------------
# replaced_update entry point (paper Algorithms 2+3)
# ---------------------------------------------------------------------------

def _update_reinsert(params: HNSWParams, index: HNSWIndex, pid: int,
                     insert_alpha: float) -> HNSWIndex:
    """Re-link slot ``pid`` (already holding its new vector) at its
    inherited level (paper Algorithm 3)."""
    lvl = int(index.levels[pid])
    max_layer = int(index.max_layer)
    xq = index.vectors[pid][None]
    ep = index.entry.long().clamp_min(0).reshape(1)
    for layer in range(params.num_layers - 1, 0, -1):
        if layer <= max_layer and layer > lvl:
            ep = greedy_layer(params, index, xq, ep, layer)
    for layer in range(min(lvl, params.num_layers - 1), -1, -1):
        ep = connect_at_layer(params, index, xq[0], pid, ep, layer,
                              insert_alpha)
    return index


def replaced_update(params: HNSWParams, index: HNSWIndex, x: torch.Tensor,
                    label: int, variant: str = "mn_ru_gamma", *,
                    slot: int | None = None, level: int | None = None,
                    generator: torch.Generator | None = None) -> HNSWIndex:
    """Insert ``x`` reusing a mark-deleted slot (paper Algorithms 2+3).

    Falls back to a fresh insert into a free slot when no deleted point
    exists (paper line: "Perform normal insertion"). ``slot`` overrides
    the chosen slot and ``level`` the fresh insert's level.
    """
    get_strategy(variant)   # uniform unknown-strategy error, fail-fast
    label = int(label)
    if num_deleted(index) == 0:
        pid = slot if slot is not None else first_free_slot(
            index, generator=generator)
        if pid >= 0:
            insert(params, index, x, pid, label, level, generator)
        return index
    pid = slot if slot is not None else first_deleted_slot(
        index, generator=generator)
    index.vectors[pid] = x.to(index.vectors.dtype)
    index.labels[pid] = label
    index.deleted[pid] = False
    for layer in range(int(index.levels[pid]) + 1):
        _repair_layer(params, index.neighbors, index.vectors, index.deleted,
                      pid, layer, variant)
    return _update_reinsert(params, index, pid, params.alpha)


def _override(seq, i):
    return None if seq is None else seq[i]


def apply_update_batch_sequential(params: HNSWParams, index: HNSWIndex,
                                  ops, labels, X,
                                  variant: str = "mn_ru_gamma", *,
                                  slots: Sequence | None = None,
                                  levels: Sequence | None = None,
                                  generator: torch.Generator | None = None
                                  ) -> HNSWIndex:
    """The sequential tape executor: one op at a time, in order.

      OP_DELETE  == mark_delete
      OP_REPLACE == replaced_update (deleted-slot reuse + fresh fallback)
      OP_INSERT  == insert into a free slot (no-op when full)
      OP_NOP     == padding

    ``slots[i]`` / ``levels[i]`` override op ``i``'s slot and level draws.
    """
    get_strategy(variant)
    ops = [int(o) for o in torch.as_tensor(ops).reshape(-1).tolist()]
    labels = [int(v) for v in torch.as_tensor(labels).reshape(-1).tolist()]
    X = torch.as_tensor(X, dtype=index.vectors.dtype).to(index.device)
    for i, op in enumerate(ops):
        if op == OP_DELETE:
            mark_delete(index, labels[i])
        elif op == OP_REPLACE:
            replaced_update(params, index, X[i], labels[i], variant,
                            slot=_override(slots, i),
                            level=_override(levels, i), generator=generator)
        elif op == OP_INSERT:
            pid = _override(slots, i)
            if pid is None:
                pid = first_free_slot(index, generator=generator)
            if pid >= 0:
                insert(params, index, X[i], pid, labels[i],
                       _override(levels, i), generator)
    return index


register_executor("sequential", apply_update_batch_sequential)


def apply_update_batch(params: HNSWParams, index: HNSWIndex, ops, labels, X,
                       variant: str = "mn_ru_gamma",
                       execution: str = "wave", **draws) -> HNSWIndex:
    """Apply a padded tape of mixed {delete, replace, insert} ops.

    ``execution`` picks the tape executor from the registry: ``"wave"``
    (default, :mod:`~repro_torch.core.batch_update`) or ``"sequential"``.
    Strategies with a custom ``repair_fn`` route to the sequential
    executor, which alone can honour them. ``draws`` (``generator=`` and
    the executor's overrides) pass through.
    """
    get_strategy(variant)
    exec_fn = get_executor(execution)
    if execution == "wave" and get_strategy(variant).repair_fn is not None:
        exec_fn = get_executor("sequential")
    return exec_fn(params, index, ops, labels, X, variant, **draws)


def delete_and_update_batch(params: HNSWParams, index: HNSWIndex,
                            del_labels, new_X, new_labels,
                            variant: str = "mn_ru_gamma", *,
                            slots: Sequence | None = None,
                            levels: Sequence | None = None,
                            generator: torch.Generator | None = None
                            ) -> HNSWIndex:
    """Mark ``del_labels`` deleted, then replace each with a row of
    ``new_X`` (``slots[i]``/``levels[i]`` override replace ``i``'s draws)."""
    for lbl in torch.as_tensor(del_labels).reshape(-1).tolist():
        mark_delete(index, lbl)
    new_X = torch.as_tensor(new_X, dtype=index.vectors.dtype).to(index.device)
    for i, lbl in enumerate(torch.as_tensor(new_labels).reshape(-1).tolist()):
        replaced_update(params, index, new_X[i], lbl, variant,
                        slot=_override(slots, i), level=_override(levels, i),
                        generator=generator)
    return index
