"""HNSW construction: fresh insert + incremental build (Malkov-Yashunin Alg. 1).

Functions that change an index update its tensors in place and return it
(the JAX reference returns a new pytree): at SIFT1M size the adjacency
alone is 512 MiB, and nothing reads the pre-update state afterwards. Clone
an index (``index.clone()``) before an update to keep the old state.
"""
from __future__ import annotations

import torch

from .common import INF, INVALID, resolve_device, storage_tensor
from .index import HNSWIndex, HNSWParams, empty_index, sample_level
from .metrics import dist_point
from .prune import select_neighbors
from .search import greedy_layer, search_layer

#: ``build(execution="auto")`` routes to the wave builder at/above this size
WAVE_BUILD_MIN_N = 1024


def _pad_row(sel_ids: torch.Tensor, width: int) -> torch.Tensor:
    """Pad/truncate selected id lists ``[..., S]`` to full rows of ``width``."""
    n = min(sel_ids.shape[-1], width)
    row = torch.full(sel_ids.shape[:-1] + (width,), INVALID,
                     dtype=torch.int64, device=sel_ids.device)
    row[..., :n] = sel_ids[..., :n]
    return row


def add_reverse_edges(params: HNSWParams, nbrs_layer: torch.Tensor,
                      vectors: torch.Tensor, pid: int,
                      sel_ids: torch.Tensor, layer: int,
                      alpha: float) -> torch.Tensor:
    """Add ``e -> pid`` for every selected neighbour e, shrinking full rows.

    ``nbrs_layer``: [N, M0] adjacency of one layer, updated in place (and
    returned). Rows are re-pruned with alpha-RNG when over capacity.
    """
    m_l = params.m_for_layer(layer)
    M0 = params.M0
    e = sel_ids.long()
    valid = e >= 0
    if not bool(valid.any()):
        return nbrs_layer
    e = e[valid]
    S = e.shape[0]
    row = nbrs_layer[e].long()                                  # [S, M0]
    already = torch.any(row == pid, dim=1)
    degree = torch.sum(row >= 0, dim=1)
    has_space = degree < m_l
    free_pos = (row < 0).to(torch.uint8).argmax(dim=1)
    appended = row.clone()
    appended[torch.arange(S, device=row.device), free_pos] = pid
    cand_ids = torch.cat([row, torch.full((S, 1), pid, dtype=torch.int64,
                                          device=row.device)], dim=1)
    cand_vecs = vectors[cand_ids.clamp_min(0)]
    q = vectors[e]
    cand_d = torch.where(cand_ids >= 0, dist_point(params.space, q, cand_vecs),
                         INF)
    sel, _ = select_neighbors(q, cand_ids, cand_vecs, cand_d, m_l, alpha,
                              params.space)
    shrunk = _pad_row(sel, M0)
    new_row = torch.where(already[:, None], row,
                          torch.where(has_space[:, None], appended, shrunk))
    nbrs_layer[e] = new_row.to(nbrs_layer.dtype)
    return nbrs_layer


def connect_at_layer(params: HNSWParams, index: HNSWIndex, x: torch.Tensor,
                     pid: int, ep: torch.Tensor, layer: int,
                     alpha: float) -> torch.Tensor:
    """Search + select + wire one layer for point ``pid`` with vector ``x``.

    Wires ``index.neighbors[layer]`` in place and returns the next entry
    point (a 1-element tensor).
    """
    m_l = params.m_for_layer(layer)
    ids, dists = search_layer(params, index, x[None], ep, layer,
                              params.ef_construction)
    ids, dists = ids[0], dists[0]
    ok = (ids >= 0) & (ids != pid)
    # prefer live candidates; when EVERY candidate is mark-deleted, link
    # through the deleted ones anyway (hnswlib semantics) — otherwise the
    # new point comes up with zero edges and is unreachable from the entry
    alive = ok & ~index.deleted[ids.clamp_min(0)]
    ok = torch.where(torch.any(alive), alive, ok)
    dists = torch.where(ok, dists, INF)
    ids = torch.where(ok, ids, INVALID)

    cand_vecs = index.vectors[ids.clamp_min(0)]
    sel, _ = select_neighbors(x[None], ids[None], cand_vecs[None],
                              dists[None], m_l, alpha, params.space)
    layer_nbrs = index.neighbors[layer]
    layer_nbrs[pid] = _pad_row(sel[0], params.M0).to(layer_nbrs.dtype)
    add_reverse_edges(params, layer_nbrs, index.vectors, pid, sel[0], layer,
                      alpha)
    j = torch.argmin(dists)
    return torch.where(ids[j] >= 0, ids[j].clamp_min(0), ep[0]).reshape(1)


def insert(params: HNSWParams, index: HNSWIndex, x: torch.Tensor,
           pid: int, label: int, level_override: int | None = None,
           generator: torch.Generator | None = None) -> HNSWIndex:
    """Insert vector ``x`` into slot ``pid`` with external ``label``.

    The level is ``level_override`` when given, else drawn from
    ``generator``. Updates ``index`` in place and returns it.
    """
    pid, label = int(pid), int(label)
    lvl = (sample_level(generator, params) if level_override is None
           else int(level_override))
    index.vectors[pid] = x.to(index.vectors.dtype)
    index.labels[pid] = label
    if int(index.count) == 0:
        index.levels[pid] = lvl
        index.deleted[pid] = False
        index.entry.fill_(pid)
        index.max_layer.fill_(lvl)
        index.count.fill_(1)
        return index

    max_layer = int(index.max_layer)
    ep = index.entry.long().clamp_min(0).reshape(1)
    xq = index.vectors[pid][None]
    for layer in range(params.num_layers - 1, 0, -1):
        if layer <= max_layer and layer > lvl:
            ep = greedy_layer(params, index, xq, ep, layer)
    for layer in range(min(lvl, max_layer), -1, -1):
        ep = connect_at_layer(params, index, xq[0], pid, ep, layer,
                              params.alpha)
    if lvl > max_layer:
        index.entry.fill_(pid)
        index.max_layer.fill_(lvl)
    index.levels[pid] = lvl
    index.deleted[pid] = False
    index.count += 1
    return index


def build(params: HNSWParams, vectors, labels=None, seed: int = 0,
          capacity: int | None = None, execution: str = "auto", *,
          generator: torch.Generator | None = None, levels=None,
          draws=None, device="cuda") -> HNSWIndex:
    """Build an index over ``vectors[n, d]``; point ``i`` lands in slot ``i``.

    ``execution="wave"`` constructs in ``O(log n)`` geometrically-growing
    conflict-free waves (:func:`~repro_torch.core.batch_update.build_batch`);
    ``"sequential"`` inserts one point at a time; ``"auto"`` picks waves
    from :data:`WAVE_BUILD_MIN_N` points. Levels come from ``generator``
    (default: a CPU generator seeded with ``seed``); for parity with the
    reference the sequential builder takes per-point ``levels`` instead,
    and the wave builder ``build_batch``'s ``draws``. The index stores the
    vectors in their own dtype (:func:`~repro_torch.core.common.
    storage_tensor`: f32, bf16 or f16), as the reference does.
    """
    if execution not in ("auto", "wave", "sequential"):
        raise ValueError(f"unknown build execution {execution!r}; expected "
                         f"'auto', 'wave', or 'sequential'")
    n = len(vectors)
    if execution == "auto":
        execution = "wave" if n >= WAVE_BUILD_MIN_N else "sequential"
    if execution == "wave":
        from .batch_update import build_batch
        return build_batch(params, vectors, labels, seed=seed,
                           capacity=capacity, generator=generator,
                           draws=draws, device=device)
    dev = resolve_device(device)
    X = storage_tensor(vectors, dev)
    d = X.shape[1]
    labels = list(range(n)) if labels is None else [int(v) for v in labels]
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    index = empty_index(params, capacity or n, d, seed, dtype=X.dtype,
                        device=dev)
    for i in range(n):
        insert(params, index, X[i], i, labels[i],
               None if levels is None else int(levels[i]), generator)
    return index
