"""Layered beam search over the tensorised HNSW graph, batched in lockstep.

``search_layer`` is the paper's K-NN-SEARCH building block (HNSW Algorithm
2) with a fixed-size sorted beam: any unexpanded entry inside the top-ef
beam is a candidate, and entries pushed past ef by the merge are the ones
the classical algorithm would discard.

Where the reference ``vmap``s one ``while_loop`` per query, the port runs
all queries of a batch in lockstep: every lane has a done mask and its own
``[N]`` visited row. A finished lane no longer changes (its offers are
masked off and its beam is already sorted), so the loop runs to the
reference's step cap (``HNSWParams.steps_for``) and only checks "all lanes
done" on the host every few steps. Results equal the per-query loop's.

Filtered search: an optional slot-level ``allow`` mask threads a second
fixed-size beam through the traversal — the walk still expands through
disallowed points, but only allowed points enter the result beam.

Each step's expansion (the expanded row's neighbours: which are fresh,
their visited flags, their distances) is one ``kernels.beam_expand`` call:
one hand-written kernel launch on CUDA, which loads and scores only the
fresh rows of the running lanes.

Spans (``core.spans``): ``search.descend`` (``steps``: greedy steps summed
over its layers) and one ``search.layer`` per :func:`search_layer` call
(``layer``, ``lanes``, ``ef``, ``steps``: the loop's count; while a
profiler records, ``rows_visited``: the rows the lanes marked visited, a
0-d device tensor from ``kernels.count_flags``, one launch and no host
sync).
"""
from __future__ import annotations

import torch

from . import spans
from .common import INF, INVALID, stable_argsort
from .index import HNSWIndex, HNSWParams
from .metrics import dist_point, get_metric
from ..kernels.beam_expand import beam_expand
from ..kernels.count_flags import count_flags

#: lockstep loops test "all lanes done" on the host once per this many steps
CHECK_EVERY = 8


def _point_dist(space: str, Q: torch.Tensor, X: torch.Tensor
                ) -> torch.Tensor:
    """Distance from each row of ``Q[B, d]`` to its own row of ``X[B, d]``."""
    return dist_point(space, Q, X.unsqueeze(-2)).squeeze(-1)


def greedy_layer(params: HNSWParams, index: HNSWIndex, Q: torch.Tensor,
                 ep: torch.Tensor, layer: int,
                 active: torch.Tensor | None = None) -> torch.Tensor:
    """ef=1 greedy descent within one layer for every lane of ``Q[B, d]``;
    returns the improved entry points ``[B]`` (inactive lanes keep ``ep``)."""
    return _greedy_steps(params, index, Q, ep, layer, active)[0]


def _greedy_steps(params: HNSWParams, index: HNSWIndex, Q: torch.Tensor,
                  ep: torch.Tensor, layer: int,
                  active: torch.Tensor | None) -> tuple[torch.Tensor, int]:
    """:func:`greedy_layer`, and the steps its loop ran."""
    nbrs_l = index.neighbors[layer]
    B = Q.shape[0]
    rows = torch.arange(B, device=Q.device)
    cur = ep.long().clamp_min(0)
    cur_d = _point_dist(params.space, Q, index.vectors[cur])
    running = (torch.ones(B, dtype=torch.bool, device=Q.device)
               if active is None else active.clone())
    step = 0
    while True:
        if step % CHECK_EVERY == 0 and not bool(running.any()):
            break
        nb = nbrs_l[cur].long()
        valid = nb >= 0
        nc = nb.clamp_min(0)
        nd = torch.where(valid, dist_point(params.space, Q,
                                           index.vectors[nc]), INF)
        best_d, j = nd.min(dim=1)
        imp = running & (best_d < cur_d)
        cur = torch.where(imp, nc[rows, j], cur)
        cur_d = torch.where(imp, best_d, cur_d)
        running = imp
        step += 1
    return cur, step


def search_layer(params: HNSWParams, index: HNSWIndex, Q: torch.Tensor,
                 ep: torch.Tensor, layer: int, ef: int,
                 max_steps: int | None = None,
                 allow: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Beam search at ``layer``; returns ``(ids[B, ef] i64, dists[B, ef])``
    sorted ascending per lane.

    Traverses through deleted points (hnswlib semantics) — the caller
    filters deleted ids out of results. With ``allow`` (bool[N] slot mask)
    traversal is unchanged but the returned beam holds only allowed slots.
    """
    with spans.span("search.layer", layer=layer, lanes=Q.shape[0],
                    ef=ef) as sp:
        return _search_layer(params, index, Q, ep, layer, ef, max_steps,
                             allow, sp)


def _search_layer(params, index, Q, ep, layer, ef, max_steps, allow, sp):
    N = index.capacity
    B = Q.shape[0]
    dev = Q.device
    M0 = params.M0
    steps_cap = max_steps if max_steps is not None else params.steps_for(ef)
    metric = get_metric(params.space)
    Q = Q.contiguous()                    # the kernel takes contiguous rows
    nbrs_l = index.neighbors[layer]
    filtered = allow is not None
    rows = torch.arange(B, device=dev)

    ep = ep.long().clamp_min(0)
    d0 = _point_dist(params.space, Q, index.vectors[ep])
    dists = torch.full((B, ef), INF, device=dev)
    dists[:, 0] = d0
    ids = torch.full((B, ef), INVALID, dtype=torch.int64, device=dev)
    ids[:, 0] = ep
    expanded = torch.zeros((B, ef), dtype=torch.bool, device=dev)
    visited = torch.zeros((B, N + 1), dtype=torch.bool, device=dev)
    visited[rows, ep] = True
    if filtered:
        ep_ok = allow[ep]
        res_d = torch.full((B, ef), INF, device=dev)
        res_d[:, 0] = torch.where(ep_ok, d0, INF)
        res_i = torch.full((B, ef), INVALID, dtype=torch.int64, device=dev)
        res_i[:, 0] = torch.where(ep_ok, ep, INVALID)
    no_exp = torch.zeros((B, M0), dtype=torch.bool, device=dev)

    steps = steps_cap
    for step in range(steps_cap):
        f = torch.where(expanded | (ids < 0), INF, dists)
        fmin, i = f.min(dim=1)
        running = fmin < INF
        if step % CHECK_EVERY == 0 and not bool(running.any()):
            steps = step
            break
        cur = ids[rows, i].clamp_min(0)
        expanded[rows, i] |= running

        nd, ni = beam_expand(metric, Q, index.vectors, nbrs_l, cur, running,
                             visited)                     # [B, M0] each
        all_d = torch.cat([dists, nd], dim=1)
        all_i = torch.cat([ids, ni], dim=1)
        all_e = torch.cat([expanded, no_exp], dim=1)
        order = stable_argsort(all_d)[:, :ef]
        dists = all_d.gather(1, order)
        ids = all_i.gather(1, order)
        expanded = all_e.gather(1, order)
        if filtered:
            a_ok = (ni >= 0) & allow[ni.clamp_min(0)]
            rd = torch.cat([res_d, torch.where(a_ok, nd, INF)], dim=1)
            ri = torch.cat([res_i, torch.where(a_ok, ni, INVALID)], dim=1)
            r_order = stable_argsort(rd)[:, :ef]
            res_d = rd.gather(1, r_order)
            res_i = ri.gather(1, r_order)
    sp.set(steps=steps)
    if sp.profiled:
        sp.set(rows_visited=count_flags(visited, N))
    if filtered:
        return res_i, res_d
    return ids, dists


def _descend(params: HNSWParams, index: HNSWIndex, Q: torch.Tensor,
             down_to_layer: torch.Tensor) -> torch.Tensor:
    """Greedy descent from the top layer to (but not including)
    ``down_to_layer[B]``; returns the entry points ``[B]``."""
    B = Q.shape[0]
    with spans.span("search.descend") as sp:
        ep = index.entry.long().clamp_min(0).expand(B).clone()
        steps = 0
        for layer in range(params.num_layers - 1, 0, -1):
            active = (layer <= index.max_layer) & (layer > down_to_layer)
            ep, n = _greedy_steps(params, index, Q, ep, layer, active)
            steps += n
        sp.set(steps=steps)
    return ep


def batch_knn(params: HNSWParams, index: HNSWIndex, Q: torch.Tensor,
              k: int, ef: int | None = None,
              allow: torch.Tensor | None = None):
    """Batched query: ``Q[b, d] -> (labels[b, k], ids[b, k], dists[b, k])``.

    Deleted and free slots are excluded from results (but traversed
    through). ``allow`` is one slot mask shared by the whole batch.
    Labels and ids are int32, padded with -1 (and inf distances).
    """
    ef = max(ef or params.ef_search, k)
    B = Q.shape[0]
    down = torch.zeros(B, dtype=torch.int32, device=Q.device)
    ep = _descend(params, index, Q, down)
    ids, dists = search_layer(params, index, Q, ep, 0, ef, allow=allow)
    ic = ids.clamp_min(0)
    ok = (ids >= 0) & ~index.deleted[ic] & (index.levels[ic] >= 0)
    dists = torch.where(ok, dists, INF)
    ids = torch.where(ok, ids, INVALID)
    order = stable_argsort(dists)[:, :k]
    ids_k = ids.gather(1, order)
    dists_k = dists.gather(1, order)
    labels_k = torch.where(ids_k >= 0, index.labels[ids_k.clamp_min(0)].long(),
                           INVALID)
    return labels_k.int(), ids_k.int(), dists_k


def knn_search(params: HNSWParams, index: HNSWIndex, q: torch.Tensor,
               k: int, ef: int | None = None,
               allow: torch.Tensor | None = None):
    """One query ``q[d]``: ``(labels[k], slot_ids[k], dists[k])``."""
    labels, ids, dists = batch_knn(params, index, q[None], k, ef, allow)
    return labels[0], ids[0], dists[0]
