"""Backup index + dualSearch (paper §IV-A/B, Algorithm 1).

Every ``tau`` replaced_update operations the index is swept for unreachable
points and a small dedicated HNSW ("backup index") is rebuilt over them.
Queries then run against BOTH indexes and merge by distance — unreachable
points stay servable without a full main-index rebuild. Reachability is the
BFS closure (``reach.bfs_unreachable``), a superset of search reachability.

The merge serves a backup hit only while its label is live in the main
index it is merged with: between two rebuilds the main index deletes and
replaces points the backup still holds. The reference merges every backup
hit; the two agree wherever no backup label has died since the rebuild.

Spans (``core.spans``): ``backup.sweep`` (the reachability sweep of a
rebuild) and ``search.dual`` (``rows``; ``backup_hits``, the served entries
that came from the backup, and ``dead_dropped``, the backup hits dropped as
no longer live, counted over the batch's first ``rows`` rows, and added
to the counters ``backup_hits_served`` and ``backup_dead_dropped``).
"""
from __future__ import annotations

import torch

from . import spans
from .common import INF, stable_argsort
from .hnsw import WAVE_BUILD_MIN_N, insert
from .index import HNSWIndex, HNSWParams, empty_index, seed_key
from .reach import bfs_unreachable
from .search import batch_knn


def rebuild_backup(params: HNSWParams, index: HNSWIndex, capacity: int,
                   seed: int = 0, *, execution: str = "auto",
                   generator: torch.Generator | None = None,
                   levels=None, draws=None) -> HNSWIndex:
    """Build a fresh backup index over (up to ``capacity``) unreachable
    points, in slot order; point ``i`` lands in backup slot ``i``.

    ``execution`` routes like ``build``: ``"sequential"`` inserts the
    unreachable points one at a time (the reference's semantics, which
    loops over the whole capacity and skips the rest), ``"wave"`` builds
    them with ``build_batch``, and ``"auto"`` takes waves from
    ``WAVE_BUILD_MIN_N`` points — at SIFT1M size thousands of points are
    unreachable, and one lockstep insert at a time would take minutes.
    Past that size the backup is therefore a wave build, where the
    reference's is always sequential. Levels come from ``generator``
    (default: a CPU generator seeded with ``seed``), or from ``levels``
    (sequential route) or ``build_batch``'s ``draws`` (wave route). The
    backup's ``source`` holds the main slot of each backup slot.
    """
    if execution not in ("auto", "wave", "sequential"):
        raise ValueError(f"unknown backup execution {execution!r}; expected "
                         f"'auto', 'wave', or 'sequential'")
    with spans.span("backup.sweep"):
        mask = bfs_unreachable(index)
    N = index.capacity
    ar = torch.arange(N, device=index.device)
    slots = stable_argsort(torch.where(mask, ar, N))[:capacity]
    n_valid = int(mask[slots].sum())
    slots = slots[:n_valid]
    if generator is None:
        generator = torch.Generator().manual_seed(int(seed))
    if execution == "auto":
        execution = "wave" if n_valid >= WAVE_BUILD_MIN_N else "sequential"
    if execution == "wave" and n_valid:
        from .batch_update import build_batch
        backup = build_batch(params, index.vectors[slots],
                             index.labels[slots], capacity=capacity,
                             generator=generator, draws=draws,
                             device=index.device)
    else:
        backup = empty_index(params, capacity, index.dim, 0,
                             dtype=index.vectors.dtype, device=index.device)
        labels = index.labels[slots].tolist()
        for i in range(n_valid):
            insert(params, backup, index.vectors[slots[i]], i, labels[i],
                   None if levels is None else int(levels[i]), generator)
    # the reference's key PRNGKey(0) + seed, carried as opaque state
    backup.rng = (seed_key(0).long() + int(seed)).to(torch.uint32)
    backup.source = torch.full((capacity,), -1, dtype=torch.int32,
                               device=index.device)
    backup.source[:n_valid] = slots.to(torch.int32)
    return backup


def empty_backup(params: HNSWParams, capacity: int, dim: int,
                 dtype=torch.float32, device="cuda") -> HNSWIndex:
    """A backup index that holds no point yet (``source`` all -1)."""
    backup = empty_index(params, capacity, dim, 1, dtype=dtype, device=device)
    backup.source = torch.full((capacity,), -1, dtype=torch.int32,
                               device=backup.device)
    return backup


def _live_hits(main: HNSWIndex, backup: HNSWIndex, labels: torch.Tensor,
               ids: torch.Tensor) -> torch.Tensor:
    """bool: whether each backup hit (``labels``, backup slots ``ids``) is
    still live in ``main``, by label: the main slot it was copied from
    (``backup.source``) still holds that label, allocated and not deleted
    (``replaced_update`` reuses a freed slot under a new label)."""
    src = backup.source[ids.clamp_min(0).long()]
    s = src.clamp_min(0).long()
    return ((labels >= 0) & (src >= 0) & (main.labels[s] == labels)
            & (main.levels[s] >= 0) & ~main.deleted[s])


def batch_dual_search(params_main: HNSWParams, main: HNSWIndex,
                      params_backup: HNSWParams, backup: HNSWIndex,
                      Q: torch.Tensor, k: int, ef: int | None = None, *,
                      rows: int | None = None):
    """Algorithm 1 (dualSearch) for a batch: query both indexes, drop every
    backup hit whose label is no longer live in ``main``, drop a label
    found in both (main's copy stays), and take the ``k`` nearest by a
    stable sort (main's hits first). Returns ``(labels[b, k] i32,
    dists[b, k])``, padded with -1 / inf only where fewer than ``k``
    eligible hits remain. The two metric spaces must match, and ``backup``
    is one made by ``rebuild_backup`` or ``empty_backup`` (its ``source``).

    ``rows`` is the number of real queries leading ``Q`` (the rest pad).
    Where a registry records, the span's counts over those rows also go to
    its counters ``backup_hits_served`` and ``backup_dead_dropped``."""
    if params_main.space != params_backup.space:
        raise ValueError(
            f"dualSearch cannot merge across metric spaces: main is "
            f"{params_main.space!r}, backup is {params_backup.space!r}")
    if backup.source is None:
        raise ValueError("dualSearch needs a backup made by rebuild_backup "
                         "or empty_backup: it has no source slots")
    rows = Q.shape[0] if rows is None else rows
    with spans.span("search.dual", rows=rows) as sp:
        lm, _, dm = batch_knn(params_main, main, Q, k, ef)
        lb, ib, db = batch_knn(params_backup, backup, Q, k, ef)
        live = _live_hits(main, backup, lb, ib)
        dead = (lb >= 0) & ~live
        labels = torch.cat([lm, torch.where(live, lb, -1)], dim=1).long()
        dists = torch.cat([dm, db], dim=1)
        order = stable_argsort(labels)
        sl = labels.gather(1, order)
        dup_s = torch.zeros_like(sl, dtype=torch.bool)
        dup_s[:, 1:] = (sl[:, 1:] == sl[:, :-1]) & (sl[:, 1:] >= 0)
        dup = torch.zeros_like(dup_s).scatter_(1, order, dup_s)
        drop = dup | (labels < 0)
        dists = torch.where(drop, INF, dists)
        o = stable_argsort(dists)[:, :k]
        served = ~drop.gather(1, o)
        out = torch.where(served, labels.gather(1, o), -1).int()
        if sp is not spans.NO_SPAN:
            hits = (served & (o >= lm.shape[1]))[:rows].sum()
            hits, dropped = torch.stack([hits, dead[:rows].sum()]).tolist()
            sp.set(backup_hits=hits, dead_dropped=dropped)
            spans.count("backup_hits_served", hits)
            spans.count("backup_dead_dropped", dropped)
        return out, dists.gather(1, o)


def dual_search(params_main: HNSWParams, main: HNSWIndex,
                params_backup: HNSWParams, backup: HNSWIndex,
                q: torch.Tensor, k: int, ef: int | None = None):
    """Algorithm 1 (dualSearch) for one query ``q[d]``."""
    labels, dists = batch_dual_search(params_main, main, params_backup,
                                      backup, q[None], k, ef)
    return labels[0], dists[0]


class DualIndexManager:
    """Host-side orchestration of main index + tau-triggered backup rebuilds
    (the paper's upper-level application layer, Fig. 4)."""

    def __init__(self, params: HNSWParams, index: HNSWIndex, tau: int,
                 backup_capacity: int,
                 backup_params: HNSWParams | None = None,
                 generator: torch.Generator | None = None):
        self.params = params
        self.index = index
        self.tau = tau
        self.backup_params = backup_params or params
        self.backup_capacity = backup_capacity
        self.backup = empty_backup(self.backup_params, backup_capacity,
                                   index.dim, dtype=index.vectors.dtype,
                                   device=index.device)
        self.generator = generator
        self._ru_ops = 0
        self._rebuilds = 0

    def mark_delete(self, label):
        from .update import mark_delete
        mark_delete(self.index, label)

    def replaced_update(self, x, label, variant: str = "mn_ru_gamma"):
        from .update import replaced_update
        replaced_update(self.params, self.index, x, label, variant,
                        generator=self.generator)
        self._ru_ops += 1
        if self._ru_ops % self.tau == 0:
            self.rebuild()

    def replaced_update_batch(self, del_labels, new_X, new_labels,
                              variant: str = "mn_ru_gamma"):
        from .update import delete_and_update_batch
        delete_and_update_batch(self.params, self.index, del_labels, new_X,
                                new_labels, variant,
                                generator=self.generator)
        self._ru_ops += len(new_labels)
        if self._ru_ops // self.tau > self._rebuilds:
            self.rebuild()

    def rebuild(self):
        self.backup = rebuild_backup(self.backup_params, self.index,
                                     self.backup_capacity,
                                     self._rebuilds + 1,
                                     generator=self.generator)
        self._rebuilds += 1

    def search(self, Q, k: int, ef: int | None = None):
        return batch_dual_search(self.params, self.index, self.backup_params,
                                 self.backup, Q, k, ef)
