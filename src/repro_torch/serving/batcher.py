"""Dynamic query micro-batcher: coalesce single queries into padded batches.

Single-query arrivals are queued as :class:`QueryTicket`\\ s; ``flush()``
packs them into batches and dispatches ONE call per batch — ``batch_knn``
/ ``batch_dual_search`` on the graph tier, or the exact scan tier
(``core.planner.exact_scan`` on the ``topk_dist`` kernel) when the
per-bucket planner consult says the graph walk would lose (small live set,
heavy mark-delete churn). Batch shapes are bucketed to powers of two
(capped at ``max_batch``), as in the reference, where the bucket bounds the
number of compiled programs; the port runs eagerly, and the buckets keep
what a dispatched batch looks like the same. Padding rows duplicate the
first real query and their results are discarded on scatter-back.

The batcher is snapshot-agnostic: ``flush(snapshot)`` runs every ticket in
the flush against that single :class:`EpochSnapshot`, which is what gives
the engine its isolation guarantee (tickets record the epoch they were
served at).
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from ..core import spans
from ..core.backup import batch_dual_search
from ..core.index import HNSWParams
from ..core.metrics import get_metric, normalize_rows
from ..core.planner import (DEFAULT_PLANNER, MODES, PlannerConfig,
                            choose_tier, exact_scan, index_stats)
from ..core.search import batch_knn

from .metrics import MetricsRegistry
from .snapshot import EpochSnapshot


def pow2_floor(n: int) -> int:
    """Largest power of two <= n (for pow2-aligning user-supplied caps)."""
    return 1 << (int(n).bit_length() - 1)


def bucket_size(n: int, max_batch: int) -> int:
    """Smallest power of two >= n, capped at ``max_batch``."""
    b = 1
    while b < n and b < max_batch:
        b <<= 1
    return min(b, max_batch)


class QueryTicket:
    """Handle for one submitted query; filled in when its batch is served."""

    __slots__ = ("qid", "vector", "labels", "dists", "epoch", "latency_s",
                 "_submit_t", "_done")

    def __init__(self, qid: int, vector: np.ndarray):
        self.qid = qid
        self.vector = vector
        self.labels: np.ndarray | None = None
        self.dists: np.ndarray | None = None
        self.epoch: int | None = None
        self.latency_s: float | None = None
        self._submit_t = time.perf_counter()
        self._done = False

    @property
    def done(self) -> bool:
        return self._done

    def result(self) -> tuple[np.ndarray, np.ndarray]:
        if not self._done:
            raise RuntimeError(f"query {self.qid} not served yet — pump the "
                               "engine (or flush the batcher) first")
        return self.labels, self.dists

    def _complete(self, labels: np.ndarray, dists: np.ndarray,
                  epoch: int) -> None:
        self.labels = labels
        self.dists = dists
        self.epoch = epoch
        self.latency_s = time.perf_counter() - self._submit_t
        self._done = True


class MicroBatcher:
    """Coalesces pending queries and serves them against one snapshot.

    ``search_fn(snapshot, Q, rows) -> (labels[b, k], dists[b, k])`` can be
    injected to reroute dispatch (``rows``: the real queries leading ``Q``,
    the rest pad). The default dispatch consults the query
    planner PER BUCKET: ``mode="auto"`` routes each batch to the exact tier
    when the snapshot is small / churn-heavy and to the graph tier
    otherwise — ``batch_dual_search`` when the snapshot carries a backup
    index, plain ``batch_knn`` if not. ``mode="graph"`` / ``mode="exact"``
    pin the tier. Planner statistics are cached per snapshot epoch.
    """

    def __init__(self, params: HNSWParams, k: int, ef: int | None = None,
                 max_batch: int = 64, metrics: MetricsRegistry | None = None,
                 search_fn: Callable | None = None,
                 backup_params: HNSWParams | None = None,
                 mode: str = "auto", planner: PlannerConfig | None = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if mode not in MODES:
            raise ValueError(f"unknown query mode {mode!r}; expected one "
                             f"of {MODES}")
        self.params = params
        self.k = k
        self.ef = ef
        # round the cap DOWN to a power of two so every dispatch shape is a
        # pow2 bucket
        self.max_batch = pow2_floor(max_batch)
        self._normalize = get_metric(params.space).normalize_ingest
        self.metrics = metrics or MetricsRegistry()
        self.backup_params = backup_params or params
        self.mode = mode
        self.planner = planner if planner is not None else DEFAULT_PLANNER
        self._stats_cache: tuple[int, object] | None = None  # (epoch, stats)
        self._search_fn = search_fn or self._default_search
        self._last_tier = self.mode      # the tier of the latest dispatch
        self._pending: list[QueryTicket] = []
        self._next_qid = 0

    # -- submission ---------------------------------------------------------
    def submit(self, q) -> QueryTicket:
        q = np.asarray(q, np.float32)
        if q.ndim != 1:
            raise ValueError(f"submit() takes one query vector, got {q.shape}")
        if self._normalize:                  # cosine: match ingest-side norm
            q = normalize_rows(q)
        t = QueryTicket(self._next_qid, q)
        self._next_qid += 1
        self._pending.append(t)
        self.metrics.counter("queries_submitted").inc()
        return t

    @property
    def pending(self) -> int:
        return len(self._pending)

    def invalidate_stats(self) -> None:
        """Drop the per-epoch planner stats cache, for drivers that rewrite
        an index without an epoch bump (consolidation changes the deleted
        fraction, so ``mode="auto"`` must re-route on the next bucket)."""
        self._stats_cache = None

    # -- dispatch -----------------------------------------------------------
    def _plan_tier(self, snapshot: EpochSnapshot) -> str:
        """Planner consult for one bucket (stats cached per epoch)."""
        if self.mode != "auto":
            return self.mode
        if self._stats_cache is None or self._stats_cache[0] != snapshot.epoch:
            self._stats_cache = (snapshot.epoch, index_stats(snapshot.index))
        return choose_tier(self._stats_cache[1], self.planner).tier

    def _default_search(self, snapshot: EpochSnapshot, Q: torch.Tensor,
                        rows: int):
        tier = self._last_tier = self._plan_tier(snapshot)
        self.metrics.counter(f"tier_{tier}_batches").inc()
        if tier == "exact":
            labels, _, dists = exact_scan(self.params, snapshot.index, Q,
                                          self.k)
            return labels, dists
        if snapshot.has_backup:
            # the snapshot's index is the one its backup's hits are held
            # live against: both come from the same epoch
            return batch_dual_search(self.params, snapshot.index,
                                     self.backup_params, snapshot.backup, Q,
                                     self.k, self.ef, rows=rows)
        labels, _, dists = batch_knn(self.params, snapshot.index, Q, self.k,
                                     self.ef)
        return labels, dists

    def flush(self, snapshot: EpochSnapshot) -> list[QueryTicket]:
        """Serve ALL pending queries against ``snapshot``; return the tickets.

        A backlog larger than ``max_batch`` dispatches multiple full batches
        back to back — every ticket in the flush still sees the same epoch.
        The flush is the span ``batcher.flush``; each batch ``batcher.batch``
        (``rows``, ``bucket``, ``tier``).
        """
        with spans.span("batcher.flush"):
            return self._flush(snapshot)

    def _flush(self, snapshot: EpochSnapshot) -> list[QueryTicket]:
        completed: list[QueryTicket] = []
        while self._pending:
            take = min(len(self._pending), self.max_batch)
            batch = self._pending[:take]
            del self._pending[:take]

            b = bucket_size(take, self.max_batch)
            Q = np.empty((b, batch[0].vector.shape[0]), np.float32)
            for i, t in enumerate(batch):
                Q[i] = t.vector
            Q[take:] = batch[0].vector          # pad rows: discarded below

            t0 = time.perf_counter()
            with spans.span("batcher.batch", rows=take, bucket=b) as sp:
                labels, dists = self._search_fn(
                    snapshot, torch.from_numpy(Q).to(snapshot.index.device),
                    take)
                labels = labels.cpu().numpy()   # waits for the device
                dists = dists.cpu().numpy()
                sp.set(tier=self._last_tier)
            dt = time.perf_counter() - t0

            for i, t in enumerate(batch):
                t._complete(labels[i], dists[i], snapshot.epoch)
                self.metrics.histogram("query_latency_ms").observe(
                    t.latency_s * 1e3)
            completed.extend(batch)
            self.metrics.counter("batches_dispatched").inc()
            self.metrics.counter("queries_served").inc(take)
            self.metrics.counter("pad_waste_rows").inc(b - take)
            self.metrics.histogram("batch_latency_ms").observe(dt * 1e3)
            self.metrics.histogram("batch_fill").observe(take / b)
        return completed
