"""Update scheduler: accumulate mutations, drain them as op tapes.

Writers never touch the index directly — they enqueue :class:`UpdateOp`\\ s
(``delete`` / ``replace`` / ``insert``) and the engine's maintenance cycle
drains the backlog in one call. ``execution="wave"`` (default) hands the
drained tape to the wave executor (:mod:`repro_torch.core.batch_update`):
duplicate labels collapse last-write-wins, deletes apply in one pass, and
the insert/replace set runs as conflict-free waves.
``execution="sequential"`` applies one op at a time (the parity path, and
the only one that honours a strategy's custom ``repair_fn``).

Tapes are padded to power-of-two lengths (``bucket_size``), as in the
reference, which decides what a drain sees. The reference also keeps an
LRU of compiled apply programs per bucket, exported as the
``apply_cache_size`` gauge; the port runs eagerly and compiles nothing, so
dispatch is a plain call and that cache, its ``apply_cache_max`` knob and
its gauge have no counterpart here.

The scheduler also owns the paper's tau counter (Fig. 4 upper layer): every
``tau`` replace/insert ops it rebuilds the unreachable-point backup index via
``core.backup.rebuild_backup`` — folded into the maintenance cycle, off the
query path.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from ..core import spans
from ..core.backup import rebuild_backup
from ..core.batch_update import apply_plan, compile_tape
from ..core.index import HNSWIndex, HNSWParams
from ..core.metrics import get_metric, normalize_rows
from ..core.strategies import get_executor, get_strategy
from ..core.update import (OP_DELETE, OP_INSERT, OP_NOP, OP_REPLACE,
                           apply_update_batch_sequential)

from .batcher import bucket_size, pow2_floor
from .metrics import MetricsRegistry

_KIND_TO_OP = {"delete": OP_DELETE, "replace": OP_REPLACE,
               "insert": OP_INSERT}


@dataclasses.dataclass(frozen=True)
class UpdateOp:
    """One queued mutation. ``vector`` is None for deletes."""
    kind: str                       # "delete" | "replace" | "insert"
    label: int
    vector: np.ndarray | None = None
    enqueued_t: float = dataclasses.field(
        default_factory=time.perf_counter, compare=False)

    def __post_init__(self):
        if self.kind not in _KIND_TO_OP:
            raise ValueError(f"unknown op kind {self.kind!r}")
        if self.kind != "delete" and self.vector is None:
            raise ValueError(f"{self.kind} op needs a vector")

    @property
    def opcode(self) -> int:
        return _KIND_TO_OP[self.kind]


class UpdateScheduler:
    """FIFO op queue + drain + tau-triggered backup rebuilds.

    ``apply_fn(index, ops[T], labels[T], X[T, d]) -> index`` can be
    injected; the default is the wave (or sequential) executor, updating
    the index in place. Levels and slot-reuse cursors come from the
    scheduler's own ``generator`` (a CPU generator seeded with 0), so a
    drained stream is reproducible.
    """

    def __init__(self, params: HNSWParams, dim: int,
                 variant: str = "mn_ru_gamma", max_ops_per_drain: int = 128,
                 tau: int = 0, backup_params: HNSWParams | None = None,
                 backup_capacity: int = 0,
                 metrics: MetricsRegistry | None = None,
                 apply_fn: Callable | None = None,
                 execution: str = "wave"):
        if max_ops_per_drain < 1:
            raise ValueError("max_ops_per_drain must be >= 1")
        # fail at construction, not at the first drain — one registry
        # lookup is THE validation (uniform error message)
        get_strategy(variant)
        get_executor(execution)
        self._normalize = get_metric(params.space).normalize_ingest
        self.params = params
        self.dim = dim
        self.variant = variant
        self.execution = execution
        self.max_ops_per_drain = pow2_floor(max_ops_per_drain)
        self.tau = tau
        self.backup_params = backup_params or params
        self.backup_capacity = backup_capacity
        self.metrics = metrics or MetricsRegistry()
        self.generator = torch.Generator().manual_seed(0)
        self._apply_fn = apply_fn or self._default_apply
        self.last_drain_waves = 0   # wave programs in the latest drain
        self._queue: deque[UpdateOp] = deque()
        self._ru_ops = 0          # replace/insert ops applied (tau counter)
        self._rebuilds = 0

    # -- submission ---------------------------------------------------------
    def submit(self, op: UpdateOp) -> None:
        self._queue.append(op)
        self.metrics.counter("updates_submitted").inc()

    def delete(self, label: int) -> None:
        self.submit(UpdateOp("delete", int(label)))

    def replace(self, vector, label: int) -> None:
        self.submit(UpdateOp("replace", int(label), self._ingest(vector)))

    def insert(self, vector, label: int) -> None:
        self.submit(UpdateOp("insert", int(label), self._ingest(vector)))

    def _ingest(self, vector) -> np.ndarray:
        """Metric-aware ingest: cosine unit-normalises before the core."""
        v = np.asarray(vector, np.float32)
        return normalize_rows(v) if self._normalize else v

    @property
    def backlog(self) -> int:
        return len(self._queue)

    @property
    def applied_ru_ops(self) -> int:
        return self._ru_ops

    @property
    def rebuilds(self) -> int:
        return self._rebuilds

    # -- drain --------------------------------------------------------------
    def _default_apply(self, index: HNSWIndex, ops, labels, X) -> HNSWIndex:
        """Wave path: compile the tape (dedup + wave split) and run the
        plan. Sequential path: one op at a time."""
        if (self.execution == "wave"
                and get_strategy(self.variant).repair_fn is None):
            plan = compile_tape(ops, labels, X, built=int(index.count))
            self.last_drain_waves = plan.num_waves + (
                1 if plan.num_deletes else 0)
            if plan.deduped:
                self.metrics.counter("updates_deduped").inc(plan.deduped)
            return apply_plan(self.params, index, plan, self.variant,
                              generator=self.generator)
        self.last_drain_waves = 0
        return apply_update_batch_sequential(self.params, index, ops, labels,
                                             X, self.variant,
                                             generator=self.generator)

    def drain(self, index: HNSWIndex,
              max_ops: int | None = None) -> tuple[HNSWIndex, int]:
        """Apply up to ``max_ops`` queued ops in FIFO order to ``index``, in
        place; returns ``(index, n_applied)``. The tape is padded with
        OP_NOP to its power-of-two bucket."""
        limit = min(max_ops if max_ops is not None else self.max_ops_per_drain,
                    self.max_ops_per_drain)
        take = min(len(self._queue), limit)
        if take == 0:
            return index, 0
        batch = [self._queue.popleft() for _ in range(take)]

        b = bucket_size(take, self.max_ops_per_drain)
        ops = np.full((b,), OP_NOP, np.int32)
        labels = np.full((b,), -1, np.int32)
        X = np.zeros((b, self.dim), np.float32)
        now = time.perf_counter()
        for i, op in enumerate(batch):
            ops[i] = op.opcode
            labels[i] = op.label
            if op.vector is not None:
                X[i] = op.vector
            self.metrics.histogram("update_queue_wait_ms").observe(
                (now - op.enqueued_t) * 1e3)

        t0 = time.perf_counter()
        with spans.span("scheduler.drain", ops=take) as sp:
            index = self._apply_fn(index, ops, labels, X)
            sp.set(waves=self.last_drain_waves)
        self.metrics.histogram("drain_latency_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        self._ru_ops += sum(1 for op in batch if op.kind != "delete")
        self.metrics.counter("updates_applied").inc(take)
        self.metrics.counter("update_drains").inc()
        self.metrics.histogram("waves_per_drain").observe(
            self.last_drain_waves)
        return index, take

    # -- maintenance --------------------------------------------------------
    @property
    def rebuild_due(self) -> bool:
        return (self.tau > 0 and self.backup_capacity > 0
                and self._ru_ops // self.tau > self._rebuilds)

    def maybe_rebuild(self, index: HNSWIndex) -> HNSWIndex | None:
        """Tau-triggered backup rebuild over current unreachable points.

        Returns the fresh backup index (a new index; ``index`` is only
        read), or None when not due. Called from the engine's maintenance
        cycle so it never blocks a write submission. The rebuild is the
        span ``backup.rebuild`` (``capacity``; ``points``, the backup's
        count), with ``backup.sweep`` inside it.
        """
        if not self.rebuild_due:
            return None
        t0 = time.perf_counter()
        with spans.span("backup.rebuild",
                        capacity=self.backup_capacity) as sp:
            backup = rebuild_backup(self.backup_params, index,
                                    self.backup_capacity, self._rebuilds + 1)
            sp.set(points=int(backup.count))    # waits for the device
        # one drain can cross several tau thresholds — catch the counter up
        # so idle pumps don't rebuild the identical index again
        self._rebuilds = self._ru_ops // self.tau
        self.metrics.counter("backup_rebuilds").inc()
        self.metrics.histogram("rebuild_latency_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        return backup
