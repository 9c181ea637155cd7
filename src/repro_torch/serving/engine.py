"""ServingEngine: micro-batched queries over epoch snapshots + batched writes.

One object ties the serving substrate together:

  * reads  — :class:`MicroBatcher` coalesces single queries and serves them
             against the published :class:`EpochSnapshot`; each dispatched
             bucket is routed by the query planner (``mode="auto"``): HNSW
             beam search — dualSearch when a backup index is enabled — or
             the exact scan tier on the ``topk_dist`` kernel when the
             snapshot is small or churn-heavy (``mode=`` pins a tier);
  * writes — :class:`UpdateScheduler` queues delete/replace/insert ops and
             drains the backlog into the back buffer in one call
             (``execution="wave"`` by default; ``waves_per_pump`` counts the
             waves it ran);
  * maintenance — tau-triggered backup rebuilds over unreachable points,
             plus (with ``maintenance=MaintenancePolicy(...)``) health-driven
             delete consolidation and unreachable-point repair; the passes
             run on the back buffer and swap in as a new epoch, which also
             re-keys the batcher's planner stats;
  * publication — ``SnapshotStore.publish()`` swaps the back buffer in,
             bumping the epoch.

The event loop is ONE deterministic method, :meth:`pump`:

    serve pending queries (old snapshot) -> drain updates -> maybe rebuild
    backup -> maybe maintain -> publish new snapshot

Queries submitted before a pump are served against the pre-pump epoch,
never a half-applied write batch. Writes land on the store's writable back
buffer (a clone of the published index, see ``snapshot.py``), so a
published snapshot never changes under a reader.

Sharded mode: pass ``mesh=`` (a list of devices, e.g.
``launch.mesh.make_local_mesh()``) and a :class:`~repro_torch.core.
distributed.ShardedIndex` from ``build_sharded``; the engine places the
shards on the devices, pins the graph tier, and reroutes queries through
``sharded_batch_knn`` (one stable merge per batch) and updates through
``sharded_update`` (one op at a time, on its owner shard). Backup/dualSearch,
the exact tier and maintenance are single-index only, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time

from ..core import spans
from ..core.backup import empty_backup
from ..core.distributed import (ShardedIndex, shard_index,
                                sharded_batch_knn, sharded_update)
from ..core.index import HNSWIndex, HNSWParams
from ..core.maintenance import (MaintenancePolicy, index_health,
                                run_maintenance)
from ..core.reach import count_unreachable
from ..core.update import OP_DELETE, OP_INSERT, OP_NOP

from .batcher import MicroBatcher, QueryTicket
from .metrics import MetricsRegistry
from .snapshot import EpochSnapshot, SnapshotStore
from .update_queue import UpdateOp, UpdateScheduler


@dataclasses.dataclass(frozen=True)
class PumpStats:
    """What one deterministic event-loop step did."""
    epoch: int
    queries_served: int
    updates_applied: int
    backup_rebuilt: bool
    update_backlog: int
    maintenance_ran: bool = False
    waves_per_pump: int = 0    # waves the drain ran (0 when nothing
                               # drained or execution="sequential")


class ServingEngine:
    """The serving engine over one index (on the index's device), or over a
    :class:`ShardedIndex` placed on ``mesh``."""

    def __init__(self, params: HNSWParams, index: HNSWIndex | ShardedIndex,
                 *, k: int = 10, ef: int | None = None,
                 variant: str = "mn_ru_gamma",
                 max_batch: int = 64, max_ops_per_drain: int = 128,
                 tau: int = 0, backup_capacity: int = 0,
                 backup_params: HNSWParams | None = None, mesh=None,
                 track_unreachable: bool = False, mode: str = "auto",
                 planner=None, maintenance: MaintenancePolicy | None = None,
                 maintain_every: int = 1, execution: str = "wave",
                 metrics: MetricsRegistry | None = None):
        sharded = mesh is not None
        use_backup = tau > 0 and backup_capacity > 0
        if sharded:
            if not isinstance(index, ShardedIndex):
                raise TypeError(
                    "ServingEngine(mesh=...) serves a ShardedIndex (build "
                    "one with core.distributed.build_sharded), got "
                    f"{type(index).__name__}")
            if mode == "exact":
                raise ValueError("the exact scan tier is not supported in "
                                 "sharded mode yet — use mode='auto' or "
                                 "'graph' (auto pins the graph tier)")
            if use_backup:
                raise ValueError("backup/dualSearch is not supported in "
                                 "sharded mode yet — drop tau/backup_capacity")
            if maintenance is not None:
                raise ValueError("maintenance policies are not supported in "
                                 "sharded mode yet — drop maintenance=")
            index = shard_index(index, mesh)
        if maintain_every < 1:
            raise ValueError("maintain_every must be >= 1")
        self.params = params
        self.k = k
        self.ef = ef
        self.variant = variant
        self.execution = execution
        self.mesh = mesh
        self.track_unreachable = track_unreachable
        self.maintenance = maintenance
        # cadence is in PUMPS here; the policy's check_every stays an
        # op-count knob for the facade's mutation path
        self.maintain_every = maintain_every
        self._pumps_since_maintenance = 0
        self._last_health = None     # health of the staged index, when fresh
        self._dirty_since_consult = True   # writes since the last consult
        self.metrics = metrics or MetricsRegistry()
        self.dim = index.dim

        backup = None
        if use_backup:
            backup = empty_backup(backup_params or params, backup_capacity,
                                  self.dim, dtype=index.vectors.dtype,
                                  device=index.device)
        self.store = SnapshotStore(index, backup)
        # sharded mode pins the graph tier, as the reference does
        self.batcher = MicroBatcher(
            params, k, ef, max_batch, metrics=self.metrics,
            search_fn=self._sharded_search if sharded else None,
            backup_params=backup_params, mode="graph" if sharded else mode,
            planner=planner)
        self.scheduler = UpdateScheduler(
            params, self.dim, variant, max_ops_per_drain, tau=tau,
            backup_params=backup_params, backup_capacity=backup_capacity,
            metrics=self.metrics, execution=execution,
            apply_fn=self._sharded_apply if sharded else None)

    # -- sharded routing ----------------------------------------------------
    def _sharded_search(self, snapshot: EpochSnapshot, Q, rows: int):
        return sharded_batch_knn(self.params, snapshot.index, Q, self.k,
                                 self.ef)

    def _sharded_apply(self, index: ShardedIndex, ops, labels, X):
        """Route each tape op to its owning shard, one op at a time (as the
        reference does), with the scheduler's draws."""
        for i, op in enumerate(ops.tolist()):
            if op == OP_NOP:
                continue
            label = int(labels[i])
            dl, nl = (label, -1) if op == OP_DELETE else (-1, label)
            index = sharded_update(self.params, index, dl, X[i], nl,
                                   self.variant, fresh_insert=op == OP_INSERT,
                                   generator=self.scheduler.generator)
        return index

    # -- client API ---------------------------------------------------------
    def search(self, q) -> QueryTicket:
        """Enqueue one query; served at the next ``pump()``."""
        return self.batcher.submit(q)

    def delete(self, label: int) -> None:
        self.scheduler.delete(label)

    def update(self, vector, label: int) -> None:
        """replaced_update: new point reuses a deleted slot (paper Alg. 2+3)."""
        self.scheduler.replace(vector, label)

    def insert(self, vector, label: int) -> None:
        self.scheduler.insert(vector, label)

    def submit_update(self, op: UpdateOp) -> None:
        self.scheduler.submit(op)

    @property
    def epoch(self) -> int:
        return self.store.epoch

    @property
    def update_backlog(self) -> int:
        return self.scheduler.backlog

    @property
    def query_backlog(self) -> int:
        return self.batcher.pending

    def snapshot(self) -> EpochSnapshot:
        return self.store.current()

    # -- the event loop -----------------------------------------------------
    def pump(self, max_updates: int | None = None) -> PumpStats:
        """One deterministic serve/maintain/publish step (the span
        ``engine.pump``, with ``batcher.flush``, ``scheduler.drain``,
        ``engine.maintain`` and ``engine.publish`` inside it)."""
        with spans.use(self.metrics), self.metrics.span("engine.pump"):
            return self._pump(max_updates)

    def _pump(self, max_updates: int | None) -> PumpStats:
        t0 = time.perf_counter()
        snap = self.store.current()

        served = self.batcher.flush(snap)

        applied = 0
        if self.scheduler.backlog and max_updates != 0:
            new_index, applied = self.scheduler.drain(
                self.store.writable_index(), max_updates)
            self.store.stage(index=new_index)
        waves = self.scheduler.last_drain_waves if applied else 0

        backup = self.scheduler.maybe_rebuild(self.store.working_index())
        rebuilt = backup is not None
        if rebuilt:
            self.store.stage(backup=backup)

        if applied:                    # main-index writes age the health
            self._dirty_since_consult = True
            self._last_health = None
        with spans.span("engine.maintain"):
            maintained = self._maybe_maintain()

        with spans.span("engine.publish"):
            out = self.store.publish()

        self.metrics.counter("pumps").inc()
        self.metrics.set_gauge("epoch", out.epoch)
        self.metrics.set_gauge("waves_per_pump", waves)
        self.metrics.set_gauge("update_lag_ops", self.scheduler.backlog)
        self.metrics.histogram("pump_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        if self.track_unreachable and out.epoch != snap.epoch:
            if self.mesh is not None:
                u_ind, u_bfs = self._sharded_count_unreachable(out.index)
            elif self._last_health is not None:
                # the maintenance consult already swept this exact index
                u_ind = int(self._last_health.unreachable_def1)
                u_bfs = int(self._last_health.unreachable_bfs)
            else:
                u_ind, u_bfs = count_unreachable(out.index)
            self.metrics.set_gauge("unreachable_indegree", u_ind)
            self.metrics.set_gauge("unreachable_bfs", u_bfs)
            self.metrics.histogram("unreachable_per_epoch").observe(u_ind)
        return PumpStats(epoch=out.epoch, queries_served=len(served),
                         updates_applied=applied, backup_rebuilt=rebuilt,
                         update_backlog=self.scheduler.backlog,
                         maintenance_ran=maintained, waves_per_pump=waves)

    @staticmethod
    def _sharded_count_unreachable(sharded: ShardedIndex) -> tuple[int, int]:
        """Per-shard reachability sweeps summed into the global gauges (each
        shard is its own sub-graph, and ``label % nshards`` ownership means
        no point is counted twice)."""
        counts = [count_unreachable(ix) for ix in sharded.shards]
        return sum(c[0] for c in counts), sum(c[1] for c in counts)

    def _maybe_maintain(self) -> bool:
        """Policy-gated consolidation/repair on the back buffer.

        Runs between the drain and the publish: the working index is
        consolidated/repaired off-snapshot (on the writable clone) and
        staged, so readers only ever see the result as a whole new epoch.
        The batcher's per-epoch planner stats are invalidated explicitly as
        well, so the very next bucket re-consults ``choose_tier``.
        """
        if self.maintenance is None:
            self._last_health = None
            return False
        self._pumps_since_maintenance += 1
        if self._pumps_since_maintenance < self.maintain_every:
            return False
        if not self._dirty_since_consult:
            # no writes since the last consult: the health of an unchanged
            # index is unchanged — idle pumps skip the reachability sweep
            return False
        self._pumps_since_maintenance = 0
        t0 = time.perf_counter()
        h = index_health(self.store.working_index())
        ran = False
        if self.maintenance.due(h):    # clone the published index only then
            index, report = run_maintenance(
                self.params, self.store.writable_index(), self.maintenance,
                health=h)
            ran = report["consolidated"] or report["repair_passes"] > 0
        if not ran:
            # nothing ran: h still describes the index about to publish —
            # keep it so the unreachable gauges can reuse the sweep
            self._last_health = h
            self._dirty_since_consult = False
            return False
        # maintenance rewrote the index: the next consult must re-sweep
        self._last_health = None
        self._dirty_since_consult = True
        self.store.stage(index=index)
        self.batcher.invalidate_stats()
        if report["consolidated"]:
            self.metrics.counter("maintenance_consolidations").inc()
            self.metrics.counter("maintenance_slots_reclaimed").inc(
                report["reclaimed"])
        self.metrics.counter("maintenance_repair_passes").inc(
            report["repair_passes"])
        self.metrics.set_gauge("maintenance_unreachable_def1",
                               report["unreachable_def1"])
        self.metrics.histogram("maintenance_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        return True

    def drain_all(self, max_pumps: int = 1_000) -> list[PumpStats]:
        """Pump until both queues are empty (or ``max_pumps``)."""
        stats = []
        for _ in range(max_pumps):
            stats.append(self.pump())
            if self.update_backlog == 0 and self.query_backlog == 0:
                break
        return stats

    def stats(self) -> dict:
        return self.metrics.to_dict()
