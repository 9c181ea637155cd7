"""`VectorIndex`: the hnswlib-class facade over the port's MN-RU core.

One object is the public surface for everything the port can do to a
vector index — build, batched queries on the planner-routed tiers, the
metric and update-strategy registries, capacity growth, maintenance,
persistence and the serving engine:

    from repro_torch import api

    vi = api.create(space="cosine", dim=64, capacity=1000)   # on "cuda"
    vi.add_items(X, labels)                       # grows past capacity
    labels, dists = vi.knn_query(Q, k=10, ef=64)  # planner-routed (auto)
    labels, dists = vi.knn_query(Q, k=10, mode="exact")  # topk_dist tier
    labels, dists = vi.knn_query(Q, k=10, filter=allowed_labels)
    vi.mark_deleted(stale_labels)
    vi.replace_items(fresh_X, fresh_labels)       # paper Alg. 2+3 repair
    vi.health(); vi.consolidate(); vi.repair_unreachable()
    vi.save("index.npz"); vi = api.VectorIndex.load("index.npz")
    engine = vi.serve(k=10, tau=400, backup_capacity=256)

Design notes:

  * capacities are powers of two — construction rounds up, ``add_items``
    past capacity repacks into the next one (``resize_index``);
  * mutations ride one op tape through the wave executor; strategies with
    a custom ``repair_fn`` take the sequential executor in pow2 chunks;
    bulk ``add_items`` on an empty index goes to ``build``;
  * ``cosine`` unit-normalises vectors AND queries at ingest;
  * updates work in place on ``.index``; ``serve()`` hands the engine a
    clone, so later facade mutations do not reach a live engine;
  * draws (levels, slot-reuse cursors) come from the facade's own
    ``torch.Generator``, seeded with ``seed``; the npz file carries the
    reference's ``rng`` key unchanged, so files cross between the packages.
"""
from __future__ import annotations

import dataclasses
import functools
import json

import numpy as np
import torch

from ..core import spans
from ..core.common import pow2_at_least, resolve_device
from ..core.hnsw import build
from ..core.index import (HNSWIndex, HNSWParams, empty_index, from_arrays,
                          resize_index, to_arrays)
from ..core.maintenance import (IndexHealth, MaintenancePolicy,
                                consolidate_deletes, index_health,
                                rebuild_index, run_maintenance)
from ..core.maintenance import repair_unreachable as _repair_unreachable
from ..core.metrics import get_metric, normalize_rows
from ..core.planner import (DEFAULT_PLANNER, PlanDecision, PlannerConfig,
                            choose_tier, index_stats, plan_and_search)
from ..core.reach import count_unreachable
from ..core.strategies import get_strategy
from ..core.update import (OP_DELETE, OP_INSERT, OP_NOP, OP_REPLACE,
                           apply_update_batch, num_deleted)
from ..serving.metrics import MetricsRegistry

_SAVE_VERSION = 1
_MAX_TAPE = 128          # sequential-route tape chunk (pow2)


def _recorded(method):
    """Run a facade method with the index's registry current, so the
    core's spans land in ``self.metrics``."""
    @functools.wraps(method)
    def call(self, *args, **kwargs):
        with spans.use(self.metrics):
            return method(self, *args, **kwargs)
    return call


class VectorIndex:
    """A metric-space vector database over one HNSW index.

    Constructor arguments mirror hnswlib's ``Index(space, dim)`` +
    ``init_index``; :func:`create` is the one-call convenience wrapper.
    ``device`` (default ``"cuda"``) is where the index lives. ``metrics``
    records the spans of the facade's calls and of the core below them;
    an engine from ``serve()`` keeps a registry of its own.
    """

    def __init__(self, space: str = "l2", dim: int = 0, capacity: int = 1024,
                 M: int = 8, M0: int | None = None, num_layers: int = 4,
                 ef_construction: int = 64, ef_search: int = 32,
                 alpha: float = 1.0, strategy: str = "mn_ru_gamma",
                 seed: int = 0, dtype=torch.float32,
                 planner: PlannerConfig | None = None,
                 maintenance: MaintenancePolicy | None = None,
                 device="cuda", _index: HNSWIndex | None = None,
                 _next_label: int = 0):
        if dim <= 0:
            raise ValueError(f"dim must be positive, got {dim}")
        self.metric = get_metric(space)          # validates the space
        get_strategy(strategy)                   # fail-fast, uniform error
        self.strategy = strategy
        self.planner = planner if planner is not None else DEFAULT_PLANNER
        self.maintenance = maintenance
        self._ops_since_maintenance = 0
        self.params = HNSWParams(
            M=M, M0=M0 if M0 is not None else 2 * M, num_layers=num_layers,
            ef_construction=ef_construction, ef_search=ef_search,
            alpha=alpha, space=space)
        self._seed = seed
        self.generator = torch.Generator().manual_seed(seed)
        self._index = _index if _index is not None else empty_index(
            self.params, pow2_at_least(capacity), dim, seed, dtype=dtype,
            device=resolve_device(device))
        self._next_label = _next_label
        self.metrics = MetricsRegistry()

    # -- introspection ------------------------------------------------------

    @property
    def space(self) -> str:
        return self.params.space

    @property
    def dim(self) -> int:
        return self._index.dim

    @property
    def capacity(self) -> int:
        return self._index.capacity

    @property
    def device(self) -> torch.device:
        return self._index.device

    @property
    def index(self) -> HNSWIndex:
        """The underlying index of tensors (escape hatch to the core)."""
        return self._index

    @property
    def count(self) -> int:
        """Live (queryable) points: allocated and not mark-deleted."""
        return int(((self._index.levels >= 0) & ~self._index.deleted).sum())

    @property
    def deleted_count(self) -> int:
        return num_deleted(self._index)

    def __len__(self) -> int:
        return self.count

    def __repr__(self) -> str:
        return (f"VectorIndex(space={self.space!r}, dim={self.dim}, "
                f"count={self.count}, capacity={self.capacity}, "
                f"strategy={self.strategy!r}, device={str(self.device)!r})")

    def _used_slots(self) -> int:
        """Allocated slots (live + mark-deleted) — what capacity bounds."""
        return int((self._index.levels >= 0).sum())

    # -- ingest helpers -----------------------------------------------------

    def _prep_vectors(self, X) -> np.ndarray:
        if isinstance(X, torch.Tensor):
            X = X.detach().cpu().float().numpy()
        X = np.asarray(X, np.float32)
        if X.ndim == 1:
            X = X[None, :]
        if X.ndim != 2 or X.shape[1] != self.dim:
            raise ValueError(f"expected vectors of shape [n, {self.dim}], "
                             f"got {X.shape}")
        if self.metric.normalize_ingest:
            X = normalize_rows(X)
        return X

    def _prep_labels(self, labels, n: int) -> np.ndarray:
        """Validate labels WITHOUT side effects; callers bump the counter
        via :meth:`_commit_labels` only once the whole call will succeed."""
        if labels is None:
            labels = np.arange(self._next_label, self._next_label + n,
                               dtype=np.int32)
        labels = np.atleast_1d(np.asarray(labels, np.int32))
        if labels.shape != (n,):
            raise ValueError(f"expected {n} labels, got shape {labels.shape}")
        if np.any(labels < 0):
            raise ValueError("labels must be non-negative")
        if len(np.unique(labels)) != n:
            raise ValueError("duplicate labels within one call")
        return labels

    def _commit_labels(self, labels: np.ndarray) -> None:
        self._next_label = max(self._next_label, int(labels.max()) + 1)

    def _host_labels(self) -> tuple[np.ndarray, np.ndarray]:
        """``(labels, allocated)`` of every slot, on the host."""
        return (self._index.labels.cpu().numpy(),
                (self._index.levels >= 0).cpu().numpy())

    def _apply_tape(self, ops: np.ndarray, labels: np.ndarray,
                    X: np.ndarray) -> None:
        """Apply a mixed mutation tape in place.

        The whole tape goes to the wave executor in one call (it dedupes
        labels last-write-wins, applies deletes in one pass and splits the
        rest into conflict-free waves). Strategies with a custom
        ``repair_fn`` can't ride the batched repair; they take the
        sequential executor in chunks of ``_MAX_TAPE``, each padded with
        ``OP_NOP`` to its pow2 bucket, as the reference does.
        """
        if len(ops) == 0:
            return
        if get_strategy(self.strategy).repair_fn is None:
            apply_update_batch(self.params, self._index, ops, labels, X,
                               self.strategy, execution="wave",
                               generator=self.generator)
            return
        for lo in range(0, len(ops), _MAX_TAPE):
            o = ops[lo:lo + _MAX_TAPE]
            l = labels[lo:lo + _MAX_TAPE]
            x = X[lo:lo + _MAX_TAPE]
            b = pow2_at_least(len(o))
            if b > len(o):                       # pad to the pow2 bucket
                o = np.concatenate([o, np.full(b - len(o), OP_NOP, np.int32)])
                l = np.concatenate([l, np.full(b - len(l), -1, np.int32)])
                x = np.concatenate([x, np.zeros((b - len(x), self.dim),
                                                np.float32)])
            apply_update_batch(self.params, self._index, o, l, x,
                               self.strategy, execution="sequential",
                               generator=self.generator)

    def _maybe_maintain(self, n_ops: int) -> None:
        """Policy-gated online maintenance behind the mutation calls: with
        ``maintenance=MaintenancePolicy(...)`` the facade consults
        :func:`~repro_torch.core.maintenance.index_health` every
        ``policy.check_every`` applied ops and runs the due passes."""
        if self.maintenance is None:
            return
        self._ops_since_maintenance += n_ops
        if self._ops_since_maintenance < self.maintenance.check_every:
            return
        self._ops_since_maintenance = 0
        run_maintenance(self.params, self._index, self.maintenance)

    # -- writes -------------------------------------------------------------

    @_recorded
    def add_items(self, X, labels=None) -> np.ndarray:
        """Insert new points; auto-grows past capacity. Returns the labels.

        ``labels`` defaults to an auto-incrementing counter. Labels must be
        fresh — use :meth:`replace_items` to overwrite an existing label.
        """
        with spans.span("index.add_items"):
            return self._add_items(X, labels)

    def _add_items(self, X, labels) -> np.ndarray:
        X = self._prep_vectors(X)
        n = X.shape[0]
        if n == 0:
            return np.empty((0,), np.int32)
        labels = self._prep_labels(labels, n)

        idx_labels, alloc = self._host_labels()
        clash = np.intersect1d(labels, idx_labels[alloc])
        if clash.size:
            raise ValueError(
                f"labels already present: {clash[:8].tolist()}"
                f"{'...' if clash.size > 8 else ''} — use replace_items()")

        used = int(alloc.sum())
        if used + n > self.capacity:
            self.grow(used + n)

        if used == 0:
            # bulk path: one build (waves from WAVE_BUILD_MIN_N points) over
            # the vectors cast to the index's dtype, as the reference does
            self._index = build(self.params, torch.from_numpy(X).to(
                                    self._index.vectors.dtype), labels,
                                seed=self._seed, capacity=self.capacity,
                                generator=self.generator, device=self.device)
        else:
            self._apply_tape(np.full(n, OP_INSERT, np.int32), labels, X)
        self._commit_labels(labels)
        self._maybe_maintain(n)
        return labels

    @_recorded
    def mark_deleted(self, labels) -> None:
        """markDelete: flag points; they stay traversable until replaced
        (or until maintenance consolidates them away)."""
        labels = np.atleast_1d(np.asarray(labels, np.int32))
        self._apply_tape(np.full(len(labels), OP_DELETE, np.int32), labels,
                         np.zeros((len(labels), self.dim), np.float32))
        self._maybe_maintain(len(labels))

    @_recorded
    def replace_items(self, X, labels) -> np.ndarray:
        """replaced_update (paper Alg. 2+3): each point reuses a deleted slot
        with strategy-driven neighbourhood repair, falling back to a fresh
        insert when no deleted slot exists. Auto-grows if the fallback would
        run out of free slots.

        Upsert semantics: a label that is already present (live OR pending
        deletion) is overwritten — its old slot is marked deleted and
        un-labelled first, so every label maps to at most one allocated
        slot."""
        X = self._prep_vectors(X)
        n = X.shape[0]
        if n == 0:
            return np.empty((0,), np.int32)
        labels = self._prep_labels(labels, n)

        idx_labels, alloc = self._host_labels()
        clash = alloc & np.isin(idx_labels, labels)
        if clash.any():
            slots = torch.from_numpy(np.nonzero(clash)[0]).to(self.device)
            self._index.labels[slots] = -1
            self._index.deleted[slots] = True

        free = self.capacity - self._used_slots()
        fallback_inserts = max(0, n - self.deleted_count)
        if fallback_inserts > free:
            self.grow(self._used_slots() + fallback_inserts)
        self._apply_tape(np.full(n, OP_REPLACE, np.int32), labels, X)
        self._commit_labels(labels)
        self._maybe_maintain(n)
        return labels

    # -- capacity -----------------------------------------------------------

    def grow(self, min_capacity: int | None = None) -> int:
        """Repack into the next pow2 capacity ≥ ``min_capacity`` (default:
        double). Slot ids, the graph, and all labels are preserved. Returns
        the new capacity."""
        target = 2 * self.capacity if min_capacity is None else min_capacity
        new_cap = max(pow2_at_least(target), self.capacity)
        self._index = resize_index(self._index, new_cap)
        return self.capacity

    @_recorded
    def compact(self, capacity: int | None = None) -> int:
        """Full blocking rebuild over live points only
        (:func:`~repro_torch.core.maintenance.rebuild_index`); the capacity
        defaults to the current one and may shrink as long as the live set
        fits. Returns the new capacity. For routine online reclamation
        prefer :meth:`consolidate`."""
        self._index = rebuild_index(self.params, self._index,
                                    capacity=capacity, seed=self._seed,
                                    generator=self.generator)
        return self.capacity

    # -- maintenance --------------------------------------------------------

    @_recorded
    def health(self) -> IndexHealth:
        """The :class:`~repro_torch.core.maintenance.IndexHealth` report;
        ``health().asdict()`` gives plain python scalars."""
        return index_health(self._index)

    @_recorded
    def consolidate(self) -> int:
        """Batched delete consolidation
        (:func:`~repro_torch.core.maintenance.consolidate_deletes`): repair
        every neighbourhood that points into the mark-deleted set, then
        reclaim the deleted slots as free capacity. Returns the number of
        slots reclaimed."""
        reclaimed = self.deleted_count
        consolidate_deletes(self.params, self._index)
        return reclaimed

    @_recorded
    def repair_unreachable(self, max_passes: int = 3) -> int:
        """Re-link unreachable live points, re-checking between sweeps,
        until the paper's Definition-1 count hits zero or ``max_passes``
        is exhausted. Returns the remaining Definition-1 count."""
        for _ in range(max_passes):
            if count_unreachable(self._index)[0] == 0:
                return 0
            _repair_unreachable(self.params, self._index)
        return count_unreachable(self._index)[0]

    # -- reads --------------------------------------------------------------

    def _filter_to_slot_mask(self, filter) -> np.ndarray:
        idx_labels, alloc = self._host_labels()
        live = alloc & ~self._index.deleted.cpu().numpy()
        if callable(filter):
            allow = np.zeros(self.capacity, bool)
            lv = np.nonzero(live)[0]
            allow[lv] = [bool(filter(int(l))) for l in idx_labels[lv]]
        else:
            allowed = np.atleast_1d(np.asarray(filter)).astype(np.int64)
            allow = live & np.isin(idx_labels, allowed)
        return allow

    @_recorded
    def knn_query(self, Q, k: int = 10, ef: int | None = None,
                  filter=None, mode: str = "auto"
                  ) -> tuple[np.ndarray, np.ndarray]:
        """Batched k-NN: ``Q[b, d] -> (labels[b, k], dists[b, k])``.

        ``mode`` picks the execution tier: ``"auto"`` (default) lets the
        planner route the batch, ``"graph"`` / ``"exact"`` force the HNSW
        beam search or the exact scan on the ``topk_dist`` kernel.
        ``filter`` restricts results to a label predicate — an array of
        allowed labels or a ``label -> bool`` callable — applied inside the
        beam search or the kernel's running top-k. Distances are in the
        index's metric; missing results pad with label -1 / dist inf.

        Its span, ``index.knn_query``, carries the planner's decision
        (``tier``, ``reason``) and ``allowed`` (the slots the filter
        allows; -1 without a filter).
        """
        with spans.span("index.knn_query", k=k) as sp:
            Q = self._prep_vectors(Q)
            ef = max(ef if ef is not None else self.params.ef_search, k)
            allow = None
            n_allowed = -1
            if filter is not None:
                with spans.span("index.filter_mask"):
                    mask = self._filter_to_slot_mask(filter)
                # selective predicates thin the result beam — widen ef by
                # the inverse selectivity (pow2, capped at 4x)
                n_allowed = int(mask.sum())
                boost = pow2_at_least(-(-self.capacity // max(n_allowed, 1)))
                ef = min(ef * min(boost, 4), pow2_at_least(self.capacity))
                allow = torch.from_numpy(mask).to(self.device)
            labels, _, dists, decision = plan_and_search(
                self.params, self._index,
                torch.from_numpy(Q).to(self.device), k, ef, allow, mode=mode,
                config=self.planner)
            sp.set(q=Q.shape[0], ef=ef, tier=decision.tier,
                   reason=decision.reason, allowed=n_allowed)
            return labels.cpu().numpy(), dists.cpu().numpy()

    def plan(self, filter=None) -> PlanDecision:
        """Explain what ``knn_query(mode="auto")`` would do right now."""
        allow = None
        if filter is not None:
            allow = torch.from_numpy(
                self._filter_to_slot_mask(filter)).to(self.device)
        return choose_tier(index_stats(self._index, allow), self.planner)

    # -- persistence --------------------------------------------------------

    def save(self, path: str) -> None:
        """One-file npz snapshot: arrays + json meta (params, strategy), in
        the reference's layout, so either package loads it."""
        meta = {
            "version": _SAVE_VERSION,
            "params": dataclasses.asdict(self.params),
            "strategy": self.strategy,
            "next_label": int(self._next_label),
        }
        np.savez_compressed(path, meta=np.bytes_(json.dumps(meta).encode()),
                            **to_arrays(self._index))

    @classmethod
    def load(cls, path: str, device="cuda") -> "VectorIndex":
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            if meta.get("version") != _SAVE_VERSION:
                raise ValueError(f"unsupported save version "
                                 f"{meta.get('version')!r} in {path}")
            index = from_arrays(z, device=device)
        p = meta["params"]
        return cls(space=p["space"], dim=index.dim, M=p["M"], M0=p["M0"],
                   num_layers=p["num_layers"],
                   ef_construction=p["ef_construction"],
                   ef_search=p["ef_search"], alpha=p["alpha"],
                   strategy=meta["strategy"], device=index.device,
                   _index=index, _next_label=meta["next_label"])

    # -- serving ------------------------------------------------------------

    def serve(self, **engine_kwargs):
        """Hand a copy of the current index to a :class:`ServingEngine`.

        The engine owns the copy (``index.clone()``) and drains its own
        update queue; later facade mutations do not flow into it. It
        inherits this index's metric space, update strategy (unless
        ``variant=``), planner config (unless ``planner=``) and maintenance
        policy (unless ``maintenance=``; never with ``mesh=``, where the
        sharded engine takes no maintenance). A facade holds one graph, so
        ``mesh=`` reaches the engine's ``TypeError``: serve a sharded index
        with ``ServingEngine(params, build_sharded(...), mesh=...)``.
        """
        from ..serving import ServingEngine
        engine_kwargs.setdefault("variant", self.strategy)
        engine_kwargs.setdefault("planner", self.planner)
        if engine_kwargs.get("mesh") is None:
            engine_kwargs.setdefault("maintenance", self.maintenance)
        return ServingEngine(self.params, self._index.clone(),
                             **engine_kwargs)


def create(space: str = "l2", dim: int = 0, capacity: int = 1024,
           M: int = 8, ef_construction: int = 64,
           strategy: str = "mn_ru_gamma", **kwargs) -> VectorIndex:
    """One-call constructor; extra kwargs (``device=`` among them) pass
    through to :class:`VectorIndex`."""
    return VectorIndex(space=space, dim=dim, capacity=capacity, M=M,
                       ef_construction=ef_construction, strategy=strategy,
                       **kwargs)
