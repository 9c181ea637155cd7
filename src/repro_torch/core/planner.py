"""Query execution planner: route each kNN batch to the right tier.

  * **graph** — the HNSW beam search (:func:`~repro_torch.core.search.
    batch_knn`): sublinear in N, but its expansions are wasted on
    mark-deleted points under heavy churn, and a very selective filter
    starves the result beam;
  * **exact** — a brute-force scan over the slot array on the streaming
    ``topk_dist`` CUDA kernel: linear in N, recall-exact by construction,
    and the deleted/allow mask rides inside the running top-k.

The planner decides per batch from three cheap index statistics (tiny
index, churn-heavy, very selective filter).
"""
from __future__ import annotations

import dataclasses

import torch

from .common import INF, INVALID
from .index import HNSWIndex, HNSWParams
from .metrics import dist_pairwise, get_metric
from .search import batch_knn


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """Tier-selection thresholds (the reference's defaults)."""
    small_live: int = 2048        # live count at/below which exact scan wins
    deleted_frac: float = 0.5     # mark-deleted fraction at/above which the
                                  # beam wastes most expansions on dead slots
    selectivity: float = 0.05     # allowed/live fraction at/below which a
                                  # filtered beam starves


DEFAULT_PLANNER = PlannerConfig()

#: the valid ``mode=`` values everywhere a tier can be requested
MODES = ("auto", "graph", "exact")


@dataclasses.dataclass(frozen=True)
class IndexStats:
    """Cheap per-snapshot statistics the planner decides from."""
    capacity: int                 # slot-array length N
    allocated: int                # slots with levels >= 0 (live + deleted)
    live: int                     # allocated and not mark-deleted
    allowed: int | None = None    # live slots passing the filter

    @property
    def deleted_frac(self) -> float:
        """Mark-deleted fraction of allocated slots (0 when empty)."""
        return (self.allocated - self.live) / max(self.allocated, 1)

    @property
    def selectivity(self) -> float:
        """Fraction of live slots the filter allows (1.0 when no filter)."""
        if self.allowed is None:
            return 1.0
        return self.allowed / max(self.live, 1)


def index_stats(index: HNSWIndex,
                allow: torch.Tensor | None = None) -> IndexStats:
    """Gather :class:`IndexStats` (two or three O(N) reductions)."""
    alloc = index.levels >= 0
    live_mask = alloc & ~index.deleted
    allowed = None
    if allow is not None:
        allowed = int(torch.sum(live_mask & allow))
    return IndexStats(capacity=index.capacity, allocated=int(alloc.sum()),
                      live=int(live_mask.sum()), allowed=allowed)


@dataclasses.dataclass(frozen=True)
class PlanDecision:
    """One routing decision: which tier and why."""
    tier: str                     # "graph" | "exact"
    reason: str                   # human-readable trigger
    stats: IndexStats

    def __str__(self) -> str:
        return f"{self.tier} ({self.reason})"


def choose_tier(stats: IndexStats,
                config: PlannerConfig = DEFAULT_PLANNER) -> PlanDecision:
    """Pick the execution tier for one batch from index statistics."""
    if stats.live <= config.small_live:
        return PlanDecision("exact", f"live {stats.live} <= small_live "
                                     f"{config.small_live}", stats)
    if stats.deleted_frac >= config.deleted_frac:
        return PlanDecision("exact", f"deleted_frac {stats.deleted_frac:.2f}"
                                     f" >= {config.deleted_frac}", stats)
    if stats.selectivity <= config.selectivity:
        return PlanDecision("exact", f"selectivity {stats.selectivity:.3f}"
                                     f" <= {config.selectivity}", stats)
    return PlanDecision("graph", "no exact-tier trigger", stats)


def exact_scan(params: HNSWParams, index: HNSWIndex, Q: torch.Tensor, k: int,
               allow: torch.Tensor | None = None):
    """Exact k-NN over the slot array (the planner's exact tier).

    Same contract as :func:`~repro_torch.core.search.batch_knn`:
    ``Q[b, d] -> (labels[b, k], slot_ids[b, k], dists[b, k])``, padded with
    ``(-1, -1, inf)``. Free, mark-deleted and disallowed slots are excluded
    inside the top-k. Spaces with a ``kernel_form`` run ``topk_dist``
    (the CUDA kernel for CUDA tensors); others a dense ``pairwise_fn``.
    """
    from ..kernels.topk_dist import topk_dist

    eligible = (index.levels >= 0) & ~index.deleted
    if allow is not None:
        eligible = eligible & allow
    form = get_metric(params.space).kernel_form
    if form is not None:
        dists, ids = topk_dist(Q, index.vectors, k, metric=form,
                               mask=eligible)
    else:
        D = dist_pairwise(params.space, Q, index.vectors)
        D = torch.where(eligible[None, :], D, INF)
        srt = torch.sort(D, dim=1, stable=True)
        dists = srt.values[:, :k]
        ids = torch.where(torch.isinf(dists), INVALID, srt.indices[:, :k])
    ids = ids.long()
    labels = torch.where(ids >= 0, index.labels[ids.clamp_min(0)].long(),
                         INVALID)
    return labels.int(), ids.int(), dists


def plan_and_search(params: HNSWParams, index: HNSWIndex, Q: torch.Tensor,
                    k: int, ef: int | None = None,
                    allow: torch.Tensor | None = None, mode: str = "auto",
                    config: PlannerConfig = DEFAULT_PLANNER,
                    stats: IndexStats | None = None):
    """Route one query batch: returns ``(labels, ids, dists, decision)``.

    ``mode`` is the escape hatch: ``"auto"`` consults :func:`choose_tier`,
    ``"graph"`` / ``"exact"`` force a tier. ``stats`` reuses cached stats.
    """
    if mode not in MODES:
        raise ValueError(f"unknown query mode {mode!r}; expected one "
                         f"of {MODES}")
    if mode == "auto":
        decision = choose_tier(stats if stats is not None
                               else index_stats(index, allow), config)
    else:
        s = stats if stats is not None else IndexStats(
            index.capacity, allocated=-1, live=-1)
        decision = PlanDecision(mode, f"forced by mode={mode!r}", s)
    if decision.tier == "exact":
        labels, ids, dists = exact_scan(params, index, Q, k, allow)
    else:
        labels, ids, dists = batch_knn(params, index, Q, k, ef, allow)
    return labels, ids, dists, decision
