"""Online index maintenance: consolidation, unreachable repair, health.

The paper diagnoses two failure modes of HNSW under real-time updates —
performance degradation as mark-deleted slots accumulate, and unreachable
points (Definition 1) left behind by neighbourhood churn. This module fixes
both online:

  * :func:`consolidate_deletes` — FreshDiskANN-style batched delete
    consolidation: every live vertex with an edge into a mark-deleted slot
    re-prunes from its ``N(v) ∪ ⋃ N(d)`` candidate pool, then the deleted
    slots are cleared (``levels = -1``) and become free capacity;
  * :func:`repair_unreachable` — re-link every unreachable live point
    (Definition 1 ∪ BFS), one at a time in slot order, through the
    layer-inheriting reinsert, with a forced reverse edge as the
    connectivity backstop;
  * :func:`index_health` — an :class:`IndexHealth` report (live / deleted /
    unreachable counts, in-degree histogram) that :class:`MaintenancePolicy`
    consumes to decide when the passes run;
  * :func:`rebuild_index` — the full rebuild over live points, the escape
    hatch behind ``VectorIndex.compact()``.

Like the rest of the port, the passes update the index in place (the
reference returns new pytrees); clone an index to keep its old state.
"""
from __future__ import annotations

import dataclasses

import torch

from . import spans
from .common import INF, INVALID, pow2_at_least, stable_argsort
from .hnsw import _pad_row, build
from .index import HNSWIndex, HNSWParams, empty_index
from .metrics import dist_point
from .prune import alpha_rng_select
from .reach import (bfs_unreachable, count_unreachable, indegree,
                    indegree_unreachable)

#: in-degree histogram bin splits: bin b counts live points whose total
#: in-degree falls in [HIST_SPLITS[b-1], HIST_SPLITS[b]) — i.e. the bins are
#: 0, 1, [2,4), [4,8), [8,16), [16,32), [32,64), 64+. Bin 0 is exactly the
#: paper's Definition-1 precondition (zero in-edges).
HIST_SPLITS = (1, 2, 4, 8, 16, 32, 64)

#: elements of the gathered ``[rows, pool, d]`` candidate vectors per chunk
#: of consolidated rows (512 MiB of f32)
_CHUNK_ELEMS = 1 << 27


# ---------------------------------------------------------------------------
# health report
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IndexHealth:
    """Index health report; every field is a 0-d int32 tensor except the
    histogram (``int32[len(HIST_SPLITS) + 1]``)."""
    capacity: torch.Tensor          # slot-array length N
    allocated: torch.Tensor         # slots with levels >= 0
    live: torch.Tensor              # allocated and not mark-deleted
    deleted: torch.Tensor           # allocated and mark-deleted
    unreachable_def1: torch.Tensor  # paper Definition 1 count
    unreachable_bfs: torch.Tensor   # BFS-unreachable count
    max_layer: torch.Tensor         # current top layer (-1 = empty)
    indegree_hist: torch.Tensor     # live in-degree bins

    @property
    def deleted_frac(self) -> float:
        """Mark-deleted fraction of allocated slots (0 when empty)."""
        return float(self.deleted) / max(float(self.allocated), 1.0)

    def asdict(self) -> dict:
        """Host-side summary (python scalars; JSON/metrics friendly)."""
        return {
            "capacity": int(self.capacity),
            "allocated": int(self.allocated),
            "live": int(self.live),
            "deleted": int(self.deleted),
            "deleted_frac": self.deleted_frac,
            "unreachable_def1": int(self.unreachable_def1),
            "unreachable_bfs": int(self.unreachable_bfs),
            "max_layer": int(self.max_layer),
            "indegree_hist": self.indegree_hist.tolist(),
        }

    def __repr__(self) -> str:
        return (f"IndexHealth(live={int(self.live)}, "
                f"deleted={int(self.deleted)} "
                f"({self.deleted_frac:.1%} of allocated), "
                f"unreachable_def1={int(self.unreachable_def1)}, "
                f"unreachable_bfs={int(self.unreachable_bfs)})")


def index_health(index: HNSWIndex) -> IndexHealth:
    """Gather the :class:`IndexHealth` report: a handful of O(N) reductions
    plus the BFS reachability sweep (the span ``maintain.consult``)."""
    with spans.span("maintain.consult"):
        return _index_health(index)


def _index_health(index: HNSWIndex) -> IndexHealth:
    dev = index.device
    alloc = index.levels >= 0
    live = alloc & ~index.deleted
    u_def1, u_bfs = count_unreachable(index)
    splits = torch.tensor(HIST_SPLITS, dtype=torch.int32, device=dev)
    b = torch.searchsorted(splits, indegree(index), right=True)
    hist = torch.bincount(b[live], minlength=len(HIST_SPLITS) + 1)

    def i32(v):      # a copy: the report must not alias the index's state
        return torch.as_tensor(v, dtype=torch.int32, device=dev).clone()

    return IndexHealth(
        capacity=i32(index.capacity), allocated=i32(alloc.sum()),
        live=i32(live.sum()), deleted=i32((alloc & index.deleted).sum()),
        unreachable_def1=i32(u_def1), unreachable_bfs=i32(u_bfs),
        max_layer=i32(index.max_layer), indegree_hist=hist.to(torch.int32))


# ---------------------------------------------------------------------------
# batched delete consolidation (FreshDiskANN-style)
# ---------------------------------------------------------------------------

def _consolidate_layer(params: HNSWParams, layer_nbrs: torch.Tensor,
                       vectors: torch.Tensor, live: torch.Tensor,
                       del_mask: torch.Tensor, layer: int) -> torch.Tensor:
    """Re-prune every live row with an edge into a deleted slot (one layer).

    ``layer_nbrs``: ``[N, M0]`` adjacency of one layer, updated in place.
    Affected vertices re-select from ``N(v) ∪ ⋃_{d∈N(v)∩D} N(d)``, reduced
    to the ``3*M0`` nearest candidates before the alpha-RNG sweep. The
    reference computes a row for every slot and keeps the affected ones;
    here only affected rows are computed, in chunks, which gives the same
    rows: a pool reads the vertex's own row and rows of deleted slots,
    neither of which another affected row's rewrite touches.
    """
    N, M0 = layer_nbrs.shape
    m_l = params.m_for_layer(layer)
    rc = layer_nbrs.long().clamp_min(0)
    edge_to_del = (layer_nbrs >= 0) & del_mask[rc]               # [N, M0]
    aff = torch.nonzero(live & edge_to_del.any(dim=1)).reshape(-1)
    pool_w = M0 + M0 * M0
    k_sel = min(pool_w, 3 * M0)
    step = max(1, _CHUNK_ELEMS // (pool_w * vectors.shape[1]))
    for lo in range(0, aff.numel(), step):
        v = aff[lo:lo + step]
        a = v.numel()
        ext = torch.where(edge_to_del[v][:, :, None],
                          layer_nbrs[rc[v]].long(), INVALID)     # [a, M0, M0]
        pool = torch.cat([layer_nbrs[v].long(), ext.reshape(a, M0 * M0)],
                         dim=1)
        pc = pool.clamp_min(0)
        ok = (pool >= 0) & live[pc] & (pool != v[:, None])
        dq = torch.where(ok, dist_point(params.space, vectors[v],
                                        vectors[pc]), INF)
        ids = torch.where(ok, pool, INVALID)
        order = stable_argsort(dq)[:, :k_sel]
        sel, _ = alpha_rng_select(ids.gather(1, order), dq.gather(1, order),
                                  vectors[pc.gather(1, order)], m_l,
                                  params.alpha, params.space)
        layer_nbrs[v] = _pad_row(sel[:, :m_l], M0).to(layer_nbrs.dtype)
    return layer_nbrs


def consolidate_deletes(params: HNSWParams, index: HNSWIndex) -> HNSWIndex:
    """Batched delete consolidation: repair all affected neighbourhoods,
    then reclaim every mark-deleted slot as free capacity (in place).

    Every live vertex ``v`` with an edge into the deleted set ``D``
    re-selects its row from ``N(v) ∪ ⋃_{d ∈ N(v) ∩ D} N(d) \\ D`` under the
    alpha-RNG rule (``params.alpha``), layer by layer. Deleted slots then
    drop out of the graph (``levels = -1``, rows cleared, labels freed) and
    the entry point / ``max_layer`` / ``count`` invariants are re-derived.

    Idempotent: with no mark-deleted slots the index is left untouched.
    Consolidation can orphan a point whose only in-edges ran through ``D``
    — run :func:`repair_unreachable` after (the policy driver does). The
    pass is the span ``maintain.consolidate``.
    """
    with spans.span("maintain.consolidate"):
        return _consolidate_deletes(params, index)


def _consolidate_deletes(params: HNSWParams, index: HNSWIndex) -> HNSWIndex:
    del_mask = index.deleted & (index.levels >= 0)
    if not bool(del_mask.any()):
        return index
    live = (index.levels >= 0) & ~index.deleted
    for layer in range(params.num_layers):
        _consolidate_layer(params, index.neighbors[layer], index.vectors,
                           live, del_mask, layer)

    # clear the consolidated slots: they become free capacity (levels = -1)
    index.labels[del_mask] = INVALID
    index.levels[del_mask] = -1
    index.deleted[del_mask] = False
    index.neighbors[:, del_mask, :] = INVALID

    # re-derive the entry invariant: entry lives at the top remaining layer
    live_new = index.levels >= 0
    lvl = torch.where(live_new, index.levels, -1)
    top = torch.argmax(lvl)
    new_max = lvl[top]
    e = index.entry.long().clamp_min(0)
    keep = (index.entry >= 0) & live_new[e] & (lvl[e] == new_max)
    index.entry.copy_(torch.where(new_max < 0, INVALID,
                                  torch.where(keep, index.entry,
                                              top.to(torch.int32))))
    index.max_layer.copy_(new_max)
    index.count.copy_(live_new.sum())
    return index


# ---------------------------------------------------------------------------
# unreachable-point repair
# ---------------------------------------------------------------------------

def _ensure_in_edge(params: HNSWParams, index: HNSWIndex, pid: int) -> None:
    """Connectivity backstop: guarantee ``pid`` keeps >= 1 in-edge.

    The reinsert's reverse-edge pass may prune ``pid`` straight back out of
    every full neighbour row. When none of ``pid``'s out-neighbours points
    back, force its nearest layer-0 out-neighbour ``e`` to link ``pid``
    (into a free position if it has one, else evicting an edge).

    The evicted edge is the farthest one whose target keeps another
    in-edge; only when every target would lose its last one is it the
    farthest of all. The reference always evicts the farthest edge, which
    orphans that target when ``e`` held its only in-edge: outliers whose
    sole out-neighbour is ``e`` then evict one another on every sweep and
    Definition 1 never reaches 0. On the state the chip smoke's phase 5
    repairs (N = 65,536), the reference's own repair stalls at five such
    points for ten sweeps, where this one reaches 0 in four
    (``tests/repair_witness.py``; ``tests/test_torch_maintenance.py``).
    """
    nbrs = index.neighbors
    L = nbrs.shape[0]
    out = nbrs[:, pid, :].long()                                  # [L, M0]
    rows_of_out = nbrs[torch.arange(L, device=nbrs.device)[:, None],
                       out.clamp_min(0)]                          # [L, M0, M0]
    has_in = bool(torch.any((rows_of_out == pid) & (out[:, :, None] >= 0)))
    e = int(nbrs[0, pid, 0])                # nearest layer-0 out-neighbour
    if e < 0 or has_in:
        return
    erow = nbrs[0, e].long()
    free = erow < 0
    if bool(free.any()):
        pos = torch.argmax(free.to(torch.uint8))
    else:
        d = dist_point(params.space, index.vectors[e], index.vectors[erow])
        sole = indegree(index)[erow] <= 1
        if not bool(sole.all()):
            d = torch.where(sole, -INF, d)
        pos = torch.argmax(d)
    nbrs[0, e, pos] = pid


def repair_unreachable(params: HNSWParams, index: HNSWIndex) -> HNSWIndex:
    """Re-link every unreachable live point back into the graph (in place).

    Sweeps the union of the paper's Definition-1 criterion and BFS
    unreachability once, then re-links each point in slot order through
    the layer-inheriting reinsert (paper Algorithm 3), followed by the
    :func:`_ensure_in_edge` backstop. The order matters and is the
    reference's: repairing point A can, rarely, prune point B's last
    in-edge in its reverse-edge pass, so callers that need Definition-1 ==
    0 loop this pass (see :func:`run_maintenance` and
    ``VectorIndex.repair_unreachable``). The sweep is the span
    ``maintain.repair``.
    """
    from .update import _update_reinsert

    with spans.span("maintain.repair"):
        mask = indegree_unreachable(index) | bfs_unreachable(index)
        for pid in torch.nonzero(mask).reshape(-1).tolist():
            _update_reinsert(params, index, pid, params.alpha)
            _ensure_in_edge(params, index, pid)
    return index


# ---------------------------------------------------------------------------
# full rebuild — the escape hatch
# ---------------------------------------------------------------------------

def rebuild_index(params: HNSWParams, index: HNSWIndex,
                  capacity: int | None = None, seed: int = 0, *,
                  generator: torch.Generator | None = None, levels=None,
                  draws=None) -> HNSWIndex:
    """Full blocking rebuild over live points only, into a new index.

    The graph is reconstructed from scratch with ``build`` (waves from
    ``WAVE_BUILD_MIN_N`` points), in slot order. ``capacity`` defaults to
    the current one and may shrink as long as the live set fits
    (pow2-rounded). Levels come from ``generator`` (default: seeded with
    ``seed``), or from ``levels`` (sequential route) or ``draws`` (wave
    route), as ``build`` takes them.
    """
    mask = (index.levels >= 0) & ~index.deleted
    live = int(mask.sum())
    new_cap = pow2_at_least(max(capacity or index.capacity, live, 1))
    if live == 0:
        return empty_index(params, new_cap, index.dim, seed,
                           dtype=index.vectors.dtype, device=index.device)
    return build(params, index.vectors[mask], index.labels[mask], seed=seed,
                 capacity=new_cap, generator=generator, levels=levels,
                 draws=draws, device=index.device)


# ---------------------------------------------------------------------------
# policy: when to run which pass
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MaintenancePolicy:
    """Health-driven trigger thresholds for the online maintenance passes.

    Consumed by the serving engine (consulted between ``pump()`` ticks;
    passes run on the back buffer and swap in as a new epoch) and by the
    facade (consulted after mutation batches).
    """
    deleted_frac: float = 0.25   # consolidate at/above this mark-deleted
                                 # fraction of allocated slots
    min_deleted: int = 32        # ... and only once this many slots are
                                 # mark-deleted (skip trivia)
    unreachable: int = 0         # repair when the Definition-1 count
                                 # exceeds this
    check_every: int = 64        # facade: consult health every N applied
                                 # ops (the engine has its own pump-scale
                                 # cadence, ServingEngine's maintain_every)
    repair_passes: int = 3       # max repair sweeps per trigger (re-checked
                                 # between sweeps; converges in 1-2)

    def __post_init__(self):
        if not 0.0 < self.deleted_frac <= 1.0:
            raise ValueError(f"deleted_frac must be in (0, 1], got "
                             f"{self.deleted_frac}")
        if self.check_every < 1 or self.repair_passes < 0:
            raise ValueError("check_every must be >= 1 and repair_passes "
                             ">= 0")

    def should_consolidate(self, h: IndexHealth) -> bool:
        return (int(h.deleted) >= max(self.min_deleted, 1)
                and h.deleted_frac >= self.deleted_frac)

    def should_repair(self, h: IndexHealth) -> bool:
        return int(h.unreachable_def1) > self.unreachable

    def due(self, h: IndexHealth) -> bool:
        """Whether :func:`run_maintenance` would run any pass."""
        return self.should_consolidate(h) or self.should_repair(h)


def run_maintenance(params: HNSWParams, index: HNSWIndex,
                    policy: MaintenancePolicy,
                    health: IndexHealth | None = None
                    ) -> tuple[HNSWIndex, dict]:
    """One policy consult + any due passes, in place (host-side driver).

    Returns ``(index, report)`` where ``report`` records what ran:
    ``{"consolidated": bool, "reclaimed": int, "repair_passes": int,
    "unreachable_def1": int}``. Repair follows consolidation because
    clearing deleted slots can orphan points whose in-edges ran through
    them; the repair loop re-checks the Definition-1 count between sweeps
    and stops at ``policy.repair_passes``.
    """
    h = health if health is not None else index_health(index)
    report = {"consolidated": False, "reclaimed": 0, "repair_passes": 0,
              "unreachable_def1": int(h.unreachable_def1)}
    ran = False
    if policy.should_consolidate(h):
        consolidate_deletes(params, index)
        report["consolidated"] = True
        report["reclaimed"] = int(h.deleted)
        ran = True
    if ran or policy.should_repair(h):
        for _ in range(policy.repair_passes):
            def1, _bfs = count_unreachable(index)
            report["unreachable_def1"] = def1
            if def1 <= policy.unreachable:
                break
            repair_unreachable(params, index)
            report["repair_passes"] += 1
        else:
            report["unreachable_def1"] = count_unreachable(index)[0]
    return index, report
