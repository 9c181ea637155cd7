"""Port vs reference: online maintenance (health, consolidation, repair,
policy, rebuild) on graphs the reference built, handed over in the npz
layout; then the reference's own maintenance tests, mirrored on the port's
facade at small sizes.

Consolidation and repair draw nothing at random, so every array must be
equal; the rebuild is fed the reference's level draws.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import HNSWParams, MaintenancePolicy as JPolicy
from repro.core import build as j_build
from repro.core import consolidate_deletes as j_consolidate
from repro.core import count_unreachable as j_count
from repro.core import index_health as j_health
from repro.core import run_maintenance as j_run_maintenance
from repro.core.index import empty_index as j_empty_index
from repro.core.maintenance import _ensure_in_edge as j_ensure_in_edge
from repro.core.maintenance import rebuild_index as j_rebuild
from repro.core.maintenance import repair_unreachable as j_repair
from repro.data import clustered_vectors

import repro_torch.core as T
from repro_torch import api
from repro_torch.core.hnsw import WAVE_BUILD_MIN_N
from repro_torch.core.maintenance import HIST_SPLITS, _ensure_in_edge
from torch_parity import (assert_same_index, port_params, record_wave_draws,
                          ref_arrays, to_port)


def _with_changes(index, n_deleted=0, n_orphans=0, seed=0):
    """``index`` with ``n_deleted`` random live points mark-deleted and
    every in-edge into ``n_orphans`` others removed."""
    a = ref_arrays(index)
    rng = np.random.default_rng(seed)
    live = np.nonzero((a["levels"] >= 0) & ~a["deleted"])[0]
    live = live[live != a["entry"]]
    pick = rng.choice(live, n_deleted + n_orphans, replace=False)
    deleted = a["deleted"].copy()
    deleted[pick[:n_deleted]] = True
    nb = a["neighbors"].copy()
    nb[np.isin(nb, pick[n_deleted:])] = -1
    return dataclasses.replace(index, deleted=jnp.asarray(deleted),
                               neighbors=jnp.asarray(nb))


@pytest.fixture(scope="module")
def ip_case():
    """A reference-built index in the ip space, alpha 1.1."""
    p = HNSWParams(M=4, M0=8, num_layers=3, ef_construction=32,
                   ef_search=32, alpha=1.1, space="ip")
    X = clustered_vectors(256, 8, n_clusters=8, seed=5)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    return p, j_build(p, jnp.asarray(X))


def test_index_health_fields_equal(small_params, small_index):
    ix = _with_changes(small_index, n_deleted=60, n_orphans=5)
    ref, port = j_health(ix), T.index_health(to_port(ix))
    assert port.asdict() == ref.asdict()
    assert port.indegree_hist.shape == (len(HIST_SPLITS) + 1,)
    assert repr(port) == repr(ref)


@pytest.mark.parametrize("case", ["l2", "ip"])
def test_consolidate_matches_reference(case, small_params, small_index,
                                       ip_case):
    params, index = ((small_params, small_index) if case == "l2"
                     else ip_case)
    ix = _with_changes(index, n_deleted=index.capacity // 4, seed=1)
    ref = j_consolidate(params, ix)
    port = T.consolidate_deletes(port_params(params), to_port(ix))
    assert_same_index(ref, port)
    assert T.num_deleted(port) == 0
    # idempotent: a clean index is left as it is
    again = T.consolidate_deletes(port_params(params), port.clone())
    assert_same_index(ref, again)


def test_repair_unreachable_matches_reference(small_params, small_index):
    ix = _with_changes(small_index, n_orphans=8, seed=2)
    port = to_port(ix)
    assert T.count_unreachable(port)[0] >= 8
    ref = j_repair(small_params, ix)
    T.repair_unreachable(port_params(small_params), port)
    assert_same_index(ref, port)
    # the facade's loop drives Definition 1 to 0 (here in one pass)
    assert T.count_unreachable(port)[0] == 0


def test_forced_in_edge_does_not_orphan_another_point(small_params,
                                                     small_index):
    """The repair's backstop forces an orphan ``pid`` into the full row of
    its sole out-neighbour ``e``. The reference evicts the row's farthest
    edge even when that is its target's only in-edge, trading one orphan
    for another (on the state ``chip_smoke.py``'s phase 5 repairs, at N =
    65,536, the reference's own repair stalls at five such points for ten
    sweeps: ``tests/repair_witness.py``); the port evicts the farthest edge
    whose target keeps another in-edge."""
    a = ref_arrays(small_index)
    nb, vec = a["neighbors"].copy(), a["vectors"]
    full = np.nonzero((nb[0] >= 0).all(axis=1))[0]
    e = int(next(s for s in full if s != a["entry"]))
    row = nb[0, e].copy()
    far = row[np.argsort(((vec[row] - vec[e]) ** 2).sum(1))]
    f = int(far[-1])                          # e's farthest edge
    pid = int(next(s for s in range(len(vec)) if s not in row
                   and s not in (e, int(a["entry"]))))
    nb[nb == pid] = -1                        # pid: orphaned, one out-edge
    nb[:, pid] = -1
    nb[0, pid, 0] = e
    nb[(nb == f)] = -1                        # f: its only in-edge is e's
    nb[0, e] = row
    ix = dataclasses.replace(small_index, neighbors=jnp.asarray(nb))
    port = to_port(ix)
    before = T.count_unreachable(port)[0]         # pid, and what only it fed
    assert before >= 1 and bool(T.indegree_unreachable(port)[pid])

    ref = j_ensure_in_edge(small_params, ix, jnp.int32(pid))
    assert pid in np.asarray(ref.neighbors[0, e]).tolist()
    assert f not in np.asarray(ref.neighbors[0, e]).tolist()
    assert int(j_count(ref)[0]) == before         # f is orphaned instead

    _ensure_in_edge(port_params(small_params), port, pid)
    assert pid in port.neighbors[0, e].tolist()
    assert f in port.neighbors[0, e].tolist()     # the next farthest went
    assert T.count_unreachable(port)[0] == before - 1


def test_run_maintenance_reports_and_arrays_equal(small_params, small_index):
    ix = _with_changes(small_index, n_deleted=200, n_orphans=4, seed=3)
    policy = T.MaintenancePolicy(deleted_frac=0.2, min_deleted=8)
    ref_ix, ref_report = j_run_maintenance(
        small_params, ix, JPolicy(deleted_frac=0.2, min_deleted=8))
    port_ix, report = T.run_maintenance(port_params(small_params),
                                        to_port(ix), policy)
    assert report == ref_report
    assert report["consolidated"] and report["reclaimed"] == 200
    assert_same_index(ref_ix, port_ix)


def test_rebuild_index_matches_with_the_reference_draws(small_params,
                                                        small_index):
    ix = _with_changes(small_index, n_deleted=480, seed=4)
    ref = j_rebuild(small_params, ix, seed=0)
    live = int(ref.count)
    port = T.rebuild_index(port_params(small_params), to_port(ix),
                           levels=ref_arrays(ref)["levels"][:live])
    assert_same_index(ref, port)        # rng: the reference advances it
    empty = _with_changes(small_index, n_deleted=0)
    empty = dataclasses.replace(empty, deleted=jnp.ones_like(empty.deleted))
    assert_same_index(j_rebuild(small_params, empty),
                      T.rebuild_index(port_params(small_params),
                                      to_port(empty)), skip=())


def test_rebuild_index_wave_route_matches_with_the_reference_draws(
        monkeypatch, small_params):
    """From ``WAVE_BUILD_MIN_N`` live points the rebuild is a wave build
    (the route ``compact()`` takes at the smoke's size): the reference's
    ``rebuild_index`` and the port's, its wave draws fed in, give equal
    arrays. The source index only supplies vectors, labels and the live
    mask, so it is filled directly rather than built."""
    n, cap = 1536, 2048
    rng = np.random.default_rng(6)
    levels = np.full(cap, -1, np.int32)
    levels[:n] = 0
    deleted = np.zeros(cap, bool)
    deleted[rng.choice(n, 400, replace=False)] = True
    vecs = np.zeros((cap, 16), np.float32)
    vecs[:n] = clustered_vectors(n, 16, n_clusters=8, seed=6)
    labels = np.full(cap, -1, np.int32)
    labels[:n] = np.arange(5000, 5000 + n)
    ix = dataclasses.replace(
        j_empty_index(small_params, cap, 16, 0), vectors=jnp.asarray(vecs),
        labels=jnp.asarray(labels), levels=jnp.asarray(levels),
        deleted=jnp.asarray(deleted), count=jnp.int32(n))
    with record_wave_draws(monkeypatch) as draws:
        ref = j_rebuild(small_params, ix, capacity=cap)
    assert int(ref.count) == n - 400 >= WAVE_BUILD_MIN_N and len(draws) > 2
    port = T.rebuild_index(port_params(small_params), to_port(ix),
                           capacity=cap, draws=draws)
    assert_same_index(ref, port)


# ---------------------------------------------------------------------------
# mirrors of tests/test_maintenance.py on the port's facade
# ---------------------------------------------------------------------------

def _create(n, dim, space="l2", **kw):
    return api.create(space=space, dim=dim, capacity=n, device="cpu", **kw)


def _brute_recall(X, live, Q, k, lab, space):
    Xl, Ql = X[live], Q
    if space == "cosine":
        Xl = Xl / (np.linalg.norm(Xl, axis=1, keepdims=True) + 1e-12)
        Ql = Q / (np.linalg.norm(Q, axis=1, keepdims=True) + 1e-12)
    if space == "l2":
        D = ((Ql[:, None, :] - Xl[None, :, :]) ** 2).sum(-1)
    else:
        D = 1.0 - Ql @ Xl.T
    gt = live[np.argsort(D, axis=1)[:, :k]]
    return float(np.mean([len(set(lab[i]) & set(gt[i])) / k
                          for i in range(len(Q))]))


def _orphan(vi, n_orphans):
    """Strip every in-edge of the first ``n_orphans`` live slots."""
    ix = vi.index
    live = ((ix.levels >= 0) & ~ix.deleted).numpy()
    slots = np.nonzero(live)[0]
    slots = slots[slots != int(ix.entry)][:n_orphans]
    ix.neighbors[torch.isin(ix.neighbors, torch.from_numpy(slots).int())] = -1
    return ix.labels[torch.from_numpy(slots)].numpy()


@pytest.mark.parametrize("space", ["l2", "ip", "cosine"])
def test_consolidate_recall_parity_all_spaces(space):
    n, dim, k = 96, 16, 10
    X = clustered_vectors(n, dim, seed=4)
    vi = _create(n, dim, space)
    vi.add_items(X)
    rng = np.random.default_rng(0)
    dels = rng.choice(n, n // 2, replace=False).astype(np.int32)
    vi.mark_deleted(dels)
    live = np.setdiff1d(np.arange(n), dels)
    Q = clustered_vectors(24, dim, seed=5)

    assert vi.consolidate() == len(dels)
    assert vi.deleted_count == 0
    assert vi._used_slots() == len(live)       # slots actually freed
    lab, _ = vi.knn_query(Q, k=k, mode="graph")
    assert not (set(lab.ravel().tolist()) & set(dels.tolist()))
    rec = _brute_recall(X, live, Q, k, lab, space)

    fresh = _create(n, dim, space)
    fresh.add_items(X[live], live.astype(np.int32))
    lab_f, _ = fresh.knn_query(Q, k=k, mode="graph")
    assert rec >= _brute_recall(X, live, Q, k, lab_f, space) - 0.05


def test_consolidate_frees_capacity_for_inserts():
    n, dim = 64, 8
    vi = _create(n, dim)
    vi.add_items(clustered_vectors(n, dim, seed=1))
    vi.mark_deleted(np.arange(0, n, 2).astype(np.int32))
    cap = vi.capacity
    vi.consolidate()
    vi.add_items(clustered_vectors(n // 2, dim, seed=2))
    assert vi.capacity == cap and vi.count == n


def test_consolidate_everything_empties_index():
    n, dim = 48, 8
    vi = _create(n, dim)
    vi.add_items(clustered_vectors(n, dim, seed=6))
    vi.mark_deleted(np.arange(n).astype(np.int32))
    vi.consolidate()
    h = T.index_health(vi.index)
    assert int(h.allocated) == 0 and int(h.max_layer) == -1
    assert int(vi.index.entry) == -1
    vi.add_items(clustered_vectors(5, dim, seed=7))
    assert vi.count == 5


def test_repair_unreachable_drives_def1_to_zero():
    n, dim = 150, 16
    X = clustered_vectors(n, dim, seed=8)
    vi = _create(n, dim)
    vi.add_items(X)
    orphaned = _orphan(vi, 6)
    assert T.count_unreachable(vi.index)[0] >= 6
    assert vi.repair_unreachable() == 0
    assert T.count_unreachable(vi.index)[0] == 0
    rows = vi.index.labels.tolist()
    q = X[[rows.index(int(l)) for l in orphaned]]
    lab, _ = vi.knn_query(q, k=1, mode="graph")
    assert set(lab[:, 0].tolist()) == set(int(l) for l in orphaned)


def test_repair_noop_on_healthy_index(small_params, small_index):
    port = to_port(small_index)
    assert T.count_unreachable(port)[0] == 0
    T.repair_unreachable(port_params(small_params), port)
    assert_same_index(small_index, port)


def test_health_report_fields_and_bin_zero():
    n, dim = 128, 8
    vi = _create(n, dim)
    vi.add_items(clustered_vectors(n, dim, seed=9))
    vi.mark_deleted(np.arange(32).astype(np.int32))
    h = vi.health()
    assert int(h.capacity) == vi.capacity and int(h.allocated) == n
    assert int(h.live) == n - 32 and int(h.deleted) == 32
    assert h.deleted_frac == pytest.approx(32 / n)
    assert int(h.indegree_hist.sum()) == int(h.live)
    d = h.asdict()
    assert d["live"] == n - 32 and isinstance(d["indegree_hist"], list)
    _orphan(vi, 4)
    h = vi.health()
    assert 4 <= int(h.unreachable_def1) <= int(h.indegree_hist[0])


def test_policy_validation():
    with pytest.raises(ValueError):
        T.MaintenancePolicy(deleted_frac=0.0)
    with pytest.raises(ValueError):
        T.MaintenancePolicy(check_every=0)


def test_policy_autoruns_in_facade():
    n, dim = 100, 8
    vi = _create(n, dim, maintenance=T.MaintenancePolicy(
        deleted_frac=0.3, min_deleted=8, check_every=1))
    vi.add_items(clustered_vectors(n, dim, seed=11))
    vi.mark_deleted(np.arange(50).astype(np.int32))
    assert vi.deleted_count == 0          # consolidated behind the call
    assert vi.count == n - 50


def test_run_maintenance_below_threshold_is_noop():
    vi = _create(64, 8)
    vi.add_items(clustered_vectors(64, 8, seed=12))
    vi.mark_deleted(np.arange(4).astype(np.int32))
    before = vi.index.clone()
    policy = T.MaintenancePolicy(deleted_frac=0.5, min_deleted=32)
    _, report = T.run_maintenance(vi.params, vi.index, policy)
    assert not report["consolidated"] and report["repair_passes"] == 0
    for f in T.index.FIELDS:
        assert torch.equal(getattr(before, f), getattr(vi.index, f)), f


def test_engine_maintenance_swaps_epoch_and_invalidates_stats():
    n, dim = 96, 8
    X = clustered_vectors(n, dim, seed=13)
    vi = _create(n, dim, maintenance=T.MaintenancePolicy(
        deleted_frac=0.3, min_deleted=8, check_every=1))
    vi.add_items(X)
    eng = vi.serve(k=3, max_ops_per_drain=256)
    for l in range(50):
        eng.delete(l)
    st = eng.pump()
    assert st.maintenance_ran and st.epoch == 1
    snap = eng.snapshot()
    assert int((snap.index.deleted & (snap.index.levels >= 0)).sum()) == 0
    assert eng.batcher._stats_cache is None        # planner must re-consult
    assert eng.metrics.counter("maintenance_consolidations").value == 1
    t = eng.search(X[80])
    eng.pump()
    assert all(l >= 50 for l in t.result()[0].tolist())
    eng.pump()
    assert not eng._dirty_since_consult
    st_idle = eng.pump()
    assert not st_idle.maintenance_ran and not eng._dirty_since_consult


def test_sharded_engine_is_not_ported_yet(monkeypatch):
    """``vi.serve(mesh=...)``, once unported, now reaches the sharded
    engine: the facade's maintenance policy is not inherited there (the
    sharded engine takes none), and its single graph is refused with the
    engine's ``TypeError``, which names ``build_sharded``."""
    import repro_torch.serving as serving
    vi = _create(32, 8, maintenance=T.MaintenancePolicy())
    vi.add_items(clustered_vectors(32, 8, seed=21))
    mesh = [torch.device("cpu")]
    seen = {}
    monkeypatch.setattr(serving, "ServingEngine",
                        lambda params, index, **kw: seen.update(kw))
    vi.serve(k=3, mesh=mesh)
    assert seen["mesh"] is mesh and "maintenance" not in seen
    assert seen["variant"] == vi.strategy
    vi.serve(k=3)
    assert seen["maintenance"] is vi.maintenance
    monkeypatch.undo()
    with pytest.raises(TypeError, match="build_sharded"):
        vi.serve(k=3, mesh=mesh)


def test_interleaved_update_consolidate_never_loses_live_labels():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    dim = 8
    base = clustered_vectors(32, dim, seed=15)

    @settings(max_examples=6, deadline=None)
    @given(st.lists(st.sampled_from(["delete", "replace", "consolidate",
                                     "repair"]),
                    min_size=1, max_size=8))
    def run(ops):
        vi = _create(32, dim)
        vi.add_items(base)
        live = set(range(32))
        nxt = 32
        rng = np.random.default_rng(17)
        for op in ops:
            if op == "delete" and len(live) > 8:
                dels = rng.choice(sorted(live), 4, replace=False)
                vi.mark_deleted(dels.astype(np.int32))
                live -= set(int(d) for d in dels)
            elif op == "replace":
                news = list(range(nxt, nxt + 3))
                nxt += 3
                vi.replace_items(clustered_vectors(3, dim, seed=nxt), news)
                live |= set(news)
            elif op == "consolidate":
                vi.consolidate()
            else:
                vi.repair_unreachable(max_passes=2)
            ix = vi.index
            mask = ((ix.levels >= 0) & ~ix.deleted).numpy()
            got = set(ix.labels.numpy()[mask].tolist())
            assert got == live, (op, live - got, got - live)

    run()
