"""The port's ``repro_torch.api`` facade: the reference's facade tests
(``tests/test_api.py``, minus its deprecation shims, which have no port
users) mirrored on the CPU, and npz files crossing between the packages in
both directions.

The facade draws levels and slot cursors from its own generator, so most
of these tests hold the port to the reference's recall thresholds, not to
its arrays. ``test_facade_matches_the_reference_facade`` feeds the
reference's draws to the port instead and holds every array equal after
every call; the npz tests hold both packages to the same answers on the
same graph.
"""
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.data import brute_force_knn, clustered_vectors, exact_knn

import repro_torch.core as T
from repro_torch.core.hnsw import WAVE_BUILD_MIN_N
from repro_torch import api

DIM = 16
N = 2000
K = 10
EF = 64
SPACES = ("l2", "ip", "cosine")


def _create(**kw):
    kw.setdefault("device", "cpu")
    return api.create(**kw)


def recall(lab, gt):
    k = gt.shape[1]
    return np.mean([len(set(lab[i]) & set(gt[i])) / k
                    for i in range(gt.shape[0])])


@pytest.fixture(scope="module")
def corpus():
    return (clustered_vectors(N, DIM, seed=3),
            clustered_vectors(32, DIM, seed=4))


@pytest.fixture(scope="module", params=SPACES)
def space_index(request, corpus):
    X, _ = corpus
    vi = _create(space=request.param, dim=DIM, capacity=N, M=8,
                 ef_construction=64, strategy="mn_ru_gamma", ef_search=EF,
                 num_layers=3)
    vi.add_items(X)
    return vi


# -- brute-force parity across spaces ---------------------------------------

def test_knn_query_matches_brute_force(space_index, corpus):
    X, Q = corpus
    for mode in ("auto", "graph"):
        lab, dists = space_index.knn_query(Q, k=K, ef=EF, mode=mode)
        gt = exact_knn(X, Q, K, space_index.space)
        assert lab.shape == dists.shape == (len(Q), K)
        assert recall(lab, gt) >= 0.95
        assert np.all(np.diff(dists, axis=1) >= -1e-5)
        assert np.all(lab >= 0)


def test_filtered_query_matches_masked_brute_force(space_index, corpus):
    X, Q = corpus
    allowed = np.arange(0, N, 5)
    lab, _ = space_index.knn_query(Q, k=K, ef=EF, filter=allowed)
    assert np.isin(lab[lab >= 0], allowed).all()
    gt = allowed[exact_knn(X[allowed], Q, K, space_index.space)]
    assert recall(lab, gt) >= 0.9


def test_filtered_query_callable_and_tiny_predicate(space_index):
    X = space_index.index.vectors.numpy()
    lab, _ = space_index.knn_query(X[123], k=3, filter=lambda l: l % 2 == 1)
    assert np.all((lab < 0) | (lab % 2 == 1))
    lab, dists = space_index.knn_query(X[123], k=5, filter=np.array([7, 11]))
    got = set(int(v) for v in lab[0] if v >= 0)
    assert got <= {7, 11} and len(got) >= 1
    assert np.isinf(dists[0][lab[0] < 0]).all()


# -- growth + compaction ----------------------------------------------------

def test_add_items_grows_past_capacity_and_preserves_recall():
    X = clustered_vectors(300, DIM, seed=11)
    Q = clustered_vectors(24, DIM, seed=12)
    vi = _create(space="l2", dim=DIM, capacity=64, M=8, ef_construction=48,
                 num_layers=3)
    for lo in range(0, 300, 75):               # crosses 64 -> ... -> 512
        vi.add_items(X[lo:lo + 75], np.arange(lo, lo + 75))
    assert vi.capacity == 512 and vi.count == 300

    fresh = _create(space="l2", dim=DIM, capacity=300, M=8,
                    ef_construction=48, num_layers=3)
    fresh.add_items(X)
    gt = brute_force_knn(X, Q, K)
    grown = recall(vi.knn_query(Q, k=K, ef=EF, mode="graph")[0], gt)
    ref = recall(fresh.knn_query(Q, k=K, ef=EF, mode="graph")[0], gt)
    assert grown >= ref - 0.03
    assert grown >= 0.9


def test_compact_reclaims_deleted_slots():
    X = clustered_vectors(150, DIM, seed=21)
    vi = _create(space="l2", dim=DIM, capacity=150, M=8, ef_construction=48,
                 num_layers=3)
    vi.add_items(X)
    vi.mark_deleted(np.arange(0, 150, 3))
    assert vi.deleted_count == 50
    cap = vi.compact()
    assert vi.deleted_count == 0 and vi.count == 100
    assert cap == vi.capacity and cap & (cap - 1) == 0
    live = np.setdiff1d(np.arange(150), np.arange(0, 150, 3))
    lab, _ = vi.knn_query(X[live], k=1, ef=EF, mode="graph")
    assert np.mean(lab[:, 0] == live) >= 0.95
    lab, _ = vi.knn_query(X[:10], k=5, ef=EF)
    assert not np.isin(lab, np.arange(0, 150, 3)).any()


def test_replace_items_overwrites_live_label():
    X = clustered_vectors(40, 8, seed=61)
    vi = _create(space="l2", dim=8, capacity=64, M=4, num_layers=2,
                 ef_construction=32)
    vi.add_items(X[:30])
    with pytest.raises(ValueError, match="replace_items"):
        vi.add_items(X[30], [5])
    vi.replace_items(X[30], [5])
    assert vi.count == 30
    lab, _ = vi.knn_query(X[30], k=1, ef=48)
    assert lab[0, 0] == 5
    vi.mark_deleted(5)
    lab, _ = vi.knn_query(X[30], k=30, ef=64)
    assert 5 not in set(lab[0].tolist()) and vi.count == 29
    vi.replace_items(X[31], [5])
    assert vi.count == 30
    lab, _ = vi.knn_query(X[31], k=1, ef=48)
    assert lab[0, 0] == 5


def test_failed_add_does_not_corrupt_label_counter():
    X = clustered_vectors(4, 8, seed=62)
    vi = _create(space="l2", dim=8, capacity=16, M=4, num_layers=2,
                 ef_construction=32)
    vi.add_items(X[:2])
    with pytest.raises(ValueError, match="already present"):
        vi.add_items(X[2:], [1, 5])
    assert vi.count == 2
    assert vi.add_items(X[2]).tolist() == [2]


# -- persistence ------------------------------------------------------------

def test_save_load_roundtrip(tmp_path):
    X = clustered_vectors(120, DIM, seed=31)
    Q = clustered_vectors(8, DIM, seed=32)
    vi = _create(space="cosine", dim=DIM, capacity=120, M=8,
                 ef_construction=48, strategy="mn_thn_ru", num_layers=3)
    vi.add_items(X)
    vi.mark_deleted([3, 5])
    path = str(tmp_path / "index.npz")
    vi.save(path)

    vi2 = api.VectorIndex.load(path, device="cpu")
    assert (vi2.space, vi2.strategy) == ("cosine", "mn_thn_ru")
    assert vi2.count == vi.count and vi2.capacity == vi.capacity
    lab1, d1 = vi.knn_query(Q, k=K, ef=EF)
    lab2, d2 = vi2.knn_query(Q, k=K, ef=EF)
    np.testing.assert_array_equal(lab1, lab2)
    np.testing.assert_allclose(d1, d2, rtol=1e-6)
    new = vi2.add_items(clustered_vectors(4, DIM, seed=33))
    assert new.min() >= 120
    rows = vi2.index.vectors.numpy()[np.isin(vi2.index.labels.numpy(), new)]
    lab, _ = vi2.knn_query(rows, k=1, ef=EF)
    assert set(lab[:, 0]) <= set(new.tolist()) | {-1}


@pytest.mark.parametrize("space", ["l2", "cosine"])
def test_npz_files_cross_between_the_packages(tmp_path, space):
    """A port-saved file loads in the reference and answers the same
    queries; the reference, after churn of its own, saves a file the port
    loads and answers the same queries again."""
    X = clustered_vectors(160, DIM, seed=41)
    Q = clustered_vectors(12, DIM, seed=42)
    vi = _create(space=space, dim=DIM, capacity=160, M=8,
                 ef_construction=48, num_layers=3)
    vi.add_items(X)
    vi.mark_deleted(np.arange(0, 160, 7))
    port_path = str(tmp_path / "port.npz")
    vi.save(port_path)

    ji = japi.VectorIndex.load(port_path)
    assert (ji.space, ji.count, ji.capacity) == (space, vi.count,
                                                 vi.capacity)
    for mode in ("graph", "exact"):
        pl, pd = vi.knn_query(Q, k=K, ef=EF, mode=mode)
        jl, jd = ji.knn_query(Q, k=K, ef=EF, mode=mode)
        np.testing.assert_array_equal(pl, jl)
        np.testing.assert_allclose(pd, jd, rtol=1e-5, atol=1e-5)

    ji.replace_items(clustered_vectors(10, DIM, seed=43),
                     np.arange(500, 510))
    ref_path = str(tmp_path / "ref.npz")
    ji.save(ref_path)
    back = api.VectorIndex.load(ref_path, device="cpu")
    assert back._next_label == 510 and back.count == ji.count
    for f in T.index.FIELDS:
        np.testing.assert_array_equal(getattr(back.index, f).numpy(),
                                      np.asarray(getattr(ji.index, f)))
    for mode in ("graph", "exact"):
        pl, pd = back.knn_query(Q, k=K, ef=EF, mode=mode)
        jl, jd = ji.knn_query(Q, k=K, ef=EF, mode=mode)
        np.testing.assert_array_equal(pl, jl)
        np.testing.assert_allclose(pd, jd, rtol=1e-5, atol=1e-5)


# -- the reference's facade, side by side -----------------------------------

def _no_repair(params, nbrs, vectors, deleted, pid, layer, strategy):
    return nbrs


def _register_no_repair(name="parity_no_repair"):
    """A strategy with a custom ``repair_fn`` in both registries: it sends
    both facades down the sequential tape route."""
    from repro.core import strategies as jstrat
    if name not in jstrat.list_strategies():
        jstrat.register_strategy(jstrat.UpdateStrategy(name,
                                                       repair_fn=_no_repair))
    if name not in api.list_strategies():
        api.register_strategy(api.UpdateStrategy(name, repair_fn=_no_repair))
    return name


@pytest.mark.parametrize("route", ["wave", "sequential"])
def test_facade_matches_the_reference_facade(monkeypatch, route):
    """``repro.api.VectorIndex`` and the port's, side by side with the
    reference's draws fed to the port: after every call — the bulk build,
    ``mark_deleted``, ``replace_items`` over labels that are live, pending
    deletion and new, ``add_items`` past capacity, ``consolidate``,
    ``repair_unreachable`` and ``compact`` — every array, count, capacity
    and label counter is equal, and so are health reports and answers.
    The sequential route takes a strategy with a custom ``repair_fn`` and a
    maintenance policy that runs behind the mutation calls."""
    import repro.api.facade as jf
    import repro_torch.api.facade as pf
    from repro.core import MaintenancePolicy as JPolicy
    from torch_parity import (Feed, allocated_levels, assert_same_index,
                              record_wave_draws, recording_sequential_draws)

    wave_route = route == "wave"
    strategy = "mn_ru_gamma" if wave_route else _register_no_repair()
    policy = None if wave_route else dict(deleted_frac=0.03, min_deleted=8,
                                          check_every=32)
    kw = dict(space="l2", dim=DIM, capacity=256, M=8, num_layers=3,
              ef_construction=48, ef_search=48, strategy=strategy)
    seq, levels = Feed(), Feed()
    with record_wave_draws(monkeypatch) as wave_draws:
        waves = Feed(wave_draws)

        j_build, j_rebuild, j_apply = (jf._build, jf.rebuild_index,
                                       jf.apply_update_batch_jit)

        def jb(params, X, *a, **k):
            ix = j_build(params, X, *a, **k)
            if len(X) < WAVE_BUILD_MIN_N:
                levels.append(allocated_levels(ix))
            return ix

        def jr(params, index, **k):
            ix = j_rebuild(params, index, **k)
            if int(ix.count) < WAVE_BUILD_MIN_N:
                levels.append(allocated_levels(ix))
            return ix

        def ja(params, index, ops, labels, X, variant, execution):
            fn = lambda *t: j_apply(params, *t, variant, execution=execution)
            if execution == "sequential":
                fn = recording_sequential_draws(fn, params, variant, seq)
            return fn(index, ops, labels, X)

        def pb(params, X, *a, **k):
            k.pop("generator")
            if len(X) < WAVE_BUILD_MIN_N:
                return p_build(params, X, *a, levels=next(levels), **k)
            return p_build(params, X, *a, draws=waves, **k)

        def pr(params, index, **k):
            k.pop("generator")
            live = int(((index.levels >= 0) & ~index.deleted).sum())
            if live < WAVE_BUILD_MIN_N:
                return p_rebuild(params, index, levels=next(levels), **k)
            return p_rebuild(params, index, draws=waves, **k)

        def pa(params, index, ops, labels, X, variant, execution, generator):
            if execution == "wave":
                return p_apply(params, index, ops, labels, X, variant,
                               execution, draws=waves)
            slots, lv = next(seq)
            return p_apply(params, index, ops, labels, X, variant, execution,
                           slots=slots, levels=lv)

        p_build, p_rebuild, p_apply = (pf.build, pf.rebuild_index,
                                       pf.apply_update_batch)
        for mod, name, fn in ((jf, "_build", jb), (jf, "rebuild_index", jr),
                              (jf, "apply_update_batch_jit", ja),
                              (pf, "build", pb), (pf, "rebuild_index", pr),
                              (pf, "apply_update_batch", pa)):
            monkeypatch.setattr(mod, name, fn)

        ref = japi.create(**kw, maintenance=policy and JPolicy(**policy))
        vi = _create(**kw, maintenance=policy and T.MaintenancePolicy(
            **policy))
        X = clustered_vectors(320, DIM, seed=51)
        Q = clustered_vectors(16, DIM, seed=52)

        deleted = []

        def same(what, r, p):
            assert p == r, what
            deleted.append(vi.deleted_count)
            assert_same_index(ref.index, vi.index)
            assert (vi.count, vi.deleted_count, vi.capacity, vi._next_label) \
                == (ref.count, ref.deleted_count, ref.capacity,
                    ref._next_label), what

        calls = [
            ("add_items", lambda v: v.add_items(X[:200]).tolist()),
            ("mark_deleted", lambda v: v.mark_deleted(np.arange(0, 60, 2))),
            ("replace_items", lambda v: v.replace_items(
                X[200:224], [4, 6, 41, 43] + list(range(1000, 1020)))
             .tolist()),
            ("add_items past capacity", lambda v: v.add_items(
                X[224:320], np.arange(2000, 2096)).tolist()),
            ("health", lambda v: v.health().asdict()),
            ("consolidate", lambda v: v.consolidate()),
            ("repair_unreachable", lambda v: v.repair_unreachable()),
            ("compact", lambda v: v.compact()),
        ]
        for what, call in calls:
            same(what, call(ref), call(vi))
            for mode in ("graph", "auto"):
                rl, rd = ref.knn_query(Q, k=K, mode=mode)
                pl, pd = vi.knn_query(Q, k=K, mode=mode)
                np.testing.assert_array_equal(pl, rl, err_msg=what)
                np.testing.assert_allclose(pd, rd, rtol=1e-5, atol=1e-5)
    assert waves.spent and seq.spent and levels.spent
    assert vi.capacity == 512 and vi.deleted_count == 0
    # the policy consolidated behind replace_items (8 of 200 deleted)
    assert deleted[1:3] == ([30, 8] if wave_route else [30, 0]), deleted
    assert wave_route == (len(wave_draws) > 0)
    assert wave_route == (len(seq.items) == 0)


# -- registries -------------------------------------------------------------

def test_unknown_strategy_uniform_error_everywhere():
    from repro_torch.serving import UpdateScheduler
    msgs = []
    with pytest.raises(ValueError, match="registered strategies") as e1:
        _create(space="l2", dim=4, strategy="nope")
    msgs.append(str(e1.value))
    p = T.HNSWParams(num_layers=2)
    ix = T.empty_index(p, 8, 4, device="cpu")
    with pytest.raises(ValueError, match="registered strategies") as e2:
        T.replaced_update(p, ix, torch.zeros(4), 0, variant="nope")
    msgs.append(str(e2.value))
    with pytest.raises(ValueError, match="registered strategies") as e3:
        T.apply_update_batch(p, ix, np.zeros(1, np.int32),
                             np.zeros(1, np.int32), np.zeros((1, 4)),
                             variant="nope")
    msgs.append(str(e3.value))
    with pytest.raises(ValueError, match="registered strategies") as e4:
        UpdateScheduler(p, 4, variant="nope")
    msgs.append(str(e4.value))
    assert len(set(msgs)) == 1
    for name in api.list_strategies():
        assert name in msgs[0]


def test_unknown_space_error_lists_registered():
    with pytest.raises(ValueError, match="registered spaces"):
        _create(space="hamming", dim=4)
    assert set(SPACES) <= set(api.list_metrics())


def test_register_custom_strategy_via_facade():
    name = "test_custom_ru"
    if name not in api.list_strategies():
        api.register_strategy(api.UpdateStrategy(name, "mutual",
                                                 "per_vertex", 1.05))
    assert name in api.list_strategies()
    X = clustered_vectors(64, 8, seed=41)
    vi = _create(space="l2", dim=8, capacity=64, M=4, num_layers=2,
                 ef_construction=32, strategy=name)
    vi.add_items(X)
    vi.mark_deleted(np.arange(8))
    newl = vi.replace_items(clustered_vectors(8, 8, seed=42),
                            np.arange(100, 108))
    assert vi.count == 64 and vi.deleted_count == 0
    rows = vi.index.vectors.numpy()[np.isin(vi.index.labels.numpy(), newl)]
    lab, _ = vi.knn_query(rows, k=1, ef=48)
    assert np.isin(lab[:, 0], newl).mean() >= 0.9


def test_custom_repair_fn_is_invoked():
    calls = []

    def no_repair(params, nbrs, vectors, deleted, pid, layer, strategy):
        calls.append(layer)
        return nbrs

    name = "test_no_repair_ru"
    if name not in api.list_strategies():
        api.register_strategy(api.UpdateStrategy(name, repair_fn=no_repair))
    vi = _create(space="l2", dim=8, capacity=32, M=4, num_layers=2,
                 ef_construction=32, strategy=name)
    vi.add_items(clustered_vectors(20, 8, seed=43))
    vi.mark_deleted([0])
    vi.replace_items(clustered_vectors(1, 8, seed=44), [777])
    assert calls
    assert vi.count == 20


def test_invalid_strategy_config_rejected():
    with pytest.raises(ValueError, match="repair_set"):
        api.UpdateStrategy("bad", repair_set="psychic")
    with pytest.raises(ValueError, match="candidate_pool"):
        api.UpdateStrategy("bad", candidate_pool="psychic")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.create(space="l2", dim=4)


def test_free_functions_agree_with_the_facade(corpus):
    X, Q = corpus
    p = T.HNSWParams(M=8, M0=16, num_layers=3, ef_construction=64,
                     ef_search=EF)
    ix = T.build(p, X[:1024], device="cpu")
    lab, _, _ = T.batch_knn(p, ix, torch.from_numpy(Q), K, EF)
    assert recall(lab.numpy(), brute_force_knn(X[:1024], Q, K)) >= 0.95


# -- mixed-op churn property -------------------------------------------------

def test_mixed_ops_property():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    pool = clustered_vectors(256, 8, seed=51)

    @settings(max_examples=8, deadline=None)
    @given(st.lists(st.tuples(st.sampled_from(["add", "delete", "replace"]),
                              st.integers(0, 255)),
                    min_size=1, max_size=16))
    def run(ops):
        vi = _create(space="l2", dim=8, capacity=32, M=4, num_layers=2,
                     ef_construction=32)
        live: dict[int, int] = {}
        next_label = 0
        for kind, row in ops:
            if kind in ("add", "replace") and row in live.values():
                continue
            if kind == "add":
                vi.add_items(pool[row], [next_label])
                live[next_label] = row
                next_label += 1
            elif kind == "delete" and live:
                victim = sorted(live)[row % len(live)]
                vi.mark_deleted(victim)
                del live[victim]
            elif kind == "replace" and next_label > 0:
                vi.replace_items(pool[row], [next_label])
                live[next_label] = row
                next_label += 1
        assert vi.count == len(live)
        if live:
            labels = np.fromiter(live.keys(), dtype=np.int64)
            rows = pool[[live[int(l)] for l in labels]]
            lab, _ = vi.knn_query(rows, k=1, ef=48)
            assert np.mean(lab[:, 0] == labels) >= 0.9
            dead = np.setdiff1d(np.arange(next_label), labels)
            assert not np.isin(lab, dead).any()

    run()
