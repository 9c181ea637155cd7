"""The port's serving engine: the reference's serving tests
(``tests/test_serving.py``, minus the sharded subprocess test, which
``tests/test_torch_sharded_serving.py`` ports) mirrored on a graph the
reference built; the reference's engine and the port's side by side on one
stream of calls, the reference's draws fed to the port, equal pump for
pump; the port-only guarantee that a published snapshot does not change
while a drain updates the working copy in place; and the
``launch/serve.py`` command line on the CPU.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import batch_knn as j_batch_knn
from repro.data import brute_force_knn, clustered_vectors

import repro_torch.core as T
from repro_torch.launch import serve as serve_cli
from repro_torch.serving import (MicroBatcher, ServingEngine, SnapshotStore,
                                 bucket_size, pow2_floor)
from torch_parity import (Feed, allocated_levels, assert_same_index,
                          port_params, record_wave_draws,
                          recording_sequential_draws, to_port)


@pytest.fixture
def port(small_params, small_index):
    """The reference's small index on the port, and its params."""
    return port_params(small_params), to_port(small_index)


# ---------------------------------------------------------------------------
# snapshot store
# ---------------------------------------------------------------------------

def test_snapshot_publish_semantics(port):
    _, index = port
    store = SnapshotStore(index)
    s0 = store.current()
    assert s0.epoch == 0 and not store.dirty
    assert store.publish() is s0

    staged = T.mark_delete(store.writable_index(), 3)
    assert staged is not s0.index            # the writer got a clone
    store.stage(index=staged)
    assert store.dirty
    assert store.current() is s0
    assert not bool(store.current().index.deleted[3])
    assert bool(store.working_index().deleted[3])

    s1 = store.publish()
    assert s1.epoch == 1 and bool(s1.index.deleted[3])
    assert not bool(s0.index.deleted[3])
    # the next writer clones the newly published index, not s0's
    assert store.writable_index() is not s1.index


def test_query_before_publish_never_sees_inflight_writes(port, small_data):
    params, index = port
    engine = ServingEngine(params, index, k=5, max_batch=8)
    target = 7
    q = np.asarray(small_data[target])

    t_before = engine.search(q)
    engine.delete(target)
    engine.update(clustered_vectors(1, small_data.shape[1], seed=99)[0],
                  10_000)
    stats = engine.pump()
    assert stats.queries_served == 1 and stats.updates_applied == 2
    labels, _ = t_before.result()
    assert t_before.epoch == 0 and target in labels.tolist()

    t_after = engine.search(q)
    engine.pump()
    assert t_after.epoch == 1 and target not in t_after.result()[0].tolist()


def test_published_snapshot_unchanged_while_a_drain_runs(port, small_data):
    """Updates work in place on the working copy: answers served from the
    published snapshot in the middle of a drain, and after it, equal the
    answers before it, and its arrays are untouched."""
    params, index = port
    Q = torch.from_numpy(small_data[:16] + 0.01)
    engine = ServingEngine(params, index, k=10, max_ops_per_drain=64)
    s0 = engine.snapshot()
    before = s0.index.clone()
    want = T.batch_knn(params, s0.index, Q, 10)
    mid = []
    apply = engine.scheduler._apply_fn

    def apply_and_query(ix, ops, labels, X):
        out = apply(ix, ops, labels, X)
        assert out is not s0.index
        mid.append(T.batch_knn(params, s0.index, Q, 10))
        return out

    engine.scheduler._apply_fn = apply_and_query
    for l in range(0, 40, 2):
        engine.delete(l)
        engine.update(clustered_vectors(1, 16, seed=l)[0], 1000 + l)
    st = engine.pump()
    assert st.updates_applied == 40 and st.epoch == 1 and mid
    for got in mid + [T.batch_knn(params, s0.index, Q, 10)]:
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    for f in T.index.FIELDS:
        assert torch.equal(getattr(s0.index, f), getattr(before, f)), f
    assert not torch.equal(engine.snapshot().index.labels, before.labels)


# ---------------------------------------------------------------------------
# micro-batcher
# ---------------------------------------------------------------------------

def test_bucket_size():
    assert [bucket_size(n, 16) for n in (1, 2, 3, 5, 8, 9, 16, 40)] == \
        [1, 2, 4, 8, 8, 16, 16, 16]
    assert [pow2_floor(n) for n in (1, 2, 3, 48, 64, 100)] == \
        [1, 2, 2, 32, 64, 64]
    assert MicroBatcher(T.HNSWParams(), k=1, max_batch=48).max_batch == 32


@pytest.mark.parametrize("n_queries", [1, 3, 8, 13])
def test_batcher_matches_direct_batch_knn(port, small_params, small_index,
                                          n_queries):
    """Padding/bucketing changes no query's result; on the reference's
    graph the served answers equal the reference's ``batch_knn`` too."""
    params, index = port
    k = 10
    Q = clustered_vectors(n_queries, index.dim, seed=5)
    batcher = MicroBatcher(params, k=k, max_batch=8, mode="graph")
    tickets = [batcher.submit(q) for q in Q]
    batcher.flush(SnapshotStore(index).current())

    want_labels, _, want_dists = T.batch_knn(params, index,
                                             torch.from_numpy(Q), k)
    got_labels = np.stack([t.result()[0] for t in tickets])
    got_dists = np.stack([t.result()[1] for t in tickets])
    np.testing.assert_array_equal(got_labels, want_labels.numpy())
    np.testing.assert_allclose(got_dists, want_dists.numpy(), rtol=1e-6)
    ref_labels = np.asarray(j_batch_knn(small_params, small_index, Q, k)[0])
    np.testing.assert_array_equal(got_labels, ref_labels)


def test_batcher_bucketed_dispatch(port):
    params, index = port
    batcher = MicroBatcher(params, k=5, max_batch=8)
    store = SnapshotStore(index)
    for n in (1, 2, 3, 5, 6, 7, 8, 11):
        for q in clustered_vectors(n, index.dim, seed=n):
            batcher.submit(q)
        batcher.flush(store.current())
    assert batcher.metrics.histogram("batch_fill").count == 9
    assert batcher.metrics.counter("queries_served").value == 43
    # 600 live points: the planner routes every bucket to the exact tier
    assert batcher.metrics.counter("tier_exact_batches").value == 9


# ---------------------------------------------------------------------------
# op tape
# ---------------------------------------------------------------------------

def test_apply_update_batch_matches_sequential(port):
    """A mixed tape on the sequential executor == issuing mark_delete /
    replaced_update one by one in the same order (OP_NOP padding
    included), with the same generator seed."""
    params, index = port
    d = index.dim
    newX = clustered_vectors(4, d, seed=77)
    z = np.zeros(d, np.float32)
    ops = [(T.OP_DELETE, 11, z), (T.OP_DELETE, 23, z),
           (T.OP_REPLACE, 1001, newX[0]), (T.OP_NOP, -1, z),
           (T.OP_REPLACE, 1002, newX[1]), (T.OP_DELETE, 42, z),
           (T.OP_REPLACE, 1003, newX[2]), (T.OP_NOP, -1, z)]
    tape = T.apply_update_batch(
        params, index.clone(), np.array([o[0] for o in ops], np.int32),
        np.array([o[1] for o in ops], np.int32),
        np.stack([o[2] for o in ops]), execution="sequential",
        generator=torch.Generator().manual_seed(5))
    seq, gen = index.clone(), torch.Generator().manual_seed(5)
    for op, lbl, x in ops:
        if op == T.OP_DELETE:
            T.mark_delete(seq, lbl)
        elif op == T.OP_REPLACE:
            T.replaced_update(params, seq, torch.from_numpy(x), lbl,
                              generator=gen)
    for f in T.index.FIELDS:
        assert torch.equal(getattr(tape, f), getattr(seq, f)), f


def test_apply_update_batch_insert_op(small_params, small_data):
    """OP_INSERT fills free slots; a full index makes it a no-op."""
    params = port_params(small_params)
    n, d = 64, small_data.shape[1]
    index = T.build(params, small_data[:n], capacity=n + 2, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    newX = clustered_vectors(3, d, seed=88)
    T.apply_update_batch(params, index, np.full(3, T.OP_INSERT, np.int32),
                         np.array([500, 501, 502], np.int32), newX,
                         execution="sequential",
                         generator=torch.Generator().manual_seed(1))
    assert int(index.count) == n + 2
    assert 502 not in index.labels.tolist()
    labels, _, _ = T.batch_knn(params, index, torch.from_numpy(newX[:2]), 1)
    assert labels[:, 0].tolist() == [500, 501]


# ---------------------------------------------------------------------------
# engine under churn
# ---------------------------------------------------------------------------

def _op_stream(n, d, rounds, per_round, seed=0):
    rng = np.random.default_rng(seed)
    live = set(range(n))
    nxt = n
    for rnd in range(rounds):
        dels = rng.choice(sorted(live), per_round, replace=False).astype(
            np.int32)
        newX = clustered_vectors(per_round, d, seed=300 + rnd)
        news = np.arange(nxt, nxt + per_round, dtype=np.int32)
        nxt += per_round
        live -= set(int(x) for x in dels)
        live |= set(int(x) for x in news)
        yield dels, newX, news


def test_engine_recall_under_churn_matches_baseline(port, small_data):
    """≥500 mixed ops stream through the engine while queries are served;
    final recall@10 within 0.02 of the sequential ``delete_and_update_batch``
    path's (the two draw their slots and levels differently)."""
    params, index = port
    n, d = small_data.shape
    rounds, per_round = 5, 51          # 5 * 51 * 2 = 510 mixed ops
    Q = clustered_vectors(24, d, seed=1)
    stream = list(_op_stream(n, d, rounds, per_round, seed=3))

    engine = ServingEngine(params, index.clone(), k=10, max_batch=32,
                           max_ops_per_drain=128)
    baseline, gen = index.clone(), torch.Generator().manual_seed(0)
    total_ops = 0
    for dels, newX, news in stream:
        for dl in dels:
            engine.delete(int(dl))
        for x, nl in zip(newX, news):
            engine.update(x, int(nl))
        tickets = [engine.search(q) for q in Q]
        engine.pump()
        while engine.update_backlog:
            engine.pump()
        assert all(t.done for t in tickets)
        total_ops += 2 * len(dels)
        T.delete_and_update_batch(params, baseline, dels, newX, news,
                                  generator=gen)
    assert engine.metrics.counter("updates_applied").value == total_ops >= 500

    live = {i: small_data[i] for i in range(n)}
    for dels, newX, news in stream:
        for dl in dels:
            del live[int(dl)]
        for x, nl in zip(newX, news):
            live[int(nl)] = x
    keys = np.fromiter(live.keys(), dtype=np.int64)
    gt = keys[brute_force_knn(np.stack([live[int(k)] for k in keys]), Q, 10)]

    tickets = [engine.search(q) for q in Q]
    engine.pump()
    lab_e = np.stack([t.result()[0] for t in tickets])
    lab_b = T.batch_knn(params, baseline, torch.from_numpy(Q), 10)[0].numpy()
    rec_e = np.mean([len(set(lab_e[i]) & set(gt[i])) / 10
                     for i in range(len(Q))])
    rec_b = np.mean([len(set(lab_b[i]) & set(gt[i])) / 10
                     for i in range(len(Q))])
    assert rec_e >= rec_b - 0.02, (rec_e, rec_b)
    assert rec_e > 0.8, rec_e


def _engine_script(n, d, seed=0):
    """One stream of client calls for both engines: queries interleaved
    with deletes, replaces (one label twice in a drain, which the wave
    executor dedupes), inserts once consolidation has freed slots, deletes
    left pending for the next consolidation, and pumps, one of them
    limited to 5 ops (a bucket of 8 with 3 no-ops)."""
    rng = np.random.default_rng(seed)
    Q = clustered_vectors(24, d, seed=seed + 1)
    newX = clustered_vectors(40, d, seed=seed + 2)
    dels = rng.choice(n, 54, replace=False)
    qs = iter(Q)
    steps = []
    for i in range(20):                         # round 1: 20 deletes, 12 ru
        steps += [("d", int(dels[i]))]
        if i % 4 == 0:
            steps += [("q", next(qs))]
    for j in range(12):
        steps += [("r", newX[j], 1000 + (j if j != 7 else 3))]
    steps += [("pump", None), ("q", next(qs)), ("pump", None),
              ("q", next(qs)), ("pump", None)]
    for j in range(12, 24):                     # round 2: fresh slots
        steps += [("r", newX[j], 1000 + j), ("q", next(qs))]
    steps += [("i", newX[24 + j], 2000 + j) for j in range(4)]
    steps += [("d", int(dels[20 + i])) for i in range(12)]
    steps += [("pump", 5), ("q", next(qs)), ("pump", None), ("pump", None)]
    for j in range(28, 40):                     # round 3
        steps += [("d", int(dels[32 + j - 28])), ("r", newX[j], 1000 + j)]
    steps += [("q", next(qs)), ("pump", None), ("pump", None)]
    steps += [("d", int(x)) for x in dels[44:]]  # pending deletes only
    steps += [("q", next(qs)), ("pump", None), ("pump", None)]
    return steps


@pytest.mark.parametrize("execution,mode", [("wave", "graph"),
                                            ("sequential", "auto")])
def test_engine_matches_the_reference_engine(monkeypatch, small_params,
                                             small_index, small_data,
                                             execution, mode):
    """The reference's ``ServingEngine`` and the port's, side by side on the
    reference's graph with one stream of calls, the reference's draws fed to
    the port: every pump's ``PumpStats``, every published index and backup
    array for array, every served answer, and the metric counters and
    gauges equal. The stream drains in pow2 buckets over several pumps,
    crosses the tau threshold of the backup rebuild three times, and
    triggers consolidation and repair through the maintenance policy."""
    import repro.serving.update_queue as juq
    import repro_torch.serving.update_queue as puq
    from repro.core import MaintenancePolicy as JPolicy
    from repro.serving import ServingEngine as JEngine

    kw = dict(k=10, max_batch=8, max_ops_per_drain=16, tau=12,
              backup_capacity=32, track_unreachable=True, mode=mode,
              execution=execution)
    policy = dict(deleted_frac=0.01, min_deleted=8)
    seq, backups = Feed(), Feed()
    with record_wave_draws(monkeypatch) as wave_draws:
        waves = Feed(wave_draws)

        j_rebuild_backup = juq.rebuild_backup

        def j_backup(*a):
            b = j_rebuild_backup(*a)
            backups.append(allocated_levels(b))
            return b
        monkeypatch.setattr(juq, "rebuild_backup", j_backup)
        p_rebuild_backup = puq.rebuild_backup
        monkeypatch.setattr(puq, "rebuild_backup", lambda *a: p_rebuild_backup(
            *a, execution="sequential", levels=next(backups)))
        p_apply_plan = puq.apply_plan
        monkeypatch.setattr(puq, "apply_plan",
                            lambda p, ix, plan, variant, generator=None:
                            p_apply_plan(p, ix, plan, variant, draws=waves))
        p_sequential = puq.apply_update_batch_sequential

        def p_seq(p, ix, ops, labels, X, variant, generator=None):
            slots, levels = next(seq)
            return p_sequential(p, ix, ops, labels, X, variant, slots=slots,
                                levels=levels)
        monkeypatch.setattr(puq, "apply_update_batch_sequential", p_seq)

        ref = JEngine(small_params, small_index,
                      maintenance=JPolicy(**policy), **kw)
        if execution == "sequential":
            ref.scheduler._apply_fn = recording_sequential_draws(
                ref.scheduler._apply_fn, small_params, "mn_ru_gamma", seq)
        eng = ServingEngine(port_params(small_params), to_port(small_index),
                            maintenance=T.MaintenancePolicy(**policy), **kw)

        tickets, pumps = [], []
        n, d = small_data.shape
        for step in _engine_script(n, d):
            for e in (ref, eng):
                if step[0] == "q":
                    tickets.append((e is eng, e.search(step[1])))
                elif step[0] == "d":
                    e.delete(step[1])
                elif step[0] == "r":
                    e.update(step[1], step[2])
                elif step[0] == "i":
                    e.insert(step[1], step[2])
            if step[0] != "pump":
                continue
            rs, ps = ref.pump(step[1]), eng.pump(step[1])
            pumps.append(rs)
            assert dataclasses.asdict(ps) == dataclasses.asdict(rs)
            r_snap, p_snap = ref.snapshot(), eng.snapshot()
            assert_same_index(r_snap.index, p_snap.index)
            assert p_snap.has_backup and r_snap.has_backup
            assert_same_index(r_snap.backup, p_snap.backup)
    assert waves.spent and seq.spent and backups.spent
    assert sum(s.maintenance_ran for s in pumps) >= 2, pumps
    assert sum(s.backup_rebuilt for s in pumps) == 3, pumps
    assert len({s.updates_applied for s in pumps}) >= 3, pumps

    r_t = [t for port_side, t in tickets if not port_side]
    p_t = [t for port_side, t in tickets if port_side]
    assert len(p_t) == len(r_t) == 22 and all(t.done for t in p_t + r_t)
    for r, p in zip(r_t, p_t):
        assert p.epoch == r.epoch
        np.testing.assert_array_equal(p.result()[0], r.result()[0])
        np.testing.assert_allclose(p.result()[1], r.result()[1], rtol=1e-5,
                                   atol=1e-5)

    r_m, p_m = ref.stats(), eng.stats()
    assert p_m["counters"] == r_m["counters"]
    r_m["gauges"].pop("apply_cache_size")       # no compiled-program cache
    assert p_m["gauges"] == r_m["gauges"]
    assert ({k: h["count"] for k, h in p_m["histograms"].items()}
            == {k: h["count"] for k, h in r_m["histograms"].items()})


def test_engine_tau_backup_rebuild_in_maintenance_cycle(port, small_data):
    params, index = port
    n, d = small_data.shape
    engine = ServingEngine(params, index, k=10, tau=5, backup_capacity=32,
                           max_ops_per_drain=64)
    assert engine.snapshot().has_backup
    for dels, newX, news in _op_stream(n, d, 1, 25, seed=9):
        for dl in dels:
            engine.delete(int(dl))
        for x, nl in zip(newX, news):
            engine.update(x, int(nl))
    stats = engine.pump()
    while engine.update_backlog:
        stats = engine.pump()
    assert engine.metrics.counter("backup_rebuilds").value == 1
    assert engine.scheduler.applied_ru_ops == 25
    epoch = engine.epoch
    engine.pump()
    assert engine.metrics.counter("backup_rebuilds").value == 1
    assert engine.epoch == epoch
    t = engine.search(small_data[0])
    engine.pump()
    assert t.done and t.epoch == stats.epoch


def test_sharded_engine_raises_not_implemented(port, small_data):
    """The sharded engine, once unported, now serves a ``ShardedIndex``:
    the same answers as ``sharded_batch_knn``, updates routed to the owner
    shard; a plain index with ``mesh=`` raises ``TypeError``."""
    from repro_torch.core.distributed import build_sharded, sharded_batch_knn
    params, index = port
    mesh = [torch.device("cpu")]
    with pytest.raises(TypeError, match="build_sharded"):
        ServingEngine(params, index, mesh=mesh)
    sharded = build_sharded(params, small_data[:200], nshards=2, capacity=104,
                            devices=mesh)
    engine = ServingEngine(params, sharded, k=5, mesh=mesh)
    t = engine.search(small_data[10])
    engine.delete(10)
    engine.insert(small_data[10], 301)          # owner: shard 1
    engine.pump()
    want, _ = sharded_batch_knn(params, sharded, torch.from_numpy(
        small_data[10][None]), 5)
    np.testing.assert_array_equal(t.result()[0], want[0].numpy())
    t = engine.search(small_data[10])
    engine.pump()
    assert int(t.result()[0][0]) == 301 and 10 not in t.result()[0]
    assert int(engine.snapshot().index.shards[1].count) == 101
    assert int(sharded.shards[1].count) == 100   # the published one kept


def test_serve_cli_on_the_cpu(tmp_path):
    out = tmp_path / "m.json"
    rec = serve_cli.main(["--device", "cpu", "--n", "160", "--dim", "16",
                          "--queries", "8", "--rounds", "2",
                          "--updates-per-round", "10", "--backup", "--tau",
                          "5", "--ef", "48", "--mode", "graph",
                          "--metrics-json", str(out)])
    assert rec >= 0.9
    counters = json.loads(out.read_text())["counters"]
    assert counters["backup_rebuilds"] == 2        # one per round at tau 5
    assert counters["updates_applied"] == 40
