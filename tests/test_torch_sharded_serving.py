"""The port's sharded serving engine (``ServingEngine(mesh=...)``).

The reference's ``tests/test_serving.py::test_sharded_engine_subprocess``
fails on this tree (its ``sharded_update`` trips jax 0.9.0's sharding
assertion, see ``tests/test_torch_distributed.py``), so its assertions run
here in process on the port; then, with the reference's draws fed in,
every pump leaves each shard equal to the reference's single-index
functions applied to that shard over the ops routed to it, and the summed
unreachable gauges equal the reference's per-shard ``count_unreachable``.
"""
import numpy as np
import pytest
import torch

from repro.core import HNSWParams
from repro.core import count_unreachable as j_count
from repro.data import clustered_vectors

import repro_torch.core as T
import repro_torch.serving.engine as engine_mod
from repro_torch.core.distributed import (ShardedIndex, build_sharded,
                                          sharded_batch_knn)
from repro_torch.serving import ServingEngine
from torch_parity import assert_same_index, port_params, ref_route, ref_shard

CPU = [torch.device("cpu")]
PARAMS = HNSWParams(M=8, M0=16, num_layers=3, ef_construction=48,
                    ef_search=48)


@pytest.fixture(scope="module")
def base():
    """The reference script's index: 400 points on 4 shards of 104 slots."""
    X = clustered_vectors(400, 16, seed=0)
    sharded = build_sharded(port_params(PARAMS), X, nshards=4, capacity=104,
                            devices=CPU)
    return X, sharded.stacked_arrays()


def _engine(arrays, **kw):
    sharded = ShardedIndex.from_stacked(arrays, CPU)
    kw = dict(dict(k=10, max_batch=8, max_ops_per_drain=8), **kw)
    return ServingEngine(port_params(PARAMS), sharded, mesh=CPU * 4, **kw)


def test_sharded_engine_script(base):
    """``SHARDED_SCRIPT`` of ``tests/test_serving.py``, in process."""
    X, arrays = base
    engine = _engine(arrays)
    assert engine.snapshot().index.devices == CPU * 4

    t0 = engine.search(X[3])
    engine.delete(3)
    xnew = clustered_vectors(1, 16, seed=2)[0]
    engine.update(xnew, 403)          # owner shard = 403 % 4 = 3
    engine.pump()
    assert 3 in t0.result()[0].tolist()            # pre-delete epoch
    t1 = engine.search(xnew)
    t2 = engine.search(X[3])
    engine.pump()
    assert int(t1.result()[0][0]) == 403, t1.result()
    assert 3 not in t2.result()[0].tolist()

    # a fresh insert takes a FREE slot on the owner shard, not a deleted one
    engine.delete(7)                  # leaves a tombstone on shard 3
    xins = clustered_vectors(1, 16, seed=4)[0]
    engine.insert(xins, 407)          # owner shard = 3, same as the tombstone
    engine.pump()
    t3 = engine.search(xins)
    engine.pump()
    assert int(t3.result()[0][0]) == 407, t3.result()
    shard3 = engine.snapshot().index.shards[3]
    slot7 = int(torch.argmax((shard3.labels == 7).to(torch.uint8)))
    assert bool(shard3.deleted[slot7])           # tombstone NOT consumed
    assert int(shard3.count) == 101              # grew into a free slot
    assert engine.epoch == 2                     # two pumps wrote


def _stream(X):
    """(kind, payload) steps: queries, deletes, replaces under the deleted
    labels' owners, fresh inserts, and pumps of pow2-bucketed drains."""
    rng = np.random.default_rng(8)
    newX = clustered_vectors(24, 16, seed=31)
    steps, nxt = [], 1000
    dels = rng.choice(400, 16, replace=False)
    for r in range(4):
        for j in range(4):
            d = int(dels[4 * r + j])
            steps.append(("q", X[d]))
            steps.append(("d", d))
            new = nxt + (d % 4)                 # same owner as the delete
            nxt += 4
            steps.append(("r", newX[4 * r + j], new))
        steps.append(("i", newX[16 + 2 * r], nxt + 1))
        steps.append(("i", newX[17 + 2 * r], nxt + 2))
        nxt += 4
        steps.append(("q", newX[4 * r]))
        steps.append(("pump", None))
    steps.append(("pump", None))
    return steps


def test_sharded_engine_matches_the_reference_per_shard(monkeypatch, base):
    """Every routed op is mirrored on the reference's slices of the owner
    shards (its draws fed to the port); after each pump every shard equals
    its mirror, and the unreachable gauges equal the reference's per-shard
    counts, summed."""
    X, arrays = base
    mirror = [ref_shard(arrays, s) for s in range(4)]
    real = engine_mod.sharded_update
    routed = []

    def fed(params, sharded, dl, x, nl, variant, fresh_insert=False, *,
            generator=None):
        slot, level = ref_route(PARAMS, mirror, int(dl), np.asarray(x),
                                int(nl), variant, fresh_insert)
        routed.append((int(dl), int(nl), fresh_insert))
        return real(params, sharded, dl, x, nl, variant, fresh_insert,
                    slot=slot, level=level)
    monkeypatch.setattr(engine_mod, "sharded_update", fed)
    engine = _engine(arrays, track_unreachable=True)

    tickets, snaps = [], {0: engine.snapshot()}
    for step in _stream(X):
        kind = step[0]
        if kind == "q":
            tickets.append(engine.search(step[1]))
        elif kind == "d":
            engine.delete(step[1])
        elif kind == "r":
            engine.update(step[1], step[2])
        elif kind == "i":
            engine.insert(step[1], step[2])
        else:
            stats = engine.pump()
            snaps[engine.epoch] = engine.snapshot()
            snap = engine.snapshot().index
            for s in range(4):
                assert_same_index(mirror[s], snap.shards[s])
            if stats.updates_applied:
                g = engine.stats()["gauges"]
                counts = [j_count(m) for m in mirror]
                assert g["unreachable_indegree"] == sum(int(c[0])
                                                        for c in counts)
                assert g["unreachable_bfs"] == sum(int(c[1]) for c in counts)
    # deletes route alone, inserts and replaces carry their fresh flag
    assert sum(1 for dl, nl, _ in routed if dl >= 0 and nl < 0) == 16
    assert sum(1 for dl, nl, f in routed if dl < 0 and f) == 8
    assert sum(1 for dl, nl, f in routed if dl < 0 and not f) == 16
    assert engine.update_backlog == 0 and all(t.done for t in tickets)
    # each ticket: the sharded search of its epoch's (unchanged) snapshot
    assert {t.epoch for t in tickets} == {0, 1, 2, 3}
    for t in tickets:
        lbl, _ = sharded_batch_knn(port_params(PARAMS), snaps[t.epoch].index,
                                   torch.from_numpy(t.vector[None]), 10)
        np.testing.assert_array_equal(t.result()[0], lbl[0].numpy())
    final = engine.snapshot()
    # fresh inserts grew their owners; replaces reused the tombstones
    counts = [int(ix.count) for ix in final.index.shards]
    assert sum(counts) == 400 + 8
    assert sum(T.num_deleted(ix) for ix in final.index.shards) == 0


@pytest.mark.parametrize("kw,match", [
    (dict(mode="exact"), "exact scan tier"),
    (dict(tau=4, backup_capacity=16), "backup/dualSearch"),
    (dict(maintenance=T.MaintenancePolicy()), "maintenance policies"),
], ids=["exact", "backup", "maintenance"])
def test_sharded_engine_rejects_single_index_features(base, kw, match):
    _, arrays = base
    with pytest.raises(ValueError, match=match):
        _engine(arrays, **kw)


def test_sharded_engine_needs_a_sharded_index(base):
    _, arrays = base
    single = T.from_arrays({f: a[0] for f, a in arrays.items()},
                           device="cpu")
    with pytest.raises(TypeError, match="build_sharded"):
        ServingEngine(port_params(PARAMS), single, mesh=CPU)
    # auto pins the graph tier on the sharded engine
    engine = _engine(arrays, mode="auto")
    assert engine.batcher.mode == "graph"
