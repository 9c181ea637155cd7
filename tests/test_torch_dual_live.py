"""dualSearch serves only labels live in the main index it merges with.

Between two backup rebuilds the main index deletes and replaces points the
backup still holds, and ``replaced_update`` reuses a freed slot under a new
label. The port's ``batch_dual_search`` drops every backup hit whose label
is no longer live in main; held here to the plain reference
``tests/dual_search_ref.py`` on the port's own two ``batch_knn`` results,
and, with nothing deleted since the rebuild, to the JAX reference's
``batch_dual_search``. The reference keeps its behaviour (it merges every
backup hit).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import HNSWParams as JParams
from repro.core import batch_dual_search as j_dual
from repro.core.index import HNSWIndex as JIndex
from repro.data import clustered_vectors

import repro_torch.core as T
from repro_torch.serving import ServingEngine
from dual_search_ref import dual_merge, eligible
from torch_parity import FIELDS

K = 10
PARAMS = dict(M=4, M0=8, num_layers=3, ef_construction=24, ef_search=24)


def _live(index) -> set:
    ok = (index.levels >= 0) & ~index.deleted
    return set(index.labels[ok].tolist())


def _to_ref(index) -> JIndex:
    """The port's arrays as the reference's index (bf16 bits kept)."""
    a = T.to_arrays(index)
    out = {}
    for f in FIELDS:
        v = np.asarray(a[f])
        if f == "vectors" and index.vectors.dtype == torch.bfloat16:
            v = v.view(np.uint16).view(jnp.bfloat16)
        out[f] = jnp.asarray(v)
    return JIndex(**out)


def _main_and_backup(space, dtype, n=320, cut_n=24, seed=3):
    """A built index with the in-edges of ``cut_n`` points cut, and its
    backup rebuilt over every unreachable point."""
    p = T.HNSWParams(space=space, **PARAMS)
    X = torch.from_numpy(clustered_vectors(n, 16, n_clusters=8, seed=seed))
    main = T.build(p, X.to(dtype), capacity=n + 16, execution="wave",
                   device="cpu", generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    cut = rng.choice(np.setdiff1d(np.arange(n), [int(main.entry)]), cut_n,
                     replace=False)
    nb = main.neighbors
    nb[torch.isin(nb, torch.from_numpy(cut).to(nb.dtype))] = -1
    backup = T.rebuild_backup(p, main, 64, seed=1)
    assert int(backup.count) >= cut_n
    return p, main, backup


def _queries(index, labels, seed):
    """Queries next to the points holding ``labels`` now, and a few more."""
    g = torch.Generator().manual_seed(seed)
    slots = [int(T.slot_of_label(index, lab)) for lab in labels]
    base = index.vectors[slots].float()
    extra = index.vectors[torch.randint(0, 300, (6,), generator=g)].float()
    Q = torch.cat([base, extra])
    return Q + 0.01 * torch.randn(Q.shape, generator=g)


def _candidates(p, main, backup, Q):
    lm, _, dm = T.batch_knn(p, main, Q, K)
    lb, _, db = T.batch_knn(p, backup, Q, K)
    return lm, dm, lb, db


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("space", ["l2", "ip"])
def test_dual_search_serves_only_live_labels(space, dtype):
    p, main, backup = _main_and_backup(space, dtype)
    held = backup.labels[:int(backup.count)].tolist()
    Q = _queries(main, held[:16], seed=5)

    # (d) nothing deleted since the rebuild: the reference's answer (labels
    # equal; distances to the parity tests' 1e-5, as both packages compute
    # them in their own order of operations)
    jp = JParams(**dataclasses.asdict(p))
    rl, rd = j_dual(jp, _to_ref(main), jp, _to_ref(backup),
                    jnp.asarray(Q.numpy()), K)
    pl, pd = T.batch_dual_search(p, main, p, backup, Q, K)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(rl))
    np.testing.assert_allclose(pd.numpy(), np.asarray(rd), rtol=1e-5,
                               atol=1e-5)

    # delete labels the backup holds: half only mark-deleted, half replaced
    # into the slot they freed, so that the slot holds a new label
    gone = held[:16]
    reused = 0
    for i, lab in enumerate(gone):
        slot = int(T.slot_of_label(main, lab))
        T.mark_delete(main, lab)
        if i % 2:
            x = main.vectors[(slot + 7) % 300].float() + 0.05
            T.replaced_update(p, main, x, 5000 + i, slot=slot, level=0)
            reused += int(main.labels[slot]) == 5000 + i
    assert reused == len(gone) // 2
    live = _live(main)
    assert not live & set(gone)

    lm, dm, lb, db = _candidates(p, main, backup, Q)
    assert set(lb[lb >= 0].tolist()) - live     # the filter has work
    pl, pd = T.batch_dual_search(p, main, p, backup, Q, K)
    # (a) the plain reference on the port's own candidates
    rl, rd = dual_merge(lm, dm, lb, db, live, K)
    np.testing.assert_array_equal(pl.long().numpy(), rl.numpy())
    np.testing.assert_allclose(pd.numpy(), rd.numpy(), rtol=0, atol=1e-6)
    # (b) no dead label served
    served = pl[pl >= 0].tolist()
    assert set(served) <= live
    # (c) each row holds min(k, eligible) labels
    n_row = (pl >= 0).sum(1).tolist()
    assert n_row == [min(K, e) for e in eligible(lm, lb, live)]



def test_dual_search_refuses_a_backup_without_source():
    """A backup not made by ``rebuild_backup`` / ``empty_backup`` has no
    source slots to hold its hits live against."""
    p, main, backup = _main_and_backup("l2", torch.float32, n=64, cut_n=4)
    backup.source = None
    with pytest.raises(ValueError, match="source"):
        T.batch_dual_search(p, main, p, backup, main.vectors[:2].float(), K)

MERGE_CASES = {
    # main's hits, backup's hits, live labels, expected labels (k = 3)
    "dead_backup_hit": (([1, 2, 3], [1.0, 4.0, 6.0]),
                        ([9, 8, -1], [0.5, 5.0, float("inf")]),
                        {1, 2, 3, 8}, [1, 2, 8]),
    "label_in_both": (([1, 2, 3], [1.0, 4.0, 6.0]),
                      ([2, 7, -1], [0.5, 2.0, float("inf")]),
                      {1, 2, 3, 7}, [1, 7, 2]),
    "slot_reused_under_new_label": (([50, 2, 3], [0.25, 4.0, 6.0]),
                                    ([5, 6, -1], [0.5, 1.5, float("inf")]),
                                    {50, 2, 3, 6}, [50, 6, 2]),
    "fewer_than_k_eligible": (([1, -1, -1], [1.0, float("inf"),
                                             float("inf")]),
                              ([1, 4, -1], [1.0, 2.0, float("inf")]),
                              {1}, [1, -1, -1]),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_reference_merge_by_hand(case):
    (ml, md), (bl, bd), live, want = MERGE_CASES[case]
    labels, dists = dual_merge(torch.tensor([ml]), torch.tensor([md]),
                               torch.tensor([bl]), torch.tensor([bd]),
                               live, 3)
    assert labels[0].tolist() == want
    assert torch.isinf(dists[0][labels[0] < 0]).all()
    assert torch.isfinite(dists[0][labels[0] >= 0]).all()


def test_engine_serves_no_dead_label_at_its_epoch():
    """The engine at tau 12 with a backup: every served label is live at
    its ticket's epoch, held against a replay of the ops the engine
    published; the backup's spans and counters appear in ``report()``."""
    p, main, _ = _main_and_backup("l2", torch.float32, seed=11)
    engine = ServingEngine(p, main, k=K, tau=12, backup_capacity=64,
                           max_batch=16, max_ops_per_drain=16, mode="graph")
    vec = {int(lab): main.vectors[s].clone()
           for s, lab in enumerate(main.labels.tolist()) if lab >= 0}
    ops, applied, at_epoch = [], 0, {engine.epoch: 0}
    tickets, new_label = [], 9000
    rng = np.random.default_rng(0)

    def pump():
        nonlocal applied
        st = engine.pump()
        applied += st.updates_applied
        at_epoch[st.epoch] = applied

    for _ in range(6):                        # 24 replaces: 2 rebuilds
        snap = engine.snapshot()
        held = snap.backup.labels[:int(snap.backup.count)].tolist()
        alive = sorted(_live(snap.index))
        pick = [x for x in held if x in set(alive)][:3]
        pick += rng.choice([x for x in alive if x not in pick],
                           4 - len(pick), replace=False).tolist()
        for lab in pick:                      # delete + replace
            x = vec[lab] + 0.02
            engine.delete(lab)
            engine.update(x.numpy(), new_label)
            ops += [("d", lab), ("r", new_label)]
            vec[new_label] = x
            new_label += 1
        pump()                                # drains; maybe rebuilds
        for lab in pick + held[:4]:           # served next pump
            tickets.append(engine.search(vec[lab].numpy() + 0.01))
        pump()
    while engine.update_backlog or engine.query_backlog:
        pump()

    start = set(vec) - {lab for op, lab in ops if op == "r"}

    def live_after(n):
        live = set(start)
        for op, lab in ops[:n]:
            (live.discard if op == "d" else live.add)(lab)
        return live

    assert engine.scheduler.rebuilds >= 2
    for t in tickets:
        assert t.done
        labels = t.labels[t.labels >= 0].tolist()
        assert len(labels) == K
        assert set(labels) <= live_after(at_epoch[t.epoch]), t.epoch
    counters = engine.stats()["counters"]
    assert counters["backup_dead_dropped"] > 0
    assert counters["backup_hits_served"] > 0
    rep = engine.metrics.report()
    for name in ("backup.rebuild", "backup.sweep", "search.dual",
                 "backup_hits_served", "backup_dead_dropped"):
        assert name in rep, name
    rb = engine.metrics.spans("backup.rebuild")
    assert rb and rb[0].attrs["points"] > 0
    assert all(s.attrs["capacity"] == 64 for s in rb)
    assert all(s.under("backup.rebuild")
               for s in engine.metrics.spans("backup.sweep"))
    dual = engine.metrics.spans("search.dual")
    assert sum(s.attrs["backup_hits"] for s in dual) == \
        counters["backup_hits_served"]
    assert all(s.under("batcher.batch") for s in dual)
    assert any(s.under("search.dual")
               for s in engine.metrics.spans("search.layer"))
