"""The whole slice, port vs reference, at n = 2048, d = 16: wave build, two
rounds of 5% MN-RU-gamma churn, queries, unreachable counts, backup and
dualSearch.

Run once with the reference's draws fed in (the port must reproduce its
arrays and results) and once on the port's own generator (held to the
reference's recall within 0.02 and its BFS unreachable count within
max(3, 20%)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.batch_update as jbu
from repro.core import HNSWParams, batch_dual_search, batch_knn
from repro.core import count_unreachable, rebuild_backup
from repro.data import brute_force_knn, clustered_vectors

import repro_torch.core as T
from torch_parity import (OP_DELETE, OP_REPLACE, assert_same_index,
                          port_params, record_wave_draws, recall, ref_arrays)

N, D, K, ROUNDS, CHURN = 2048, 16, 10, 2, 102
PARAMS = HNSWParams(M=8, M0=16, num_layers=3, ef_construction=48,
                    ef_search=48)


def _workload():
    X = clustered_vectors(N, D, n_clusters=8, seed=0)
    Q = clustered_vectors(200, D, n_clusters=8, seed=0)[::-1].copy() + 0.02
    rng = np.random.default_rng(1)
    rounds, live = [], list(range(N))
    for r in range(ROUNDS):
        dels = rng.choice(live, CHURN, replace=False)
        new = N + r * CHURN + np.arange(CHURN)
        live = sorted(set(live) - set(dels.tolist())) + new.tolist()
        newX = clustered_vectors(CHURN, D, n_clusters=8, seed=10 + r)
        ops = np.array([OP_DELETE] * CHURN + [OP_REPLACE] * CHURN, np.int32)
        rounds.append((ops, np.concatenate([dels, new]).astype(np.int32),
                       np.concatenate([np.zeros_like(newX), newX])))
    all_X = np.concatenate([X] + [t[2][CHURN:] for t in rounds])
    live = np.asarray(live)
    truth = live[brute_force_knn(all_X[live], Q, K)]
    return X, Q, rounds, truth


@pytest.fixture(scope="module")
def reference():
    """The reference's run, with every draw recorded."""
    X, Q, rounds, truth = _workload()
    mp = pytest.MonkeyPatch()
    with record_wave_draws(mp) as build_draws:
        ix = jbu.build_batch(PARAMS, jnp.asarray(X))
    states, churn_draws = [ix], []
    for tape in rounds:
        with record_wave_draws(mp) as draws:
            ix = jbu.apply_update_batch_wave(PARAMS, ix, *tape, "mn_ru_gamma")
        states.append(ix)
        churn_draws.append(draws)
    mp.undo()
    labels, ids, dists = batch_knn(PARAMS, ix, jnp.asarray(Q), K)
    backup = rebuild_backup(PARAMS, ix, 64, jnp.uint32(1))
    dual = batch_dual_search(PARAMS, ix, PARAMS, backup, jnp.asarray(Q), K)
    jax.block_until_ready(dual)
    return dict(X=X, Q=Q, rounds=rounds, truth=truth, states=states,
                build_draws=build_draws, churn_draws=churn_draws,
                knn=(labels, ids, dists), counts=count_unreachable(ix),
                backup=backup, dual=dual)


def test_slice_with_reference_draws(reference):
    r = reference
    p = port_params(PARAMS)
    ix = T.build_batch(p, r["X"], draws=r["build_draws"], device="cpu")
    assert_same_index(r["states"][0], ix)
    for tape, draws, state in zip(r["rounds"], r["churn_draws"],
                                  r["states"][1:]):
        T.apply_update_batch(p, ix, *tape, "mn_ru_gamma", execution="wave",
                             draws=draws)
        assert_same_index(state, ix)
    Q = torch.from_numpy(r["Q"])
    labels, ids, dists = T.batch_knn(p, ix, Q, K)
    rl, ri, rd = (np.asarray(a) for a in r["knn"])
    np.testing.assert_array_equal(labels.numpy(), rl)
    np.testing.assert_array_equal(ids.numpy(), ri)
    np.testing.assert_allclose(dists.numpy(), rd, rtol=1e-5, atol=1e-5)
    assert T.count_unreachable(ix) == tuple(int(c) for c in r["counts"])
    n_valid = int(r["backup"].count)
    backup = T.rebuild_backup(p, ix, 64, seed=1, execution="sequential",
                              levels=ref_arrays(r["backup"])["levels"][
                                  :n_valid])
    assert_same_index(r["backup"], backup)
    dl, dd = T.batch_dual_search(p, ix, p, backup, Q, K)
    np.testing.assert_array_equal(dl.numpy(), np.asarray(r["dual"][0]))
    np.testing.assert_allclose(dd.numpy(), np.asarray(r["dual"][1]),
                               rtol=1e-5, atol=1e-5)


def test_slice_with_own_generator(reference):
    r = reference
    p = port_params(PARAMS)
    gen = torch.Generator().manual_seed(123)
    ix = T.build(p, r["X"], execution="wave", generator=gen, device="cpu")
    for tape in r["rounds"]:
        T.apply_update_batch(p, ix, *tape, "mn_ru_gamma", generator=gen)
    Q = torch.from_numpy(r["Q"])
    labels, _, _ = T.batch_knn(p, ix, Q, K)
    ref_recall = recall(np.asarray(r["knn"][0]), r["truth"])
    port_recall = recall(labels.numpy(), r["truth"])
    assert abs(port_recall - ref_recall) <= 0.02, (port_recall, ref_recall)
    ref_bfs = int(r["counts"][1])
    port_bfs = T.count_unreachable(ix)[1]
    assert abs(port_bfs - ref_bfs) <= max(3, 0.2 * ref_bfs)
    backup = T.rebuild_backup(p, ix, 64, generator=gen)
    dual, _ = T.batch_dual_search(p, ix, p, backup, Q, K)
    assert recall(dual.numpy(), r["truth"]) >= port_recall
