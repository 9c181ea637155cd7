"""Port vs reference: the wave executor (tape compiler, wave build, wave
churn), on both candidate tiers, with the reference's draws fed in.

The arrays come out identical: both sides sort stably, break top-k ties to
the lowest slot, and take the same level and cursor draws.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.batch_update as jbu
from repro.data import clustered_vectors

import repro_torch.core as T
import repro_torch.core.batch_update as tbu
from torch_parity import (OP_DELETE, OP_INSERT, OP_REPLACE, assert_same_index,
                          port_params, record_wave_draws)

WAVES = dict(min_wave=32, max_wave=64)   # two pow2 buckets: few compiles
BEAM_LIMIT = 1 << 12                     # W * N above this takes the beam tier


def _same_plan(a, b):
    np.testing.assert_array_equal(a.del_labels, b.del_labels)
    assert a.deduped == b.deduped and a.num_waves == b.num_waves
    for wa, wb in zip(a.waves, b.waves):
        for x, y in zip(wa, wb):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("built", [0, 5, 100, 5000])
@pytest.mark.parametrize("seed", [0, 1])
def test_compile_tape_identical_plan(built, seed):
    rng = np.random.default_rng(seed)
    T_ = 300
    ops = rng.choice([0, OP_DELETE, OP_REPLACE, OP_INSERT], size=T_,
                     p=[0.1, 0.3, 0.4, 0.2]).astype(np.int32)
    labels = rng.integers(0, 150 if seed else 10_000, T_).astype(np.int32)
    X = rng.normal(size=(T_, 4)).astype(np.float32)
    for kw in ({}, WAVES):
        _same_plan(jbu.compile_tape(ops, labels, X, built=built, **kw),
                   tbu.compile_tape(ops, labels, X, built=built, **kw))


def test_group_pairs_and_batched_prune_identical():
    rng = np.random.default_rng(2)
    e = rng.integers(0, 40, 200)
    e[rng.random(200) < 0.2] = 40                      # invalid -> dropped
    c = rng.integers(0, 1000, 200)
    d = rng.random(200).astype(np.float32)
    d[::17] = d[3]                                     # ties keep tape order
    ri, rd = jbu._group_pairs_by_target(jnp.asarray(e, jnp.int32),
                                        jnp.asarray(c, jnp.int32),
                                        jnp.asarray(d), 40, 6)
    pi, pd = tbu._group_pairs_by_target(torch.from_numpy(e),
                                        torch.from_numpy(c),
                                        torch.from_numpy(d), 40, 6)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(rd))

    ids = rng.integers(-1, 30, (9, 20)).astype(np.int32)
    vecs = rng.normal(size=(9, 20, 6)).astype(np.float32)
    dq = np.where(ids >= 0, rng.random((9, 20)), np.inf).astype(np.float32)
    for alpha in (1.0, 1.1):
        r = jbu._batched_rng_prune(jnp.asarray(ids), jnp.asarray(vecs),
                                   jnp.asarray(dq), 8, alpha, "l2")
        p = tbu._batched_rng_prune(torch.from_numpy(ids),
                                   torch.from_numpy(vecs),
                                   torch.from_numpy(dq), 8, alpha, "l2")
        np.testing.assert_array_equal(p[0].numpy(), np.asarray(r[0]))


def _build_both(monkeypatch, params, X, limit):
    monkeypatch.setattr(jbu, "SCAN_TIER_MAX_ELEMS", limit)
    with record_wave_draws(monkeypatch) as draws:
        ref = jbu.build_batch(params, jnp.asarray(X), **WAVES)
    port = tbu.build_batch(port_params(params), X, draws=draws,
                           scan_max_elems=limit, device="cpu", **WAVES)
    return ref, port


def _churn_tape(n, k, seed, inserts=0):
    """k deletes, then k - inserts replaces and ``inserts`` inserts (on a
    full index the inserts spill into mark-deleted slots)."""
    rng = np.random.default_rng(seed)
    dels = rng.choice(n, k, replace=False)
    ops = np.array([OP_DELETE] * k + [OP_REPLACE] * (k - inserts)
                   + [OP_INSERT] * inserts, np.int32)
    labels = np.concatenate([dels, 10_000 + np.arange(k)]).astype(np.int32)
    X = np.concatenate([np.zeros((k, 16), np.float32),
                        clustered_vectors(k, 16, n_clusters=8, seed=seed)])
    return ops, labels, X


def _churn_both(monkeypatch, params, ref, port, variant, tape, limit):
    monkeypatch.setattr(jbu, "SCAN_TIER_MAX_ELEMS", limit)
    with record_wave_draws(monkeypatch) as draws:
        ref = jbu.apply_update_batch_wave(params, ref, *tape, variant,
                                          **WAVES)
    tbu.apply_update_batch_wave(port_params(params), port, *tape, variant,
                                draws=draws, scan_max_elems=limit, **WAVES)
    return ref, port


@pytest.mark.parametrize("tier", ["scan", "beam"])
def test_wave_build_and_churn_identical(monkeypatch, small_params, tier):
    limit = jbu.SCAN_TIER_MAX_ELEMS if tier == "scan" else BEAM_LIMIT
    X = clustered_vectors(400, 16, n_clusters=8, seed=12)
    ref, port = _build_both(monkeypatch, small_params, X, limit)
    assert_same_index(ref, port)
    variants = (["hnsw_ru", "mn_ru_gamma", "mn_thn_ru"] if tier == "scan"
                else ["mn_ru_gamma"])
    for i, variant in enumerate(variants):
        tape = _churn_tape(400, 40, seed=20 + i, inserts=8)
        r2, p2 = _churn_both(monkeypatch, small_params, ref, port.clone(),
                             variant, tape, limit)
        assert_same_index(r2, p2)
        assert int(p2.count) == 400 and T.num_deleted(p2) == 0


def test_wave_own_generator_recall(small_params):
    """Without draws the port uses its generator: recall stays high and
    the build is deterministic per seed."""
    p = port_params(small_params)
    X = clustered_vectors(1200, 16, n_clusters=8, seed=4)
    a = T.build(p, X, seed=3, device="cpu")              # auto -> waves
    b = tbu.build_batch(p, X, seed=3, device="cpu")
    np.testing.assert_array_equal(a.neighbors.numpy(), b.neighbors.numpy())
    Q = torch.from_numpy(X[:100] + 0.01)
    found, _, _ = T.batch_knn(p, a, Q, 1)
    assert (found[:, 0].numpy() == np.arange(100)).mean() >= 0.97
