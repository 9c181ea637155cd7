"""The plain reference: its frozen generator, its agreement with the port
at a tiny size on the CPU, the judge's verdicts and the live-set replay.
(These tests may import the port; the reference itself never does.)"""
from __future__ import annotations

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from bench.updates import UpdateStream
from conftest import ROOT
from bench.reference import data as D
from bench.reference import exact
from conftest import ROOT


@pytest.mark.parametrize("seed,noise", [(0, None), (7, None), (3, 11),
                                        (2**31 + 5, 2**40)])
def test_frozen_generator_equals_the_programs(seed, noise):
    from repro_torch.data import clustered_vectors
    a = D.clustered_vectors(300, 24, seed=seed, noise_seed=noise)
    b = clustered_vectors(300, 24, seed=seed, noise_seed=noise)
    assert a.dtype == np.float32 and np.array_equal(a, b)


def test_stream_seeds_take_any_integer_and_differ():
    seeds = {D.stream_seed(s, k) for s in (0, 1, 2**31 + 7, -3, 10**19)
             for k in range(8)}
    assert len(seeds) == 40
    assert all(0 <= s < 2**63 for s in seeds)


def test_reference_imports_nothing_of_the_program():
    for p in (ROOT / "bench" / "reference").glob("*.py"):
        tree = ast.parse(p.read_text())
        mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
        mods |= {n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module and not n.level}
        tops = {m.split(".")[0] for m in mods}
        assert not tops & {"jax", "jaxlib", "flax", "repro", "repro_torch"}, p


def _tiny_index(space, n=3000, d=12, seed=5):
    from repro_torch import api
    X = D.clustered_vectors(n, d, seed=seed)
    vi = api.VectorIndex(space=space, dim=d, capacity=n, M=4, M0=8,
                         ef_construction=16, ef_search=32, device="cpu")
    vi.add_items(X)
    Q = D.clustered_vectors(40, d, seed=seed, noise_seed=9)
    return vi, X, Q


@pytest.mark.parametrize("space", ["l2", "cosine"])
def test_reference_agrees_with_the_ports_exact_tier(space):
    vi, X, Q = _tiny_index(space)
    labels, dists = vi.knn_query(Q, k=10, mode="exact")
    pool = exact.Pool.make(space, X, Q, "cpu")
    mask = torch.ones(len(X), dtype=torch.bool)
    rows, d = exact.exact_topk(pool, torch.arange(len(Q)), mask, 10)
    assert np.array_equal(rows.numpy(), labels)
    np.testing.assert_allclose(d.numpy(), dists, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("space", ["l2", "cosine"])
def test_judge_passes_the_ports_graph_answers(space):
    vi, X, Q = _tiny_index(space)
    labels, dists = vi.knn_query(Q, k=10, mode="graph")
    pool = exact.Pool.make(space, X, Q, "cpu")
    ans = exact.Answers(np.arange(len(Q)), np.zeros(len(Q), np.int64),
                        labels, dists)
    r = exact.judge(pool, [torch.ones(len(X), dtype=torch.bool)], ans, 10,
                    1e-5)
    assert r["short_rows"] == r["dup_labels"] == r["ineligible"] == 0
    assert r["failed_rows"] == 0 and r["dist_gap"] < 1e-5
    assert r["recall_miss"] < 0.3


def _exact_answers(space="l2", n=500, d=8):
    X = D.clustered_vectors(n, d, seed=1)
    Q = D.clustered_vectors(20, d, seed=1, noise_seed=2)
    pool = exact.Pool.make(space, X, Q, "cpu")
    allow = torch.from_numpy(np.arange(n) % 3 != 0)
    rows, dist = exact.exact_topk(pool, torch.arange(20), allow, 10)
    ans = exact.Answers(np.arange(20), np.zeros(20, np.int64),
                        rows.numpy().astype(np.int32),
                        dist.float().numpy())
    return pool, [allow], ans


def test_judge_of_exact_answers_is_clean():
    pool, groups, ans = _exact_answers()
    r = exact.judge(pool, groups, ans, 10, 1e-5)
    assert r["recall_miss"] == 0 and r["failed_rows"] == 0
    assert r["dist_gap"] < 1e-6


@pytest.mark.parametrize("fault,reading", [
    ("missing", "short_rows"), ("dup", "dup_labels"),
    ("off_filter", "ineligible"), ("wrong_dist", "dist_gap"),
    ("far", "recall_miss")])
def test_judge_sees_each_fault(fault, reading):
    pool, groups, ans = _exact_answers()
    clean = exact.judge(pool, groups, ans, 10, 1e-5)
    lab, dst = ans.labels.copy(), ans.dists.copy()
    if fault == "missing":
        lab[:10] = -1
        dst[:10] = np.inf
    elif fault == "dup":
        lab[:, 1] = lab[:, 0]
        dst[:, 1] = dst[:, 0]
    elif fault == "off_filter":
        lab[:, 9] = 0                    # label 0 is outside the filter
    elif fault == "wrong_dist":
        dst[3, 4] *= 1.001
    elif fault == "far":
        far = np.argsort(-((pool.X64[:, None, :] - pool.Q64[None]) ** 2)
                         .sum(-1).numpy(), axis=0)[:, :20]
        far = far[groups[0].numpy()[far[:, 0]]][:10].T
        lab[:] = far
        dst[:] = exact.point_dists("l2", pool.Q64, pool.X64[
            torch.from_numpy(far.astype(np.int64))]).numpy()
    bad = exact.judge(pool, groups, exact.Answers(ans.qidx, ans.gidx, lab,
                                                  dst), 10, 1e-5)
    assert bad[reading] > clean[reading]
    assert bad["failed_rows"] > 0 or fault == "far"


def test_live_set_replay():
    s = UpdateStream(seed=3, n0=10, d=4, root=ROOT, spec={
        "labels": {"draw": "uniform"}, "rows": {"draw": "mixture"}})
    ups = [s.next() for _ in range(25)]
    birth, death = s.birth_death()
    assert len(birth) == 35 and s.rows().shape == (25, 4)
    live = set(range(10))
    for i, (old, new, _) in enumerate(ups):
        assert old in live
        live.discard(old)
        live.add(new)
        # after the delete (op 2i+1 applied) and after the replace (2i+2)
        got = set(np.nonzero(exact.live_mask(birth, death, 2 * i + 2))[0])
        assert got == live
    assert len(live) == 10


def test_control_is_the_reference_in_tf32():
    pool, groups, ans = _exact_answers()
    ctrl = exact.control_answers(pool, groups, ans, 10)
    assert ctrl.labels.shape == ans.labels.shape
    # on the CPU the control's matrix products are float32: it differs from
    # the reference by rounding only
    r = exact.judge(pool, groups, ctrl, 10, 1.0)
    assert r["ineligible"] == 0 and r["dist_gap"] < 1e-4
