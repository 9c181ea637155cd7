"""Port vs reference: beam search, exact scan and the planner on graphs the
reference built (handed over in the npz layout)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batch_knn, build
from repro.core.planner import (exact_scan as j_exact_scan,
                                plan_and_search as j_plan_and_search)
from repro.data import clustered_vectors

import repro_torch.core as T
from torch_parity import port_params, to_port

DIST_TOL = 1e-5     # f32 distances summed in a different order


@pytest.fixture(scope="module")
def graphs(small_params, small_index, small_data):
    """One reference-built graph per metric space (ip/cosine on unit rows,
    as the facade normalises cosine at ingest)."""
    unit = small_data / np.linalg.norm(small_data, axis=1, keepdims=True)
    out = {"l2": (small_params, small_index, small_data)}
    for space in ("ip", "cosine"):
        p = dataclasses.replace(small_params, space=space)
        out[space] = (p, build(p, jnp.asarray(unit)), unit)
    return out


def _queries(data, n=24, seed=5):
    rng = np.random.default_rng(seed)
    Q = data[rng.choice(len(data), n, replace=False)]
    return (Q + 0.05 * rng.normal(size=Q.shape)).astype(np.float32)


def _compare(ref_out, port_out):
    rl, ri, rd = (np.asarray(a) for a in ref_out)
    pl, pi, pd = (t.numpy() for t in port_out)
    np.testing.assert_array_equal(pl, rl)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_allclose(pd, rd, rtol=DIST_TOL, atol=DIST_TOL)


@pytest.mark.parametrize("space", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("filtered", [False, True])
def test_batch_knn_identical(graphs, space, filtered):
    p, ref, data = graphs[space]
    Q = _queries(data)
    allow = None
    if filtered:
        allow = np.random.default_rng(2).random(ref.capacity) < 0.4
    ref_out = batch_knn(p, ref, jnp.asarray(Q), 10, None,
                        None if allow is None else jnp.asarray(allow))
    port_out = T.batch_knn(port_params(p), to_port(ref), torch.from_numpy(Q),
                           10, None,
                           None if allow is None else torch.from_numpy(allow))
    _compare(ref_out, port_out)


def test_batch_knn_skips_deleted_and_honours_ef(graphs):
    p, ref, data = graphs["l2"]
    deleted = np.zeros(ref.capacity, bool)
    deleted[::7] = True
    ref_d = dataclasses.replace(ref, deleted=jnp.asarray(deleted))
    Q = _queries(data, seed=9)
    for ef in (16, 64):
        ref_out = batch_knn(p, ref_d, jnp.asarray(Q), 12, ef)
        port_out = T.batch_knn(port_params(p), to_port(ref_d),
                               torch.from_numpy(Q), 12, ef)
        _compare(ref_out, port_out)
        assert not np.isin(port_out[1].numpy(), np.nonzero(deleted)[0]).any()


@pytest.mark.parametrize("space", ["l2", "ip"])
def test_exact_scan_identical(graphs, space):
    p, ref, data = graphs[space]
    deleted = np.zeros(ref.capacity, bool)
    deleted[3::5] = True
    ref_d = dataclasses.replace(ref, deleted=jnp.asarray(deleted))
    allow = np.random.default_rng(4).random(ref.capacity) < 0.5
    Q = _queries(data, seed=11)
    for a in (None, allow):
        ref_out = j_exact_scan(p, ref_d, jnp.asarray(Q), 10,
                               None if a is None else jnp.asarray(a))
        port_out = T.exact_scan(port_params(p), to_port(ref_d),
                                torch.from_numpy(Q), 10,
                                None if a is None else torch.from_numpy(a))
        _compare(ref_out, port_out)


def test_plan_and_search_same_decisions_and_results(small_params):
    """Across the three exact-tier triggers and the graph tier."""
    X = clustered_vectors(2100, 8, n_clusters=4, seed=3)
    p = dataclasses.replace(small_params, ef_construction=32)
    ref = build(p, jnp.asarray(X), execution="sequential")
    Q = X[:6] + 0.01
    heavy = np.zeros(ref.capacity, bool)
    heavy[:1200] = True
    rare = np.zeros(ref.capacity, bool)
    rare[:50] = True
    cases = [(ref, None, "auto"), (ref, None, "exact"), (ref, None, "graph"),
             (dataclasses.replace(ref, deleted=jnp.asarray(heavy)), None,
              "auto"), (ref, rare, "auto")]
    for ix, allow, mode in cases:
        rl, ri, rd, rdec = j_plan_and_search(
            p, ix, jnp.asarray(Q), 5, allow=None if allow is None
            else jnp.asarray(allow), mode=mode)
        pl, pi, pd, pdec = T.plan_and_search(
            port_params(p), to_port(ix), torch.from_numpy(Q), 5,
            allow=None if allow is None else torch.from_numpy(allow),
            mode=mode)
        assert (pdec.tier, pdec.reason) == (rdec.tier, rdec.reason)
        assert dataclasses.asdict(pdec.stats) == dataclasses.asdict(rdec.stats)
        _compare((rl, ri, rd), (pl, pi, pd))
    with pytest.raises(ValueError, match="unknown query mode"):
        T.plan_and_search(port_params(p), to_port(ref), torch.from_numpy(Q),
                          5, mode="fast")


def test_single_query_and_greedy_descent(graphs):
    from repro.core import greedy_layer as j_greedy
    p, ref, data = graphs["l2"]
    port = to_port(ref)
    Q = _queries(data, n=6, seed=13)
    q = torch.from_numpy(Q[0])
    labels, ids, dists = T.knn_search(port_params(p), port, q, 5)
    bl, bi, bd = T.batch_knn(port_params(p), port, q[None], 5)
    assert labels.tolist() == bl[0].tolist() and ids.tolist() == bi[0].tolist()
    ep = int(ref.entry)
    for layer in range(1, int(ref.max_layer) + 1):
        want = [int(j_greedy(p, ref, jnp.asarray(x), jnp.int32(ep), layer))
                for x in Q]
        got = T.greedy_layer(port_params(p), port, torch.from_numpy(Q),
                             torch.full((6,), ep), layer)
        assert got.tolist() == want
