"""A bf16 index through the facade: the port against the reference.

The reference keeps the caller's storage dtype (its facade casts the
vectors to the index's dtype before the bulk build; ``build`` and
``build_batch`` make their index with ``dtype=vectors.dtype``) and
accumulates every distance in f32. The port does the same, so with the
reference's level and cursor draws fed in (``tests/torch_parity.py``) a
bf16 index holds the same bits in both packages, every graph array is
equal, and queries (f32, as both facades keep them) return the same labels
and distances: the bulk build on the sequential route (10 and 300 points)
and the wave route (1,100), the 300 x 16, k = 200 exact query, the tape
(deletes and replaces), and npz files crossing between the packages. The
core builds are in ``test_torch_bf16_builds.py``.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api.facade as jf
from repro import api as japi
from repro.core.index import HNSWIndex as JIndex
from repro.data import clustered_vectors

import repro_torch.api.facade as pf
from repro_torch import api
from repro_torch.core.hnsw import WAVE_BUILD_MIN_N
from torch_parity import (FIELDS, Feed, allocated_levels,
                          assert_same_bf16_index, record_wave_draws)

DIM = 16
K = 10


def _same_answers(ref_vi, port_vi, Q, k, modes=("exact", "graph")):
    for mode in modes:
        rl, rd = ref_vi.knn_query(Q, k=k, mode=mode)
        pl, pd = port_vi.knn_query(Q, k=k, mode=mode)
        np.testing.assert_array_equal(pl, rl, err_msg=mode)
        np.testing.assert_allclose(pd, rd, rtol=1e-5, atol=1e-5,
                                   err_msg=mode)


def _fed_facades(monkeypatch, draws, **kw):
    """A reference and a port facade, both bf16, whose bulk builds share
    the reference's draws: levels on the sequential route, and from
    ``WAVE_BUILD_MIN_N`` points the wave draws that ``record_wave_draws``
    collects into ``draws``."""
    levels, waves = Feed(), Feed(draws)
    j_build, p_build = jf._build, pf.build

    def jb(params, X, *a, **k):
        ix = j_build(params, X, *a, **k)
        if len(X) < WAVE_BUILD_MIN_N:
            levels.append(allocated_levels(ix))
        return ix

    def pb(params, X, *a, **k):
        k.pop("generator")
        if len(X) < WAVE_BUILD_MIN_N:
            return p_build(params, X, *a, levels=next(levels), **k)
        return p_build(params, X, *a, draws=waves, **k)

    monkeypatch.setattr(jf, "_build", jb)
    monkeypatch.setattr(pf, "build", pb)
    ref = japi.create(dtype=jnp.bfloat16, **kw)
    port = api.create(dtype=torch.bfloat16, device="cpu", **kw)
    return ref, port, levels, waves


@pytest.mark.parametrize("n", [10, 300, 1100])
def test_bf16_facade_stores_bf16_and_answers_as_the_reference(monkeypatch,
                                                              n):
    """``create(dtype=bfloat16)`` + ``add_items``: the port stores bf16
    (half the bytes of f32), the same bits and graph as the reference's
    bf16 index, and answers exact and graph queries alike; at 300 points
    also ``k = 200``, the case where an f32 index's labels differ."""
    with record_wave_draws(monkeypatch) as draws:
        ref, vi, levels, waves = _fed_facades(
            monkeypatch, draws, space="l2", dim=DIM,
            capacity=2048 if n > 1024 else 512, M=8, num_layers=3,
            ef_construction=48, ef_search=48)
        X = np.random.default_rng(0).standard_normal((n, DIM))
        labels = ref.add_items(X).tolist()      # the reference draws first
        assert vi.add_items(X).tolist() == labels
    assert levels.spent and waves.spent
    assert (n >= WAVE_BUILD_MIN_N) == (len(draws) > 0)
    assert vi.index.vectors.dtype == torch.bfloat16
    assert vi.index.vectors.element_size() == 2
    assert_same_bf16_index(ref.index, vi.index)
    Q = np.random.default_rng(1).standard_normal((8, DIM))
    _same_answers(ref, vi, Q, min(K, n))
    if n == 300:
        _same_answers(ref, vi, Q, 200, modes=("exact",))


def test_bf16_facade_tape_keeps_bf16(monkeypatch):
    """The tape's vectors arrive in f32 and are cast to the index's dtype in
    the wave, as the reference's are: mark_deleted + replace_items on a bf16
    index keep bf16 and equal arrays."""
    with record_wave_draws(monkeypatch) as draws:
        ref, vi, levels, waves = _fed_facades(
            monkeypatch, draws, space="cosine", dim=DIM, capacity=256, M=8,
            num_layers=3, ef_construction=48, ef_search=48)
        p_apply = pf.apply_update_batch

        def pa(params, index, ops, labels, Xt, variant, execution,
               generator):
            return p_apply(params, index, ops, labels, Xt, variant,
                           execution, draws=waves)
        monkeypatch.setattr(pf, "apply_update_batch", pa)
        for v in (ref, vi):
            v.add_items(clustered_vectors(160, DIM, seed=61))
            v.mark_deleted(np.arange(0, 40, 3))
            v.replace_items(clustered_vectors(12, DIM, seed=62),
                            np.arange(900, 912))
    assert levels.spent and waves.spent and len(draws) > 0
    assert_same_bf16_index(ref.index, vi.index)
    _same_answers(ref, vi, clustered_vectors(8, DIM, seed=63), K)


def test_bf16_npz_files_cross_between_the_packages(tmp_path):
    """The reference saves a bf16 index's vectors as 2-byte void (its own
    ``load`` refuses them, a fault of the reference); the port loads those
    bits as bf16 and saves the same bytes back, which the reference's
    arrays, viewed as bf16, hold equal; both answer alike."""
    X = clustered_vectors(120, DIM, seed=81)
    Q = clustered_vectors(6, DIM, seed=82)
    ji = japi.create(space="l2", dim=DIM, capacity=128, M=8, num_layers=3,
                     ef_construction=48, dtype=jnp.bfloat16)
    ji.add_items(X)
    ref_path, port_path = str(tmp_path / "ref.npz"), str(tmp_path / "p.npz")
    ji.save(ref_path)
    vi = api.VectorIndex.load(ref_path, device="cpu")
    assert_same_bf16_index(ji.index, vi.index)
    _same_answers(ji, vi, Q, K)
    vi.save(port_path)
    with np.load(ref_path) as a, np.load(port_path) as b:
        assert a["vectors"].dtype == b["vectors"].dtype == np.dtype("V2")
        for f in FIELDS:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
        arrays = {f: b[f] for f in FIELDS}
    arrays["vectors"] = arrays["vectors"].view(jnp.bfloat16)
    back = copy.copy(ji)
    back._index = JIndex(**{f: jnp.asarray(arrays[f]) for f in FIELDS})
    assert back.index.vectors.dtype == jnp.bfloat16
    _same_answers(back, vi, Q, K)
