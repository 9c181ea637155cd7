"""Port vs reference: index state, npz layout, resizing, distances, devices."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import empty_index as j_empty_index
from repro.core import resize_index as j_resize_index
from repro.core.metrics import dist_pairwise as j_pairwise
from repro.core.metrics import dist_point as j_point
import repro.data as ref_data

import repro_torch.core as T
import repro_torch.data as port_data
from torch_parity import FIELDS, assert_same_index, port_params, ref_arrays


def test_arrays_round_trip_exactly(small_index):
    arrays = ref_arrays(small_index)
    port = T.from_arrays(arrays, device="cpu")
    assert port.vectors.dtype == torch.float32
    assert port.neighbors.dtype == torch.int32
    assert port.deleted.dtype == torch.bool
    assert port.rng.dtype == torch.uint32
    back = T.to_arrays(port)
    for f in FIELDS:
        assert back[f].dtype == arrays[f].dtype, f
        assert back[f].shape == arrays[f].shape, f
        np.testing.assert_array_equal(back[f], arrays[f], err_msg=f)


def test_resize_matches_reference(small_index):
    ref = j_resize_index(small_index, 1024)
    port = T.resize_index(T.from_arrays(ref_arrays(small_index), "cpu"), 1024)
    assert_same_index(ref, port, skip=())
    same = T.resize_index(port, 512)            # not larger: a no-op
    assert same is port


def test_empty_index_matches_reference(small_params):
    ref = j_empty_index(small_params, 64, 8, seed=7)
    port = T.empty_index(port_params(small_params), 64, 8, seed=7,
                         device="cpu")
    assert_same_index(ref, port, skip=())


@pytest.mark.parametrize("space", ["l2", "ip", "cosine"])
def test_distances_match_reference(space):
    """f32 distances, rtol 1e-5 (summation order differs by library)."""
    rng = np.random.default_rng(3)
    A = rng.normal(size=(5, 24)).astype(np.float32)
    B = rng.normal(size=(7, 24)).astype(np.float32)
    if space == "cosine":
        A, B = T.metrics.normalize_rows(A), T.metrics.normalize_rows(B)
        A, B = A.astype(np.float32), B.astype(np.float32)
    jp = np.asarray(j_pairwise(space, jnp.asarray(A), jnp.asarray(B)))
    tp = T.dist_pairwise(space, torch.from_numpy(A), torch.from_numpy(B))
    np.testing.assert_allclose(tp.numpy(), jp, rtol=1e-5, atol=1e-5)
    jq = np.stack([np.asarray(j_point(space, jnp.asarray(a), jnp.asarray(B)))
                   for a in A])
    tq = T.dist_point(space, torch.from_numpy(A),
                      torch.from_numpy(B)[None].expand(5, 7, 24))
    np.testing.assert_allclose(tq.numpy(), jq, rtol=1e-5, atol=1e-5)


def test_metric_registry_mirrors_reference():
    assert T.list_metrics() == ("cosine", "ip", "l2")
    assert [T.get_metric(s).kernel_form for s in ("l2", "ip", "cosine")] \
        == ["l2", "ip", "ip"]
    with pytest.raises(ValueError, match="unknown metric space"):
        T.get_metric("hamming")


def test_params_step_cap():
    p = T.HNSWParams(ef_search=64)
    assert p.steps_for(64) == 4 * 64 + 32
    assert T.HNSWParams(max_search_steps=7).steps_for(64) == 7
    assert p.m_for_layer(0) == p.M0 and p.m_for_layer(2) == p.M


def test_seed_key_matches_reference_key():
    for seed in (0, 7, 2 ** 33 + 5):
        np.testing.assert_array_equal(
            T.index.seed_key(seed).numpy(), np.asarray(jax.random.PRNGKey(seed)))


def test_levels_from_generator_follow_the_hnsw_rule():
    p = T.HNSWParams(M=8, num_layers=4)
    g = torch.Generator().manual_seed(0)
    lv = T.sample_levels(g, p, 20000).numpy()
    assert lv.min() == 0 and lv.max() <= 3
    # P(level >= 1) = 1/M for the floor(-ln U / ln M) rule
    assert abs((lv >= 1).mean() - 1 / 8) < 0.01
    again = T.sample_levels(torch.Generator().manual_seed(0), p, 20000)
    np.testing.assert_array_equal(lv, again.numpy())


def test_synthetic_data_matches_reference():
    """The port's numpy copies give the reference's arrays exactly;
    ``noise_seed`` keeps ``seed``'s cluster centres and draws new rows."""
    X = port_data.clustered_vectors(300, 16, n_clusters=8, seed=4)
    np.testing.assert_array_equal(
        X, ref_data.clustered_vectors(300, 16, n_clusters=8, seed=4))
    Q = X[:20] + 0.01
    for space in ("l2", "ip", "cosine"):
        np.testing.assert_array_equal(port_data.exact_knn(X, Q, 5, space),
                                      ref_data.exact_knn(X, Q, 5, space))
    centres = port_data.clustered_vectors(300, 16, n_clusters=8, seed=4,
                                          scale=0.0)
    fresh = port_data.clustered_vectors(50, 16, n_clusters=8, seed=4,
                                        scale=0.0, noise_seed=9)
    assert {r.tobytes() for r in fresh} <= {r.tobytes() for r in centres}
    assert not np.array_equal(
        fresh, port_data.clustered_vectors(50, 16, n_clusters=8, seed=4,
                                           scale=0.0))


def test_entry_points_default_to_cuda_and_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = T.HNSWParams()
    X = np.zeros((4, 8), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.empty_index(p, 8, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.build(p, X)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.build_batch(p, X)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.from_arrays(T.to_arrays(T.empty_index(p, 8, 8, device="cpu")))
    assert T.empty_index(p, 8, 8, device="cpu").device.type == "cpu"
