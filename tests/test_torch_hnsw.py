"""Port vs reference: sequential construction with the reference's levels."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build
from repro.data import clustered_vectors

import repro_torch.core as T
from torch_parity import assert_same_index, port_params, ref_arrays, to_port


def test_sequential_build_same_adjacency(small_params, small_index,
                                         small_data):
    """n = 600: the reference's levels injected, every array identical."""
    levels = ref_arrays(small_index)["levels"]
    port = T.build(port_params(small_params), small_data,
                   execution="sequential", levels=levels, device="cpu")
    assert_same_index(small_index, port)


def test_sequential_build_ip_space_same_adjacency(small_params):
    p = dataclasses.replace(small_params, space="ip", num_layers=2)
    X = clustered_vectors(160, 8, n_clusters=4, seed=6)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    ref = build(p, jnp.asarray(X), capacity=200)
    port = T.build(port_params(p), X, capacity=200, execution="sequential",
                   levels=ref_arrays(ref)["levels"], device="cpu")
    assert_same_index(ref, port)


def test_insert_into_a_reference_graph(small_params, small_index):
    """One more insert with an injected level, into a slot of a resized
    reference graph, matches the reference's insert."""
    from repro.core import insert as j_insert
    from repro.core import resize_index as j_resize
    ref = j_resize(small_index, 640)
    x = clustered_vectors(1, 16, n_clusters=8, seed=99)[0]
    r2 = j_insert(small_params, ref, jnp.asarray(x), 610, 7000,
                  level_override=jnp.int32(1))
    p2 = T.insert(port_params(small_params), to_port(ref), torch.from_numpy(x),
                  610, 7000, level_override=1)
    assert_same_index(r2, p2)


def test_build_routes_and_validates():
    p = T.HNSWParams(M=4, M0=8, num_layers=2, ef_construction=16)
    X = clustered_vectors(40, 4, seed=1)
    ix = T.build(p, X, device="cpu")                      # auto -> sequential
    assert int(ix.count) == 40
    assert sorted(ix.labels.tolist()) == list(range(40))
    with pytest.raises(ValueError, match="unknown build execution"):
        T.build(p, X, execution="parallel", device="cpu")
