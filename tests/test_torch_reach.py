"""Port vs reference: in-degree and BFS unreachable-point detection."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import (bfs_reachable, bfs_unreachable, count_unreachable,
                        indegree, indegree_unreachable)
from repro.core.batch_update import apply_update_batch_wave
from repro.data import clustered_vectors

import repro_torch.core as T
from torch_parity import OP_DELETE, OP_REPLACE, ref_arrays, to_port


def _cut(index, targets, deleted_every=0):
    """A copy of ``index`` whose in-edges into ``targets`` are removed (and
    optionally every n-th slot mark-deleted)."""
    a = ref_arrays(index)
    nb = a["neighbors"].copy()
    nb[np.isin(nb, targets)] = -1
    deleted = a["deleted"].copy()
    if deleted_every:
        deleted[::deleted_every] = True
    return dataclasses.replace(index, neighbors=jnp.asarray(nb),
                               deleted=jnp.asarray(deleted))


def _graphs(index):
    rng = np.random.default_rng(0)
    entry = int(index.entry)
    hubs = rng.choice(index.capacity, 25, replace=False)
    hubs = hubs[hubs != entry]
    return {"intact": index, "cut": _cut(index, hubs),
            "cut_deleted": _cut(index, hubs[:10], deleted_every=9)}


@pytest.mark.parametrize("which", ["intact", "cut", "cut_deleted"])
def test_unreachable_masks_agree(small_index, which):
    ref = _graphs(small_index)[which]
    port = to_port(ref)
    np.testing.assert_array_equal(T.indegree(port).numpy(),
                                  np.asarray(indegree(ref)))
    np.testing.assert_array_equal(T.indegree_unreachable(port).numpy(),
                                  np.asarray(indegree_unreachable(ref)))
    np.testing.assert_array_equal(T.bfs_reachable(port).numpy(),
                                  np.asarray(bfs_reachable(ref)))
    np.testing.assert_array_equal(T.bfs_unreachable(port).numpy(),
                                  np.asarray(bfs_unreachable(ref)))
    counts = T.count_unreachable(port)
    assert counts == tuple(int(c) for c in count_unreachable(ref))
    if which != "intact":
        assert counts[0] > 0


def test_counts_agree_on_a_churned_graph(small_params, small_index):
    """Churned by the reference's wave executor (30 deletes + replaces)."""
    rng = np.random.default_rng(5)
    dels = rng.choice(600, 30, replace=False)
    ops = np.array([OP_DELETE] * 30 + [OP_REPLACE] * 30, np.int32)
    labels = np.concatenate([dels, 800 + np.arange(30)]).astype(np.int32)
    X = np.concatenate([np.zeros((30, 16), np.float32),
                        clustered_vectors(30, 16, n_clusters=8, seed=6)])
    ref = apply_update_batch_wave(small_params, small_index, ops, labels, X,
                                  "hnsw_ru")
    ref = _cut(ref, rng.choice(600, 10, replace=False))
    assert T.count_unreachable(to_port(ref)) == tuple(
        int(c) for c in count_unreachable(ref))


def test_empty_index_has_nothing_unreachable():
    ix = T.empty_index(T.HNSWParams(), 16, 4, device="cpu")
    assert T.count_unreachable(ix) == (0, 0)
    assert not T.bfs_reachable(ix).any()
