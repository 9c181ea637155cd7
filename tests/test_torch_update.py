"""Port vs reference: markDelete, replaced_update under the five strategies
and the sequential tape executor, with the reference's slot and level draws
fed in."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import count_unreachable as j_count_unreachable
from repro.core import resize_index as j_resize
from repro.core.update import _apply_update_batch_sequential_jit
from repro.core.update import mark_delete_jit, slot_of_label as j_slot
from repro.data import clustered_vectors

import repro_torch.core as T
from torch_parity import (OP_DELETE, OP_INSERT, OP_REPLACE, assert_same_index,
                          port_params, ref_ops_one_by_one, to_port)


def test_mark_delete_same_flags(small_index):
    port = to_port(small_index)
    ref = small_index
    for lbl in (5, 77, 123, 5, 9999):
        ref = mark_delete_jit(ref, jnp.int32(lbl))
        T.mark_delete(port, lbl)
        assert T.slot_of_label(port, lbl) == int(j_slot(ref, jnp.int32(lbl)))
    assert_same_index(ref, port)
    assert T.num_deleted(port) == 3


def _tape(n_del, n_rep, seed, n_total=600, d=16):
    rng = np.random.default_rng(seed)
    dels = rng.choice(n_total, n_del, replace=False)
    ops = np.array([OP_DELETE] * n_del + [OP_REPLACE] * n_rep, np.int32)
    labels = np.concatenate([dels, 1000 + np.arange(n_rep)]).astype(np.int32)
    X = np.concatenate([np.zeros((n_del, d), np.float32),
                        clustered_vectors(n_rep, d, n_clusters=8,
                                          seed=seed + 1)])
    return ops, labels, X


@pytest.mark.parametrize("variant", T.BUILTIN_STRATEGIES)
def test_replaced_update_same_adjacency(small_params, small_index, variant):
    """6 deletes, then 7 replaces (the last one falls back to a fresh
    insert into a free slot): same arrays and unreachable counts."""
    ref0 = j_resize(small_index, 640)
    ops, labels, X = _tape(6, 7, seed=len(variant))
    ref, slots, levels = ref_ops_one_by_one(small_params, ref0, ops, labels,
                                            X, variant)
    port = to_port(ref0)
    p = port_params(small_params)
    for i, op in enumerate(ops):
        if op == OP_DELETE:
            T.mark_delete(port, int(labels[i]))
        else:
            T.replaced_update(p, port, torch.from_numpy(X[i]), int(labels[i]),
                              variant, slot=slots[i], level=levels[i])
    assert_same_index(ref, port)
    assert T.count_unreachable(port) == tuple(
        int(c) for c in j_count_unreachable(ref))


def test_sequential_tape_executor_same_adjacency(small_params, small_index):
    """A mixed tape (delete, replace, insert, nop, unknown label) through
    the reference's scan executor and the port's sequential executor."""
    ref0 = j_resize(small_index, 640)
    d_ops, d_labels, d_X = _tape(5, 4, seed=21)
    ops = np.concatenate([d_ops, [OP_INSERT, 0, OP_DELETE, OP_REPLACE,
                                  OP_REPLACE, OP_INSERT]]).astype(np.int32)
    labels = np.concatenate([d_labels, [2000, 0, 424242, 2001, 2002,
                                        2003]]).astype(np.int32)
    X = np.concatenate([d_X, clustered_vectors(6, 16, n_clusters=8, seed=22)])
    variant = "mn_ru_gamma"
    ref = _apply_update_batch_sequential_jit(
        small_params, ref0, jnp.asarray(ops), jnp.asarray(labels),
        jnp.asarray(X), variant)
    one, slots, levels = ref_ops_one_by_one(small_params, ref0, ops, labels,
                                            X, variant)
    assert_same_index(ref, to_port(one), skip=())   # same semantics
    port = T.apply_update_batch_sequential(
        port_params(small_params), to_port(ref0), ops, labels, X, variant,
        slots=slots, levels=levels)
    assert_same_index(ref, port)
    port2 = T.apply_update_batch(port_params(small_params), to_port(ref0),
                                 ops, labels, X, variant,
                                 execution="sequential", slots=slots,
                                 levels=levels)
    assert_same_index(ref, port2)


def test_delete_and_update_batch_matches_one_by_one(small_params,
                                                    small_index):
    ref0 = j_resize(small_index, 640)     # the shapes compiled above
    ops, labels, X = _tape(4, 4, seed=31)
    ref, slots, levels = ref_ops_one_by_one(small_params, ref0, ops,
                                            labels, X, "mn_ru_beta")
    port = T.delete_and_update_batch(
        port_params(small_params), to_port(ref0), labels[:4],
        X[4:], labels[4:], "mn_ru_beta", slots=slots[4:], levels=levels[4:])
    assert_same_index(ref, port)


def test_own_generator_and_registries(small_params, small_index):
    """Without overrides the port draws from its generator: deterministic
    per seed, and every replaced label is findable."""
    p = port_params(small_params)
    ops, labels, X = _tape(8, 8, seed=41)
    outs = []
    for _ in range(2):
        port = to_port(small_index)
        T.apply_update_batch(p, port, ops, labels, X, "mn_thn_ru",
                             execution="sequential",
                             generator=torch.Generator().manual_seed(3))
        outs.append(T.to_arrays(port)["neighbors"])
        assert T.num_deleted(port) == 0
        found, _, _ = T.batch_knn(p, port, torch.from_numpy(X[8:]), 3)
        assert np.mean([labels[8 + i] in found[i].tolist()
                        for i in range(8)]) >= 0.9
    np.testing.assert_array_equal(outs[0], outs[1])
    assert T.list_executors() == ("sequential", "wave")
    with pytest.raises(ValueError, match="unknown update strategy"):
        T.replaced_update(p, port, torch.from_numpy(X[8]), 1, "nope")
    with pytest.raises(ValueError, match="unknown tape execution"):
        T.apply_update_batch(p, port, ops, labels, X, execution="nope")


def test_custom_repair_fn_routes_to_sequential(small_params, small_index,
                                               monkeypatch):
    calls = []

    def repair(params, nbrs, vectors, deleted, pid, layer, strategy):
        calls.append((pid, layer))
        return nbrs

    monkeypatch.setitem(T.strategies._STRATEGIES, "test_noop_repair",
                        T.UpdateStrategy("test_noop_repair",
                                         repair_fn=repair))
    ops, labels, X = _tape(2, 2, seed=51)
    port = to_port(small_index)
    T.apply_update_batch(port_params(small_params), port, ops, labels, X,
                         "test_noop_repair", execution="wave",
                         generator=torch.Generator().manual_seed(0))
    assert calls and T.num_deleted(port) == 0
