"""Helpers for the parity tests between the JAX reference and the port.

The reference draws levels and slot-reuse cursors from JAX threefry keys,
which torch cannot reproduce, so the helpers record the reference's draws
and the tests feed them to the port's override arguments.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.core.batch_update as jbu
from repro.core import HNSWParams as JParams
from repro.core.index import HNSWIndex as JIndex
from repro.core.index import sample_level as j_sample_level
from repro.core.index import sample_levels as j_sample_levels
from repro.core.hnsw import insert_jit
from repro.core.update import (OP_DELETE, OP_INSERT, OP_REPLACE,
                               _reuse_cursor, first_deleted_slot,
                               first_free_slot, mark_delete_jit,
                               replaced_update_jit)

import repro_torch.core as T

FIELDS = T.index.FIELDS


def port_params(p: JParams) -> T.HNSWParams:
    return T.HNSWParams(**dataclasses.asdict(p))


def ref_arrays(ix) -> dict:
    return {f: np.asarray(getattr(ix, f)) for f in FIELDS}


def to_port(ix) -> T.HNSWIndex:
    return T.from_arrays(ref_arrays(ix), device="cpu")


def assert_same_index(ref_ix, port_ix, skip=("rng",)):
    """Every array equal (``rng`` is opaque state the port never advances)."""
    a, b = ref_arrays(ref_ix), T.to_arrays(port_ix)
    for f in FIELDS:
        if f not in skip:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def bf16_bits(a) -> np.ndarray:
    """bf16 values as their 16 bits, from either package."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == torch.bfloat16 and a.element_size() == 2
        return a.view(torch.int16).numpy().view(np.uint16)
    a = np.asarray(a)
    assert a.dtype.itemsize == 2
    return a.view(np.uint16)


def assert_same_bf16_index(ref_ix, port_ix):
    """Both store bf16, the same bits, and every other array is equal."""
    assert ref_ix.vectors.dtype == jnp.bfloat16
    np.testing.assert_array_equal(bf16_bits(port_ix.vectors),
                                  bf16_bits(ref_ix.vectors))
    assert_same_index(ref_ix, port_ix, skip=("rng", "vectors"))


def _level_after_split(ix, params):
    return int(j_sample_level(jax.random.split(ix.rng)[1], params))


def ref_ops_one_by_one(params, ix, ops, labels, X, variant):
    """Apply a tape with the reference one op at a time (the semantics of
    its sequential executor); returns ``(index, slots, levels)`` — the
    reference's draws for each op, for the port's overrides."""
    slots, levels = [], []
    for op, lbl, x in zip(np.asarray(ops), np.asarray(labels), np.asarray(X)):
        slot = lvl = None
        lbl = jnp.int32(int(lbl))
        if op == OP_DELETE:
            ix = mark_delete_jit(ix, lbl)
        elif op == OP_REPLACE:
            slot = int(first_deleted_slot(ix))
            if slot < 0:
                slot = int(first_free_slot(ix))
                lvl = _level_after_split(ix, params)
            ix = replaced_update_jit(params, ix, jnp.asarray(x), lbl, variant)
        elif op == OP_INSERT:
            slot = int(first_free_slot(ix))
            lvl = _level_after_split(ix, params)
            if slot >= 0:
                ix = insert_jit(params, ix, jnp.asarray(x), jnp.int32(slot),
                                lbl)
        slots.append(slot)
        levels.append(lvl)
    return ix, slots, levels


def ref_shard(arrays: dict, s: int) -> JIndex:
    """Shard ``s`` of a stacked layout (leading shard axis) as a reference
    index."""
    return JIndex(**{f: jnp.asarray(arrays[f][s]) for f in FIELDS})


def ref_route(params, shards, del_label, x, new_label, variant, fresh):
    """What the reference's ``sharded_update`` composes, applied to the
    owner shards' slices (``shards``: a list of reference indexes, updated
    in the list): ``mark_delete`` on the owner of ``del_label``, then
    ``replaced_update`` (or, ``fresh``, ``first_free_slot`` + ``insert``)
    on the owner of ``new_label``; a negative label skips its half.
    Returns the new half's ``(slot, level)`` draws."""
    S = len(shards)
    slot = level = None
    if del_label >= 0:
        o = del_label % S
        shards[o] = mark_delete_jit(shards[o], jnp.int32(del_label))
    if new_label >= 0:
        o = new_label % S
        shards[o], slots, levels = ref_ops_one_by_one(
            params, shards[o], [OP_INSERT if fresh else OP_REPLACE],
            [new_label], np.asarray(x)[None], variant)
        slot, level = slots[0], levels[0]
    return slot, level


@contextlib.contextmanager
def record_wave_draws(monkeypatch):
    """Record the reference wave executor's draws, in the order the port's
    ``apply_plan(draws=...)`` consumes them."""
    draws = []
    orig_wave, orig_insert = jbu._apply_wave_jit, jbu.insert_jit

    def wave(params, index, ops, labels, X, variant, rotate_slots, do_repair,
             tier):
        live_del = index.deleted & (index.levels >= 0)
        free = index.levels < 0
        sd = _reuse_cursor(index, jnp.sum(live_del).astype(jnp.int32))
        sf = _reuse_cursor(index, jnp.sum(free).astype(jnp.int32))
        sub = jax.random.split(index.rng)[1]
        lv = j_sample_levels(sub, params, ops.shape[0])
        draws.append((int(sd), int(sf), np.asarray(lv)))
        return orig_wave(params, index, ops, labels, X, variant, rotate_slots,
                         do_repair, tier)

    def ins(params, index, x, pid, label):
        draws.append((int(pid), _level_after_split(index, params)))
        return orig_insert(params, index, x, pid, label)

    monkeypatch.setattr(jbu, "_apply_wave_jit", wave)
    monkeypatch.setattr(jbu, "insert_jit", ins)
    yield draws


class Feed:
    """Recorded reference draws, handed to the port one at a time in the
    order the reference made them. ``apply_plan(draws=...)`` takes a feed
    as it is (``iter`` of a feed is the feed); the other hooks call
    ``next``. Running dry raises ``IndexError``: the port drew more."""

    def __init__(self, items=None):
        self.items = [] if items is None else items
        self.pos = 0

    def __iter__(self):
        return self

    def __next__(self):
        item = self.items[self.pos]
        self.pos += 1
        return item

    def append(self, item):
        self.items.append(item)

    @property
    def spent(self) -> bool:
        """Whether the port consumed exactly what the reference drew."""
        return self.pos == len(self.items)


def recording_sequential_draws(apply_fn, params, variant, feed: Feed):
    """Wrap a reference tape apply ``fn(index, ops, labels, X)`` of the
    sequential executor so that it first records the tape's draws into
    ``feed`` as ``(slots, levels)``, for the port's overrides."""
    def fn(index, ops, labels, X):
        _, slots, levels = ref_ops_one_by_one(params, index, ops, labels, X,
                                              variant)
        feed.append((slots, levels))
        return apply_fn(index, ops, labels, X)
    return fn


def allocated_levels(ix) -> np.ndarray:
    """Levels of the first ``count`` slots: a sequential build's draws."""
    return np.asarray(ix.levels)[:int(ix.count)]


def recall(found: np.ndarray, truth: np.ndarray) -> float:
    k = truth.shape[1]
    return float(np.mean([len(set(found[i].tolist()) & set(truth[i].tolist()))
                          / k for i in range(truth.shape[0])]))

