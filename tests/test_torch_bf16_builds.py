"""The core builds over a bf16 index: the port against the reference.

``build_batch`` (the wave route), ``rebuild_index``, ``rebuild_backup`` and
``build_sharded`` keep a bf16 input's dtype, as the reference's do; with
the reference's draws fed in, the stored bits and every graph array are
equal (``tests/torch_parity.py``). The facade's bf16 cases are in
``test_torch_bf16.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.batch_update as jbu
from repro.core import build as j_build
from repro.core import rebuild_backup as j_rebuild_backup
from repro.core.distributed import build_sharded as j_build_sharded
from repro.core.index import HNSWIndex as JIndex
from repro.core.maintenance import rebuild_index as j_rebuild_index
from repro.data import clustered_vectors

import repro_torch.core as T
from repro_torch.core.distributed import build_sharded
from torch_parity import (FIELDS, allocated_levels, assert_same_bf16_index,
                          bf16_bits, port_params, record_wave_draws,
                          ref_arrays, to_port)

DIM = 16


@pytest.fixture(scope="module")
def bf16_data():
    return jnp.asarray(clustered_vectors(300, DIM, n_clusters=8, seed=71),
                       jnp.bfloat16)


def test_bf16_build_batch_wave_route(monkeypatch, small_params, bf16_data):
    """``build_batch`` keeps a bf16 input's dtype; the wave executor casts
    each wave's f32 lanes back to bf16 and widens to f32 where the
    reference's matmul-form distances do: equal arrays."""
    with record_wave_draws(monkeypatch) as draws:
        ref = jbu.build_batch(small_params, bf16_data, min_wave=64)
    assert len(draws) > 2
    bits = torch.from_numpy(bf16_bits(bf16_data).view(np.int16).copy())
    port = T.build_batch(port_params(small_params),
                         bits.view(torch.bfloat16), min_wave=64,
                         draws=draws, device="cpu")
    assert_same_bf16_index(ref, port)


@pytest.fixture(scope="module")
def bf16_index(small_params, bf16_data):
    return j_build(small_params, bf16_data)


def test_bf16_rebuild_index(small_params, bf16_index):
    deleted = np.zeros(bf16_index.capacity, bool)
    deleted[np.random.default_rng(5).choice(300, 90, replace=False)] = True
    ix = dataclasses.replace(bf16_index, deleted=jnp.asarray(deleted))
    ref = j_rebuild_index(small_params, ix, seed=0)
    live = int(ref.count)
    port = T.rebuild_index(port_params(small_params), to_port(ix),
                           levels=ref_arrays(ref)["levels"][:live])
    assert_same_bf16_index(ref, port)


def test_bf16_rebuild_backup(small_params, bf16_index):
    a = ref_arrays(bf16_index)
    cut = np.random.default_rng(6).choice(
        np.setdiff1d(np.arange(300), [a["entry"]]), 20, replace=False)
    nb = a["neighbors"].copy()
    nb[np.isin(nb, cut)] = -1
    main = dataclasses.replace(bf16_index, neighbors=jnp.asarray(nb))
    ref = j_rebuild_backup(small_params, main, 64, jnp.uint32(1))
    n_valid = int(ref.count)
    assert n_valid >= len(cut)
    port = T.rebuild_backup(port_params(small_params), to_port(main), 64,
                            seed=1, execution="sequential",
                            levels=ref_arrays(ref)["levels"][:n_valid])
    assert_same_bf16_index(ref, port)


def test_bf16_build_sharded(small_params, bf16_data):
    ref = j_build_sharded(small_params, bf16_data, nshards=2, capacity=160)
    shards = [JIndex(*[getattr(ref, f)[s] for f in FIELDS])
              for s in range(2)]
    bits = torch.from_numpy(bf16_bits(bf16_data).view(np.int16).copy())
    port = build_sharded(port_params(small_params),
                         bits.view(torch.bfloat16), nshards=2, capacity=160,
                         devices=["cpu"],
                         draws=[allocated_levels(s) for s in shards])
    for r, p in zip(shards, port.shards):
        assert_same_bf16_index(r, p)
