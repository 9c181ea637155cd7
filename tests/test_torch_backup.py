"""Port vs reference: backup index over unreachable points + dualSearch."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

import repro.core.batch_update as jbu
from repro.core import batch_dual_search as j_dual
from repro.core import rebuild_backup as j_rebuild
from repro.core.reach import bfs_unreachable as j_bfs_unreachable
from repro.data import clustered_vectors

import repro_torch.core as T
from torch_parity import (assert_same_index, port_params, record_wave_draws,
                          ref_arrays, to_port)


def _with_unreachable(index, n=30, seed=0):
    """``index`` with every in-edge into ``n`` random points removed."""
    a = ref_arrays(index)
    rng = np.random.default_rng(seed)
    cut = rng.choice(np.setdiff1d(np.arange(index.capacity), [a["entry"]]),
                     n, replace=False)
    nb = a["neighbors"].copy()
    nb[np.isin(nb, cut)] = -1
    return dataclasses.replace(index, neighbors=jnp.asarray(nb)), cut


def test_rebuild_backup_and_dual_search_agree(small_params, small_index,
                                              small_data):
    main, cut = _with_unreachable(small_index)
    ref_b = j_rebuild(small_params, main, 64, jnp.uint32(1))
    n_valid = int(ref_b.count)
    assert n_valid >= len(cut)
    port_main = to_port(main)
    p = port_params(small_params)
    port_b = T.rebuild_backup(p, port_main, 64, seed=1,
                              execution="sequential",
                              levels=ref_arrays(ref_b)["levels"][:n_valid])
    assert_same_index(ref_b, port_b)
    assert set(cut.tolist()) <= set(port_b.labels[:n_valid].tolist())

    Q = small_data[cut[:12]] + 0.01
    rl, rd = j_dual(small_params, main, small_params, ref_b, jnp.asarray(Q),
                    5)
    pl, pd = T.batch_dual_search(p, port_main, p, port_b, torch.from_numpy(Q),
                                 5)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(rl))
    np.testing.assert_allclose(pd.numpy(), np.asarray(rd), rtol=1e-5,
                               atol=1e-5)
    one_l, _ = T.dual_search(p, port_main, p, port_b, torch.from_numpy(Q[0]),
                             5)
    assert one_l.tolist() == pl[0].tolist()


def test_wave_backup_serves_every_unreachable_point(small_params,
                                                    small_index, small_data):
    main, _ = _with_unreachable(small_index, n=40, seed=3)
    p = port_params(small_params)
    port_main = to_port(main)
    # cutting a point's in-edges also strands what only it reached
    cut = torch.nonzero(T.bfs_unreachable(port_main)).reshape(-1).numpy()
    assert len(cut) >= 40
    backup = T.rebuild_backup(p, port_main, 64, execution="wave")
    assert int(backup.count) == len(cut)
    assert sorted(backup.labels[:len(cut)].tolist()) == sorted(cut.tolist())
    Q = torch.from_numpy(small_data[cut])
    main_only, _, _ = T.batch_knn(p, port_main, Q, 1)
    dual, _ = T.batch_dual_search(p, port_main, p, backup, Q, 1)
    assert (dual[:, 0].numpy() == cut).mean() >= 0.95
    assert (dual[:, 0].numpy() == cut).mean() > \
        (main_only[:, 0].numpy() == cut).mean()


def test_wave_backup_matches_reference_build_batch(monkeypatch, small_params,
                                                   small_index, small_data):
    """From ``WAVE_BUILD_MIN_N`` unreachable points the port builds its
    backup with the wave executor, where the reference inserts one point at
    a time. Held to the reference's ``build_batch`` over the same points in
    the same slot order, with its draws fed in: every array equal."""
    main, _ = _with_unreachable(small_index, n=40, seed=3)
    slots = np.nonzero(np.asarray(j_bfs_unreachable(main)))[0][:64]
    assert len(slots) >= 40
    with record_wave_draws(monkeypatch) as draws:
        ref_b = jbu.build_batch(small_params, main.vectors[slots],
                                main.labels[slots], capacity=64)
    assert len(draws) > 2                  # the bootstrap and several waves
    p = port_params(small_params)
    port_main = to_port(main)
    port_b = T.rebuild_backup(p, port_main, 64, execution="wave",
                              draws=draws)
    assert_same_index(ref_b, port_b)
    Q = torch.from_numpy(small_data[slots[:12]] + 0.01)
    rl, rd = j_dual(small_params, main, small_params, ref_b,
                    jnp.asarray(Q.numpy()), 5)
    pl, pd = T.batch_dual_search(p, port_main, p, port_b, Q, 5)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(rl))
    np.testing.assert_allclose(pd.numpy(), np.asarray(rd), rtol=1e-5,
                               atol=1e-5)


def test_dual_index_manager_rebuilds_every_tau(small_params):
    p = port_params(small_params)
    X = clustered_vectors(300, 16, n_clusters=8, seed=8)
    index = T.build(p, X, capacity=320, device="cpu",
                    generator=torch.Generator().manual_seed(0))
    mgr = T.DualIndexManager(p, index, tau=4, backup_capacity=32,
                             generator=torch.Generator().manual_seed(1))
    new = clustered_vectors(4, 16, n_clusters=8, seed=9)
    mgr.replaced_update_batch([1, 2, 3, 4], new, [900, 901, 902, 903])
    assert mgr._rebuilds == 1
    labels, dists = mgr.search(torch.from_numpy(new), 1)
    assert labels[:, 0].tolist() == [900, 901, 902, 903]
    assert torch.isfinite(dists).all()
