"""Port vs reference: the sharded index (``core/distributed.py``).

* ``build_sharded``: the port's stacked arrays equal the reference's
  ``build_sharded`` (which runs host-side, no mesh needed) array for array,
  given each shard's level / wave draws.
* ``sharded_batch_knn``: equal to the reference's own ``sharded_batch_knn``
  under ``shard_map`` over 2 and 4 forced host devices (a subprocess per
  device count, ``XLA_FLAGS`` set before ``import jax``, as
  ``tests/test_distributed.py`` does), and to the reference's per-shard
  ``batch_knn`` + stable merge in process.
* ``sharded_update``: the reference's own ``sharded_update`` is not the
  oracle, because under jax 0.9.0 it fails at its ``lax.cond`` inside
  ``shard_map`` (``distributed.py:133``) with "AssertionError: Unexpected
  XLA sharding override: (XLA) GSPMDSharding({replicated}) !=
  NamedSharding(... PartitionSpec('data', None)) (User sharding)" — which
  is also why the reference's two sharded subprocess tests fail. The port's
  routed update is held to what that function composes, on one shard's
  slice: ``mark_delete`` on the owner of the deleted label, then
  ``replaced_update`` or ``first_free_slot`` + ``insert`` on the owner of
  the new label (the reference's draws fed in), every other shard left
  bit-identical.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.distributed as jd
from repro.core import HNSWParams, batch_knn as j_batch_knn
from repro.data import clustered_vectors

import repro_torch.core as T
from repro_torch.core.distributed import (ShardedIndex, build_sharded,
                                          shard_index, sharded_batch_knn,
                                          sharded_update)
from repro_torch.launch.mesh import make_local_mesh
from torch_parity import (FIELDS, assert_same_index, port_params,
                          record_wave_draws, ref_route, ref_shard)

CPU = [torch.device("cpu")]
DIST_TOL = 1e-5     # f32 distances summed in a different order
PARAMS = HNSWParams(M=8, M0=16, num_layers=3, ef_construction=48,
                    ef_search=48)
SRC = str(Path(__file__).resolve().parents[1] / "src")


def ref_build_sharded(monkeypatch, params, X, S, cap):
    """The reference's ``build_sharded`` and each shard's draws: its
    sequential levels, or its recorded wave draws."""
    bounds = []
    with record_wave_draws(monkeypatch) as draws:
        orig = jd.build

        def build(*a, **kw):
            start = len(draws)
            out = orig(*a, **kw)
            bounds.append((start, len(draws)))
            return out
        monkeypatch.setattr(jd, "build", build)
        ref = jd.build_sharded(params, jnp.asarray(X), nshards=S,
                               capacity=cap)
    arrays = {f: np.asarray(getattr(ref, f)) for f in FIELDS}
    per_shard = []
    for s, (a, b) in enumerate(bounds):
        count = int(arrays["count"][s])
        per_shard.append(draws[a:b] if count >= T.hnsw.WAVE_BUILD_MIN_N
                         else arrays["levels"][s][:count])
    return arrays, per_shard


# ---------------------------------------------------------------------------
# build_sharded
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,S,cap", [
    (400, 4, None),        # divisible, exactly full
    (403, 4, 104),         # not divisible, free slots (per = 101)
    (400, 1, None),        # one shard
    (2200, 2, None),       # 1,100 points a shard: the wave route
], ids=["divisible", "ragged-oversized", "one-shard", "wave"])
def test_build_sharded_same_arrays(monkeypatch, n, S, cap):
    """Array for array, given each shard's draws. On the wave route the
    adjacency is held up to f32 rounding: the wave executor ranks and
    prunes on matmul-form distances (``|a|^2 + |b|^2 - 2 a.b``), which
    XLA's and torch's CPU GEMMs round differently (up to 64 ulps in a
    1,024-lane wave, and XLA's rounding moves with its fusion), so a
    near-tie can flip an edge: 10 of 105,600 entries here."""
    X = clustered_vectors(n, 16, seed=n)
    arrays, draws = ref_build_sharded(monkeypatch, PARAMS, X, S, cap)
    port = build_sharded(port_params(PARAMS), X, nshards=S, capacity=cap,
                         devices=CPU, draws=draws)
    got = port.stacked_arrays()
    assert port.nshards == S and port.dim == 16
    wave = n // S >= T.hnsw.WAVE_BUILD_MIN_N
    for f in FIELDS:
        if f == "rng":      # opaque state the port never advances
            continue
        if f == "neighbors" and wave:
            assert np.mean(got[f] != arrays[f]) < 1e-3
        else:
            np.testing.assert_array_equal(got[f], arrays[f], err_msg=f)
    for s in range(S):       # ownership: label % S == s
        ix = port.shards[s]
        lab = ix.labels[ix.levels >= 0].numpy()
        assert (lab % S == s).all()


def test_build_sharded_capacity_error_and_ownership():
    X = clustered_vectors(400, 16, seed=1)
    msg = "per-shard capacity 99 < 100 needed for 400 vectors on 4 shards"
    with pytest.raises(ValueError, match=msg):
        jd.build_sharded(PARAMS, jnp.asarray(X), nshards=4, capacity=99)
    with pytest.raises(ValueError, match=msg):
        build_sharded(port_params(PARAMS), X, nshards=4, capacity=99,
                      devices=CPU)
    # the reference would silently drop the sixth label of shard 0
    with pytest.raises(ValueError, match="labels must spread evenly"):
        build_sharded(port_params(PARAMS), X[:8], np.arange(0, 16, 2),
                      nshards=2, devices=CPU)


def test_stacked_round_trip_and_placement(monkeypatch):
    X = clustered_vectors(403, 16, seed=3)
    arrays, _ = ref_build_sharded(monkeypatch, PARAMS, X, 4, 104)
    port = ShardedIndex.from_stacked(arrays, CPU)
    back = port.stacked_arrays()
    for f in FIELDS:        # rng too: carried unchanged
        np.testing.assert_array_equal(back[f], arrays[f], err_msg=f)
        assert back[f].dtype == arrays[f].dtype, f
    placed = shard_index(port, CPU + CPU)
    assert placed.devices == CPU * 4
    assert all(a.vectors is b.vectors          # already there: no copy
               for a, b in zip(placed.shards, port.shards))
    twin = port.clone()
    T.mark_delete(twin.shards[1], 1)
    assert not bool(port.shards[1].deleted.any())


def test_make_local_mesh():
    assert make_local_mesh("cpu") == CPU
    if torch.cuda.is_available():
        assert make_local_mesh() == [torch.device("cuda", i) for i in
                                     range(torch.cuda.device_count())]
    else:
        with pytest.raises(RuntimeError, match="no GPU"):
            make_local_mesh()


# ---------------------------------------------------------------------------
# sharded_batch_knn
# ---------------------------------------------------------------------------

KNN_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=" + sys.argv[1]
import json
import numpy as np
import jax
import jax.numpy as jnp
from repro.core import HNSWParams
from repro.core.distributed import shard_index, sharded_batch_knn
from repro.core.index import HNSWIndex

S = int(sys.argv[1])
assert len(jax.devices()) == S
mesh = jax.make_mesh((S,), ("data",))
z = np.load(sys.argv[2])
out = {}
for case in json.loads(str(z["cases"])):
    p = HNSWParams(**json.loads(str(z[case + "/params"])))
    stacked = HNSWIndex(**{f: jnp.asarray(z[case + "/" + f]) for f in
                           ("vectors", "labels", "levels", "neighbors",
                            "deleted", "entry", "max_layer", "count", "rng")})
    stacked = shard_index(stacked, mesh, "data")
    lbl, dist = sharded_batch_knn(p, stacked, jnp.asarray(z[case + "/Q"]),
                                  int(z[case + "/k"]), mesh)
    out[case + "/labels"] = np.asarray(lbl)
    out[case + "/dists"] = np.asarray(dist)
np.savez(sys.argv[3], **out)
print("reference sharded_batch_knn OK", S)
"""

KNN_CASES = ["l2", "ip", "cosine", "duplicates"]


def _knn_case(case: str, S: int):
    """(params, vectors, queries): duplicates puts each vector on every
    shard, so every distance ties S ways across shards."""
    space = case if case in ("ip", "cosine") else "l2"
    p = dataclasses.replace(PARAMS, space=space)
    if case == "duplicates":
        X = np.repeat(clustered_vectors(96, 16, seed=7), S, axis=0)
    else:
        X = clustered_vectors(320, 16, seed=11)
    if space != "l2":
        X = X / np.linalg.norm(X, axis=1, keepdims=True)
    rng = np.random.default_rng(S)
    Q = X[rng.choice(len(X), 12, replace=False)]
    Q = (Q + 0.05 * rng.normal(size=Q.shape)).astype(np.float32)
    Q[0] = X[5]                                   # an exact hit
    return p, X.astype(np.float32), Q


@pytest.fixture(scope="module")
def knn_runs(tmp_path_factory):
    """Every case on the port, and the reference's ``sharded_batch_knn`` on
    the same stacked arrays: one subprocess per device count, run at once."""
    tmp = tmp_path_factory.mktemp("sharded_knn")
    states, procs = {}, {}
    for S in (2, 4):
        blob = {"cases": np.array(json.dumps(KNN_CASES))}
        for case in KNN_CASES:
            p, X, Q = _knn_case(case, S)
            port = build_sharded(port_params(p), X, nshards=S, devices=CPU,
                                 seed=S)
            states[S, case] = (p, port, Q)
            blob[case + "/params"] = np.array(json.dumps(
                dataclasses.asdict(p)))
            blob[case + "/Q"], blob[case + "/k"] = Q, np.array(10)
            for f, a in port.stacked_arrays().items():
                blob[f"{case}/{f}"] = a
        np.savez(tmp / f"in{S}.npz", **blob)
        env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
        procs[S] = subprocess.Popen(
            [sys.executable, "-c", KNN_SCRIPT, str(S), str(tmp / f"in{S}.npz"),
             str(tmp / f"out{S}.npz")], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    ref = {}
    for S, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, out + "\n" + err
        with np.load(tmp / f"out{S}.npz") as z:
            ref[S] = {k: z[k] for k in z.files}
    return states, ref


def assert_same_up_to_ties(lbl, dist, ref_lbl, ref_dist):
    """Distances within ``DIST_TOL``; in each row, the labels of every group
    of distances equal within ``DIST_TOL`` agree as sets, and at the k-th
    distance the two sides may keep different members of its group."""
    np.testing.assert_allclose(dist, ref_dist, rtol=DIST_TOL, atol=DIST_TOL)
    for l, d, rl, rd in zip(lbl, dist, ref_lbl, ref_dist):
        near_kth = np.isclose(rd, rd[-1], rtol=DIST_TOL, atol=DIST_TOL)
        assert set(l[~near_kth]) == set(rl[~near_kth])
        groups = np.cumsum(np.r_[True, ~np.isclose(
            rd[1:], rd[:-1], rtol=DIST_TOL, atol=DIST_TOL)])
        for g in np.unique(groups[~near_kth]):
            assert set(l[groups == g]) == set(rl[groups == g])


@pytest.mark.parametrize("case", KNN_CASES)
@pytest.mark.parametrize("S", [2, 4])
def test_sharded_batch_knn_matches_the_reference(knn_runs, S, case):
    """Labels equal, distances to f32 tolerance. Duplicates: every vector
    sits once on each shard, so the port's distances tie exactly and the
    shard-major merge puts the lower shard first; the reference's own
    distances for one vector differ by up to 3 ulps from shard to shard
    (XLA's CPU reduction rounds by position), so against it the order
    inside a tie group is rounding, and the comparison is up to ties."""
    states, ref = knn_runs
    p, port, Q = states[S, case]
    lbl, dist = sharded_batch_knn(port_params(p), port, torch.from_numpy(Q),
                                  10)
    assert lbl.dtype == torch.int32 and lbl.shape == (12, 10)
    ref_lbl, ref_dist = ref[S][case + "/labels"], ref[S][case + "/dists"]
    if case != "duplicates":
        np.testing.assert_array_equal(lbl.numpy(), ref_lbl)
        np.testing.assert_allclose(dist.numpy(), ref_dist, rtol=DIST_TOL,
                                   atol=DIST_TOL)
        assert int(lbl[0, 0]) == 5                       # the exact hit
        return
    assert_same_up_to_ties(lbl.numpy(), dist.numpy(), ref_lbl, ref_dist)
    d, owner = dist.numpy(), lbl.numpy() % S
    tie = d[:, 1:] == d[:, :-1]
    assert tie.sum() >= 12 * (10 // S)
    assert (owner[:, 1:][tie] > owner[:, :-1][tie]).all()


def test_sharded_batch_knn_is_the_stable_merge_of_per_shard_answers(
        knn_runs):
    """In process: the reference's ``batch_knn`` on each shard's slice,
    laid out shard-major and merged with a stable sort."""
    states, _ = knn_runs
    p, port, Q = states[4, "l2"]
    arrays = port.stacked_arrays()
    k = 10
    per = [j_batch_knn(p, ref_shard(arrays, s), jnp.asarray(Q), k)
           for s in range(4)]
    lbl_g = np.concatenate([np.asarray(r[0]) for r in per], axis=1)
    dist_g = np.concatenate([np.asarray(r[2]) for r in per], axis=1)
    dist_g = np.where(lbl_g < 0, np.inf, dist_g)
    order = np.argsort(dist_g, axis=1, kind="stable")[:, :k]
    lbl, dist = sharded_batch_knn(port_params(p), port, torch.from_numpy(Q),
                                  k, ef=32)
    lbl48, dist48 = sharded_batch_knn(port_params(p), port,
                                      torch.from_numpy(Q), k)
    np.testing.assert_array_equal(lbl48.numpy(),
                                  np.take_along_axis(lbl_g, order, 1))
    np.testing.assert_allclose(dist48.numpy(),
                               np.take_along_axis(dist_g, order, 1),
                               rtol=DIST_TOL, atol=DIST_TOL)
    assert lbl.shape == (12, k) and bool(torch.isfinite(dist).all())


# ---------------------------------------------------------------------------
# sharded_update
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def update_base():
    """4 shards of 60 points with 4 free slots each, as stacked arrays."""
    X = clustered_vectors(240, 16, seed=5)
    return build_sharded(port_params(PARAMS), X, nshards=4, capacity=64,
                         devices=CPU).stacked_arrays()


def _check_routed(params, arrays, ops, variant):
    """Apply ``ops`` (del, new, fresh) through both and compare per op."""
    S = arrays["vectors"].shape[0]
    ref = [ref_shard(arrays, s) for s in range(S)]
    port = ShardedIndex.from_stacked(arrays, CPU)
    xs = clustered_vectors(len(ops), 16, seed=99)
    for (dl, nl, fresh), x in zip(ops, xs):
        before = [T.to_arrays(ix) for ix in port.shards]
        objs = list(port.shards)
        slot, level = ref_route(params, ref, dl, x, nl, variant, fresh)
        out = sharded_update(port_params(params), port, dl,
                             torch.from_numpy(x), nl, variant,
                             fresh_insert=fresh, slot=slot, level=level)
        assert out is port and all(a is b for a, b in zip(port.shards, objs))
        owners = {lbl % S for lbl in (dl, nl) if lbl >= 0}
        for s in range(S):
            assert_same_index(ref[s], port.shards[s])
            if s not in owners:                          # untouched
                after = T.to_arrays(port.shards[s])
                for f in FIELDS:
                    np.testing.assert_array_equal(after[f], before[s][f])
    return ref, port


MIXED = [                   # (del_label, new_label, fresh_insert)
    (5, -1, False),         # pure delete, shard 1
    (-1, 241, False),       # replace on shard 1: reuses 5's tombstone
    (9, 245, False),        # delete + replace on one shard
    (10, 247, False),       # delete on shard 2, replace on shard 3 (no
                            # tombstone there: a fresh insert)
    (-1, 250, True),        # fresh insert on shard 2: a free slot, 10's
                            # tombstone stays
    (-1, -1, False),        # both halves disabled
    (12, -1, True),         # delete only
    (14, 252, False),       # delete on shard 2; the replace on shard 0
                            # reuses 12's tombstone
]


@pytest.mark.parametrize("variant", T.BUILTIN_STRATEGIES)
def test_sharded_update_is_the_owner_shards_composition(update_base,
                                                        variant):
    ref, port = _check_routed(PARAMS, update_base, MIXED, variant)
    s2 = port.shards[2]
    slot10 = T.slot_of_label(s2, 10)
    assert slot10 >= 0 and bool(s2.deleted[slot10])     # tombstone kept
    assert int(s2.count) == 61 and T.slot_of_label(s2, 250) >= 60
    assert int(port.shards[3].count) == 61               # fresh fallback


def test_sharded_update_on_full_shards_is_a_no_op():
    """Every shard full (capacity = per): a fresh insert, and a replace
    with no tombstone to reuse, leave every array as it was."""
    X = clustered_vectors(240, 16, seed=6)
    arrays = build_sharded(port_params(PARAMS), X, nshards=4,
                           devices=CPU).stacked_arrays()
    _, port = _check_routed(PARAMS, arrays, [(-1, 301, True),
                                             (-1, 302, False)],
                            "mn_ru_gamma")
    got = port.stacked_arrays()
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], arrays[f], err_msg=f)


def test_sharded_update_rejects_an_unknown_strategy(update_base):
    port = ShardedIndex.from_stacked(update_base, CPU)
    with pytest.raises(ValueError, match="unknown update strategy"):
        sharded_update(port_params(PARAMS), port, -1, np.zeros(16), 7,
                       "nope")
