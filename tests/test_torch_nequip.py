"""The port's NequIP (``models/{e3,nequip,gnn_common}.py``,
``data/synthetic.py::gnn_batch``) against the JAX reference's, on the
CPU.

* ``e3``: the harmonics to 1e-7; the 15 CG tensors of ``l_max = 2`` to
  1e-6 (four of them up to a sign the reference's call order picks; see
  ``test_cg_tensors_match_the_reference``); Wigner D orthogonal.
* ``nequip``: ``bessel_basis``, energies (1e-5 relative), forces (1e-4),
  ``loss_fn``'s gradients against ``jax.value_and_grad`` (1e-5), the node
  feature projection, and one AdamW step, from the reference's parameters
  (``models.convert``) with its CG tensors handed over (``cg=``).
* The reference's own invariance tests (``tests/test_nequip.py``) on the
  port, at their tolerances.
* ``gnn_common``: ``to_csr`` equal, the samplers equal given the
  reference's draws; ``batch_molecules`` and ``gnn_batch`` bit for bit.
* The ``gnn`` family through ``get_api`` and ``launch/train.py``.
"""
import os
import subprocess
import sys
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import gnn_batch as ref_gnn_batch
from repro.models import e3 as ref_e3
from repro.models import gnn_common as ref_gc
from repro.models import nequip as ref_nq

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import gnn_batch
from repro_torch.models import (e3, gnn_common, gnn_params_from_reference,
                                nequip, value_and_grad)
from repro_torch.train import CheckpointManager
from torch_train_parity import close, step_case

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
F32_REL = 1e-5
#: paths whose largest CG entries tie, so the reference's sign follows the
#: rotations its shared generator happened to draw first
SIGN_TIED = {(1, 1, 1), (1, 2, 2), (2, 1, 2), (2, 2, 1)}


def _ref_cg(l_max=2):
    """The reference's CG tensors as this process computed them."""
    return {p: ref_e3.real_cg(*p) for p in ref_e3.paths(l_max)}


@lru_cache(maxsize=None)
def _pair(d_feat=0):
    """``(ref cfg, ref params, port cfg, port params)``: the reference's
    seed-0 draw of the smoke config carried to the port."""
    import dataclasses
    cfg = dataclasses.replace(ref_smoke_config("nequip"), d_feat=d_feat)
    pcfg = dataclasses.replace(get_smoke_config("nequip"), d_feat=d_feat)
    rp = ref_nq.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, rp, pcfg, gnn_params_from_reference(
        pcfg, jax.tree.map(np.asarray, rp), "cpu")


def _batches(b):
    """A numpy batch as the reference's and the port's."""
    rb = {k: (jnp.asarray(v) if k != "n_graphs" else v) for k, v in b.items()}
    tb = {k: (torch.from_numpy(v) if k != "n_graphs" else v)
          for k, v in b.items()}
    return rb, tb


def _molecules(G=6, A=10, E=24, seed=0, n_species=64):
    """``batch_molecules`` of ``G`` molecules of ``A`` atoms and ``E``
    intra-molecule edges (no self-loops), with energy targets."""
    from repro.data.synthetic import _pair_potential
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(G, A, 3)) * 1.5).astype(np.float32)
    spec = rng.integers(0, n_species, size=(G, A)).astype(np.int32)
    a = rng.integers(0, A, size=(G, E))
    b = (a + rng.integers(1, A, size=(G, E))) % A
    edges = np.stack([a, b], -1).astype(np.int32)
    p, s, src, dst, gid = ref_gc.batch_molecules(pos, spec, edges, G)
    return {"positions": p, "species": s, "src": src.astype(np.int32),
            "dst": dst.astype(np.int32),
            "edge_mask": np.ones(len(src), np.float32),
            "node_mask": np.ones(len(p), np.float32),
            "graph_id": gid.astype(np.int32), "n_graphs": G,
            "energy_target": _pair_potential(p, src, dst, gid, G)}


# ---------------------------------------------------------------------------
# e3
# ---------------------------------------------------------------------------

def test_spherical_harmonics_match():
    u = np.random.default_rng(0).normal(size=(200, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    uf = u.astype(np.float32)
    for l in range(3):
        np.testing.assert_allclose(e3.sh(l, u), ref_e3.sh(l, u), atol=1e-7)
        np.testing.assert_allclose(
            e3.sh_torch(l, torch.from_numpy(uf)).numpy(),
            np.asarray(ref_e3.sh_jnp(l, jnp.asarray(uf))), atol=1e-7)
    with pytest.raises(NotImplementedError):
        e3.sh_torch(3, torch.from_numpy(uf))


def test_cg_tensors_match_the_reference():
    """The 15 paths of l_max = 2 to 1e-6. On the four paths whose largest
    entries tie the reference's sign depends on what its shared generator
    drew first (its call order in the process); there the port's is fixed
    (the first tied entry positive) and the two agree up to that sign."""
    assert e3.paths(2) == ref_e3.paths(2) and len(e3.paths(2)) == 15
    ref = _ref_cg()
    for p, r in ref.items():
        ours = e3.real_cg(*p)
        assert ours.dtype == np.float32 and ours.shape == r.shape
        if p in SIGN_TIED:
            err = min(np.abs(ours - r).max(), np.abs(ours + r).max())
        else:
            err = np.abs(ours - r).max()
        assert err <= 1e-6, (p, err)
    # the port's tensors do not depend on what was drawn or asked first
    e3.random_rotation()                     # moves the module generator
    for p in sorted(SIGN_TIED, reverse=True):
        np.testing.assert_array_equal(e3.real_cg.__wrapped__(*p),
                                      e3.real_cg(*p))
    with pytest.raises(ValueError):
        e3.real_cg(0, 1, 2)


def test_cg_orthogonality():
    """CG tensors for distinct output l are orthogonal subspaces (the
    reference's test on the port)."""
    for (l1, l2) in [(1, 1), (2, 1), (2, 2)]:
        ls = [l for l in range(3) if abs(l1 - l2) <= l <= l1 + l2]
        Cs = [e3.real_cg(l1, l2, l).reshape(-1, 2 * l + 1) for l in ls]
        for i in range(len(ls)):
            for j in range(i + 1, len(ls)):
                G = Cs[i].T @ Cs[j]
                assert np.abs(G).max() < 1e-6, (l1, l2, ls[i], ls[j])


def test_wigner_d_is_orthogonal_and_a_representation():
    R = e3.random_rotation(np.random.default_rng(9))
    np.testing.assert_allclose(R, ref_e3.random_rotation(
        np.random.default_rng(9)))
    for l in range(3):
        D = e3.wigner_d(l, R)
        np.testing.assert_allclose(D @ D.T, np.eye(2 * l + 1), atol=1e-8)
        np.testing.assert_allclose(D, ref_e3.wigner_d(l, R), atol=1e-8)
        u = np.random.default_rng(l).normal(size=(5, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        np.testing.assert_allclose(e3.sh(l, u @ R.T), e3.sh(l, u) @ D.T,
                                   atol=1e-8)


# ---------------------------------------------------------------------------
# nequip against the reference
# ---------------------------------------------------------------------------

def test_bessel_basis_matches():
    r = np.concatenate([[0.0, 1e-12, 1e-6], np.linspace(0.01, 6.0, 200)])
    r = r.astype(np.float32)
    for n, c in ((8, 5.0), (4, 3.0)):
        np.testing.assert_allclose(
            nequip.bessel_basis(torch.from_numpy(r), n, c).numpy(),
            np.asarray(ref_nq.bessel_basis(jnp.asarray(r), n, c)),
            rtol=1e-5, atol=1e-6)


def _batch_cases():
    cfg = ref_smoke_config("nequip")
    return {"one-graph": ref_gnn_batch(cfg, 40, 160, 0, n_graphs=1),
            "molecules": _molecules()}


def _ref_fns(cfg, n_graphs):
    """The reference's forward, energy and forces, and loss value and
    gradients, each jitted with ``n_graphs`` fixed."""
    def with_n(b):
        return {**b, "n_graphs": n_graphs}
    fwd = jax.jit(lambda p, b: ref_nq.forward(cfg, p, with_n(b)))
    ef = jax.jit(lambda p, b: ref_nq.energy_and_forces(cfg, p, with_n(b)))
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: ref_nq.loss_fn(cfg, p, with_n(b)), has_aux=True))
    return fwd, ef, vg


def _strip(rb):
    return {k: v for k, v in rb.items() if k != "n_graphs"}


@pytest.mark.parametrize("case", ["one-graph", "molecules"])
def test_energies_forces_and_gradients_match(case):
    cfg, rp, pcfg, params = _pair()
    b = _batch_cases()[case]
    rb, tb = _batches(b)
    cg = _ref_cg()
    fwd, ef, vg = _ref_fns(cfg, b["n_graphs"])
    re_ = fwd(rp, _strip(rb))
    e = nequip.forward(pcfg, params, tb, cg=cg)
    assert e.dtype == torch.float32 and e.shape == (b["n_graphs"],)
    np.testing.assert_allclose(e.numpy(), np.asarray(re_), rtol=F32_REL,
                               atol=F32_REL * float(np.abs(re_).max()))
    rE, rF = ef(rp, _strip(rb))
    E, Fo = nequip.energy_and_forces(pcfg, params, tb, cg=cg)
    np.testing.assert_allclose(float(E), float(rE), rtol=F32_REL)
    assert Fo.shape == (len(b["positions"]), 3)
    np.testing.assert_allclose(Fo.numpy(), np.asarray(rF), rtol=1e-4,
                               atol=1e-4 * float(np.abs(rF).max()))
    (rl, rm), rg = vg(rp, _strip(rb))
    (loss, met), grads = value_and_grad(
        lambda p, bb: nequip.loss_fn(pcfg, p, bb, cg=cg), params, tb)
    np.testing.assert_allclose(float(loss), float(rl), rtol=F32_REL)
    np.testing.assert_allclose(float(met["rmse"]), float(rm["rmse"]),
                               rtol=F32_REL)
    close(grads, rg, F32_REL, "grad")


def test_node_features_go_through_feat_proj():
    """``full_graph_sm``'s raw node features (d_feat) projected into the
    scalars."""
    cfg, rp, pcfg, params = _pair(d_feat=24)
    assert params["feat_proj"].shape == (24, pcfg.d_hidden)
    b = ref_gnn_batch(cfg, 48, 200, 1, n_graphs=1, d_feat=24)
    rb, tb = _batches(b)
    cg = _ref_cg()
    fwd, _, vg = _ref_fns(cfg, 1)
    re_ = fwd(rp, _strip(rb))
    e = nequip.forward(pcfg, params, tb, cg=cg)
    np.testing.assert_allclose(e.numpy(), np.asarray(re_), rtol=F32_REL)
    no_feats = {k: v for k, v in tb.items() if k != "node_feats"}
    assert not torch.equal(e, nequip.forward(pcfg, params, no_feats, cg=cg))
    (_, _), rg = vg(rp, _strip(rb))
    (_, _), grads = value_and_grad(
        lambda p, bb: nequip.loss_fn(pcfg, p, bb, cg=cg), params, tb)
    close(grads, rg, F32_REL, "grad")


def test_train_step_matches_reference():
    """One AdamW step of ``loss_fn`` on a molecule batch, from the
    reference's parameters and state."""
    cfg, rp, pcfg, params = _pair()
    b = _molecules(seed=4)
    ng = b.pop("n_graphs")
    rb, tb = _batches(b)
    cg = _ref_cg()
    step_case(cfg, rp, rb, pcfg, params, tb,
              lambda p, bb: ref_nq.loss_fn(cfg, p, {**bb, "n_graphs": ng}),
              lambda p, bb: nequip.loss_fn(pcfg, p, {**bb, "n_graphs": ng},
                                           cg=cg), True)


# ---------------------------------------------------------------------------
# the reference's invariance tests, on the port's own CG and parameters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config("nequip")
    params = nequip.init_params(cfg, seed=0, device="cpu")
    b = gnn_batch(cfg, 40, 120, 0, n_graphs=2)
    return cfg, params, _batches(b)[1]


def _rot(seed):
    return torch.from_numpy(e3.random_rotation(
        np.random.default_rng(seed))).float()


def test_rotation_invariance(setup):
    cfg, params, batch = setup
    e0 = nequip.forward(cfg, params, batch)
    for seed in range(3):
        R = _rot(seed)
        e1 = nequip.forward(cfg, params, {**batch,
                                          "positions": batch["positions"] @ R.T})
        np.testing.assert_allclose(e0.numpy(), e1.numpy(), rtol=2e-3,
                                   atol=1e-3)


def test_translation_invariance(setup):
    cfg, params, batch = setup
    e0 = nequip.forward(cfg, params, batch)
    b2 = {**batch, "positions": batch["positions"]
          + torch.tensor([5., -3., 1.])}
    np.testing.assert_allclose(e0.numpy(), nequip.forward(cfg, params,
                                                          b2).numpy(),
                               rtol=2e-3, atol=1e-3)


def test_permutation_invariance(setup):
    cfg, params, batch = setup
    e0 = nequip.forward(cfg, params, batch)
    n = batch["positions"].shape[0]
    perm = torch.from_numpy(np.random.default_rng(1).permutation(n))
    inv = torch.argsort(perm)
    b2 = dict(batch)
    for k in ("positions", "species", "node_mask", "graph_id"):
        b2[k] = batch[k][perm]
    b2["src"] = inv[batch["src"].long()]
    b2["dst"] = inv[batch["dst"].long()]
    np.testing.assert_allclose(e0.numpy(), nequip.forward(cfg, params,
                                                          b2).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_forces_equivariance(setup):
    """Forces rotate with the system: F(Rx) = R F(x)."""
    cfg, params, batch = setup
    _, f0 = nequip.energy_and_forces(cfg, params, batch)
    R = _rot(5)
    _, f1 = nequip.energy_and_forces(
        cfg, params, {**batch, "positions": batch["positions"] @ R.T})
    np.testing.assert_allclose((f0 @ R.T).numpy(), f1.numpy(), rtol=5e-3,
                               atol=1e-3)


def test_gradients_flow(setup):
    cfg, params, batch = setup
    (_, _), g = value_and_grad(partial(nequip.loss_fn, cfg), params, batch)
    from repro_torch._tree import tree_leaves
    total = sum(float(x.abs().sum()) for _, x in tree_leaves(g))
    assert np.isfinite(total) and total > 0


# ---------------------------------------------------------------------------
# gnn_common and the data
# ---------------------------------------------------------------------------

def test_csr_and_samplers_match_given_the_reference_draws():
    rng = np.random.default_rng(0)
    n, e = 200, 2000
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    dst[:40] = 7                                  # a heavy row
    dst[dst == 11] = 12                           # node 11 has no in-edge
    r_indptr, r_indices = ref_gc.to_csr(n, src, dst)
    indptr, indices = gnn_common.to_csr(n, src, dst)
    assert indptr.dtype == torch.int64 and indices.dtype == torch.int32
    np.testing.assert_array_equal(indptr.numpy(), np.asarray(r_indptr))
    np.testing.assert_array_equal(indices.numpy(), np.asarray(r_indices))
    seeds = np.array([0, 3, 7, 11, 11, 199, 12, 5, 9, 1], np.int32)
    fan = (5, 3)
    key = jax.random.PRNGKey(0)
    rs, rd = ref_gc.sample_subgraph(key, r_indptr, r_indices,
                                    jnp.asarray(seeds), fan)
    # the reference's draws: one split of the key and one randint a layer
    draws, k, S = [], key, len(seeds)
    for f in fan:
        k, sub = jax.random.split(k)
        draws.append(torch.from_numpy(np.array(
            jax.random.randint(sub, (S, f), 0, 1 << 30))))
        S *= f
    s, d = gnn_common.sample_subgraph(None, indptr, indices,
                                      torch.from_numpy(seeds), fan,
                                      draws=draws)
    assert s.dtype == d.dtype == torch.int32
    assert s.shape == (10 * 5 + 50 * 3,)
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(d.numpy(), np.asarray(rd))
    l0 = gnn_common.sample_layer(None, indptr, indices,
                                 torch.from_numpy(seeds), 5, r=draws[0])
    rl0 = ref_gc.sample_layer(jax.random.split(key)[1], r_indptr, r_indices,
                              jnp.asarray(seeds), 5)
    for a, b in zip(l0, rl0):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # every sampled edge is a graph edge, or a zero-degree node's self-loop
    es = set(zip(src.tolist(), dst.tolist()))
    deg = np.bincount(dst, minlength=n)
    for a, b in zip(s.tolist(), d.tolist()):
        assert (a, b) in es or (a == b and deg[b] == 0)
    # the port's own draws: a function of its generator
    g1 = gnn_common.sample_subgraph(torch.Generator().manual_seed(3), indptr,
                                    indices, torch.from_numpy(seeds), fan)
    g2 = gnn_common.sample_subgraph(torch.Generator().manual_seed(3), indptr,
                                    indices, torch.from_numpy(seeds), fan)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_batch_molecules_and_gnn_batch_are_bit_for_bit():
    rng = np.random.default_rng(2)
    pos = rng.normal(size=(5, 7, 3)).astype(np.float32)
    spec = rng.integers(0, 9, size=(5, 7)).astype(np.int32)
    edges = rng.integers(0, 7, size=(5, 11, 2)).astype(np.int32)
    for a, b in zip(gnn_common.batch_molecules(pos, spec, edges, 5),
                    ref_gc.batch_molecules(pos, spec, edges, 5)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    cfg = get_config("nequip")
    for args, kw in (((3840, 8192, 0), {"n_graphs": 128}),
                     ((48, 160, 0), {"n_graphs": 4}),
                     ((300, 1000, 5), {"n_graphs": 1, "d_feat": 17})):
        ours, ref = gnn_batch(cfg, *args, **kw), ref_gnn_batch(cfg, *args,
                                                               **kw)
        assert ours.keys() == ref.keys()
        for k in ref:
            if k == "n_graphs":
                assert ours[k] == ref[k]
                continue
            assert ours[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


# ---------------------------------------------------------------------------
# the gnn family: get_api and the trainer
# ---------------------------------------------------------------------------

def test_train_driver_crashes_and_resumes(tmp_path):
    # one thread: the smoke config's ops are tiny, and more threads only
    # contend with the other test processes
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--device",
            "cpu", "--arch", "nequip", "--steps", "30", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "10", "--log-every", "10"]
    r = subprocess.run(base + ["--fail-at-step", "25"], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode != 0 and "injected failure" in r.stderr
    assert "family=gnn" in r.stdout
    assert CheckpointManager(str(tmp_path)).all_steps() == [10, 20]
    r2 = subprocess.run(base + ["--resume"], env=env, capture_output=True,
                        text=True, timeout=600)
    assert r2.returncode == 0, r2.stdout + r2.stderr
    assert "resumed from step 20" in r2.stdout
    assert "first-10 mean loss" in r2.stdout
    assert "nan" not in r2.stdout.lower()
    with np.load(tmp_path / "ckpt_0000000029" / "state.npz") as z:
        assert "['params']['layers']['radial']['011']['w1']" in z.files
