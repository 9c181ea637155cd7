"""Shared helpers of the model and training parity tests
(``test_torch_models.py``, ``test_torch_train_*.py``, ``test_torch_moe*.py``,
``test_torch_nequip.py``): the reference's parameters carried into the
port (``models.convert``), the same numpy batches from a seed, leaf
comparisons in the reference's leaf order, an LM's forwards
(``lm_forward_case``) and one train step (``step_case``) held to the
reference's.

Tolerances, each relative to the largest magnitude of the leaf compared:

* f32 (an f32 cast of an LM, every recsys tower): losses to 1e-6 relative,
  gradients and first moments to 1e-5, second moments to 2e-5 (a squared
  gradient). The two CPU backends round their GEMMs, reductions and
  transcendentals differently, by a few ulps (measured: <= 7e-7);
* bf16 LMs as shipped: losses to 1e-3 relative, gradients and moments to
  4 x 2^-8 and the second moments to 8 x 2^-8. Each activation and matmul
  output is rounded to bf16 (unit roundoff 2^-8) in both packages, at
  different points of the fused and unfused graphs, and a gradient passes
  several of those roundings (measured: <= 9e-3);
* a leaf that is all rounding noise (a gradient that is 0 in exact
  arithmetic, such as a bias under a softmax) is held to the same share of
  1e-3 of the tree's largest magnitude;
* parameters after one step: the update is ``lr * m / (sqrt(v) + eps)``
  with ``lr`` = 3e-6 at step 1 (warm-up), about ``lr * sign(g)``: held to
  the reference's within 2.5 ``lr`` where the reference's gradient is
  within the gradients' tolerance of 0 (a sign the two roundings may flip)
  and to ``lr`` / 4 elsewhere; a bf16 parameter also within one bf16
  rounding of its value.
"""
import dataclasses
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import lm_token_batch, recsys_batch
from repro.models import get_api as ref_get_api
from repro.models import make_train_step as ref_make_train_step
from repro.models import recsys as ref_recsys
from repro.models import transformer as ref_tf
from repro.train import adamw_init as ref_adamw_init

from repro_torch.configs import get_smoke_config
from repro_torch.models import (adamw_state_from_reference, get_api,
                                lm_params_from_reference, make_train_step,
                                recsys, recsys_params_from_reference,
                                transformer)
from repro_torch.train import adamw_init
from repro_torch._tree import tree_leaves, tree_map

LM_ARCHS = ["stablelm-1.6b", "codeqwen1.5-7b", "yi-9b"]
RS_ARCHS = ["wide-deep", "autoint", "dien", "sasrec"]
BF16_U = 2.0 ** -8
F32_REL, BF16_REL = 1e-5, 4 * BF16_U
F32_FWD_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_FWD_TOL = dict(rtol=2e-2, atol=2e-2)


def sorted_port(tree):
    """The port's ``(path, f32 numpy leaf)`` pairs in the reference's
    order (JAX sorts dict keys)."""
    pairs = sorted(tree_leaves(tree), key=lambda pl: [str(k) for k in pl[0]])
    return [(pl[0], pl[1].float().numpy()) for pl in pairs]


def close(port_tree, ref_tree, rel, what):
    """Each leaf within ``rel`` of its largest magnitude, or of 1e-3 of the
    tree's largest where a leaf is all rounding noise."""
    port = sorted_port(port_tree)
    ref = [np.asarray(r, np.float32) for r in jax.tree.leaves(ref_tree)]
    assert len(port) == len(ref)
    floor = 1e-3 * max(float(np.abs(r).max()) for r in ref)
    for (path, p), r in zip(port, ref):
        assert p.shape == r.shape, (what, path)
        scale = max(float(np.abs(r).max()), floor, 1e-30)
        err = float(np.abs(p - r).max()) / scale
        assert err <= rel, f"{what} {path}: {err:.3g} > {rel:.3g}"


def lm_cfgs(arch, **overrides):
    return (dataclasses.replace(ref_smoke_config(arch), **overrides),
            dataclasses.replace(get_smoke_config(arch), **overrides))


@lru_cache(maxsize=None)
def _lm_ref_params(arch, f32, overrides=()):
    cfg, _ = lm_cfgs(arch, **dict(overrides))
    rp = ref_tf.init_params(cfg, jax.random.PRNGKey(1))
    if f32:
        rp = jax.tree.map(lambda a: a.astype(jnp.float32), rp)
    return rp


def lm_pair(arch, f32, **overrides):
    """``(ref cfg, ref params, port cfg, port params)``: the reference's
    seed-1 draw (cast to f32 if ``f32``) carried to the port's CPU tree."""
    cfg, pcfg = lm_cfgs(arch, **overrides)
    rp = _lm_ref_params(arch, f32, tuple(sorted(overrides.items())))
    return cfg, rp, pcfg, lm_params_from_reference(
        pcfg, jax.tree.map(np.asarray, rp), "cpu")


@lru_cache(maxsize=None)
def _rs_ref_params(arch):
    return ref_recsys.init_params(ref_smoke_config(arch),
                                  jax.random.PRNGKey(0))


def rs_pair(arch, batch_size=16, seed=2):
    """``(ref cfg, ref params, ref batch, port params, port batch)``."""
    cfg = ref_smoke_config(arch)
    rp = _rs_ref_params(arch)
    params = recsys_params_from_reference(get_smoke_config(arch),
                                          jax.tree.map(np.asarray, rp), "cpu")
    batch = recsys_batch(cfg, batch_size, seed)
    return (cfg, rp, {k: jnp.asarray(v) for k, v in batch.items()}, params,
            recsys.batch_to(batch, "cpu"))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return x.float().numpy()


def lm_forward_case(arch, f32, B=2, S=12, **overrides):
    """``forward_hidden``, ``forward``, ``prefill`` and one ``decode_step``
    of the port against the reference's on the same tokens (f32 cast at
    1e-5, bf16 as shipped at 2e-2, the reference test's tolerance), and
    decode against the port's own full forward at 2e-2."""
    cfg, rp, pcfg, params = lm_pair(arch, f32, **overrides)
    tokens = lm_token_batch(cfg.vocab_size, B, S, 3)[:, :S]
    tol = F32_FWD_TOL if f32 else BF16_FWD_TOL

    rh, raux = jax.jit(partial(ref_tf.forward_hidden, cfg))(
        rp, jnp.asarray(tokens))
    h, aux = transformer.forward_hidden(pcfg, params,
                                        torch.from_numpy(tokens))
    assert h.dtype == (torch.float32 if f32 else torch.bfloat16)
    assert aux.dtype == torch.float32
    assert (float(aux) == 0.0) == (not cfg.moe)
    np.testing.assert_allclose(float(aux), float(raux), **tol)
    np.testing.assert_allclose(_t(h), _np(rh), **tol)

    rlogits, _ = jax.jit(partial(ref_tf.forward, cfg))(rp, jnp.asarray(tokens))
    logits, _ = transformer.forward(pcfg, params, torch.from_numpy(tokens))
    assert logits.dtype == torch.float32
    assert logits.shape == (B, S, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), **tol)

    rpre, rcache = jax.jit(partial(ref_tf.prefill, cfg))(
        rp, jnp.asarray(tokens[:, :-1]))
    pre, cache = transformer.prefill(pcfg, params,
                                     torch.from_numpy(tokens[:, :-1]))
    np.testing.assert_allclose(pre.numpy(), np.asarray(rpre), **tol)
    for name in ("k", "v"):
        assert cache[name].shape == rcache[name].shape
        np.testing.assert_allclose(_t(cache[name]), _np(rcache[name]), **tol)

    pad = ((0, 0), (0, 0), (0, 4), (0, 0), (0, 0))
    rcache = {k: jnp.pad(v, pad) for k, v in rcache.items()}
    cache = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 4))
             for k, v in cache.items()}
    pos = np.full((B,), S - 1, np.int32)
    rdec, rcache2 = jax.jit(partial(ref_tf.decode_step, cfg))(rp, rcache,
                                       jnp.asarray(tokens[:, -1]),
                                       jnp.asarray(pos))
    k_before = cache["k"]
    dec, cache2 = transformer.decode_step(pcfg, params, cache,
                                          torch.from_numpy(tokens[:, -1]),
                                          torch.from_numpy(pos))
    assert cache2["k"] is k_before                       # written in place
    np.testing.assert_allclose(dec.numpy(), np.asarray(rdec), **tol)
    for name in ("k", "v"):
        np.testing.assert_allclose(_t(cache2[name]), _np(rcache2[name]),
                                   **tol)
    # the reference's own consistency bound: decode vs the full forward
    np.testing.assert_allclose(dec.numpy(), logits[:, -1].numpy(),
                               **BF16_FWD_TOL)


def params_close(port_tree, ref_tree, m_ref, lr, grad_rel):
    """One step's parameters: within ``lr`` / 4 of the reference's, or 2.5
    ``lr`` where the reference's gradient (``m`` = 0.1 x the clipped
    gradient after one step) is within ``grad_rel`` of 0 and its sign may
    differ; a bf16 leaf also within one bf16 rounding of its value."""
    port = sorted_port(port_tree)
    ref = jax.tree.leaves(ref_tree)
    mref = [np.asarray(m, np.float32) for m in jax.tree.leaves(m_ref)]
    for (path, p), r, m in zip(port, ref, mref):
        r32 = np.asarray(r, np.float32)
        tiny = np.abs(m) <= grad_rel * max(float(np.abs(m).max()), 1e-30)
        bound = np.where(tiny, 2.5 * lr, lr / 4)
        if np.asarray(r).dtype != np.float32:          # bf16 as shipped
            bound = bound + BF16_U * np.abs(r32)
        assert (np.abs(p - r32) <= bound).all(), path


def step_case(cfg, rp, rbatch, pcfg, params, tbatch, ref_loss, loss, f32):
    """One ``make_train_step`` of the port against the reference's jitted
    one, from the reference's parameters and AdamW state carried across:
    the loss, the gradient norm, the learning rate, ``m``, ``v``, ``step``
    and the new parameters, every leaf changed that changed there."""
    rapi = ref_get_api(cfg)
    api = get_api(pcfg)
    assert api.family == rapi.family
    assert dataclasses.asdict(api.opt_cfg) == dataclasses.asdict(rapi.opt_cfg)
    rstate = ref_adamw_init(rp)
    state = adamw_state_from_reference(jax.tree.map(np.asarray, rstate),
                                       "cpu")
    own = dict(tree_leaves(adamw_init(params)))
    carried = dict(tree_leaves(state))
    assert carried.keys() == own.keys()
    for path, a in carried.items():
        assert a.dtype == own[path].dtype and torch.equal(a, own[path])
    rp2, rstate2, rmet = jax.jit(ref_make_train_step(ref_loss,
                                                     rapi.opt_cfg))(
        rp, rstate, rbatch)
    # the step updates its parameters in place: keep ``params`` to compare
    p2, state2, met = make_train_step(loss, api.opt_cfg)(
        tree_map(torch.clone, params), state, tbatch)
    rel = F32_REL if f32 else BF16_REL
    np.testing.assert_allclose(float(met["loss"]), float(rmet["loss"]),
                               rtol=1e-6 if f32 else 1e-3)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(rmet["grad_norm"]), rtol=rel)
    np.testing.assert_allclose(float(met["lr"]), float(rmet["lr"]),
                               rtol=2 ** -20)
    assert int(state2["step"]) == int(rstate2["step"]) == 1
    assert state2["step"].dtype == torch.int32
    close(state2["m"], rstate2["m"], rel, "m")
    close(state2["v"], rstate2["v"], 2 * rel, "v")
    params_close(p2, rp2, rstate2["m"], float(rmet["lr"]), rel)
    # the reference test's own check: finite, and a leaf changed; here,
    # every leaf changed that changed in the reference (an unused leaf of
    # zeros, such as a tower's unread projection bias, stays)
    changed = [bool(np.any(np.asarray(a) != np.asarray(b))) for a, b in
               zip(jax.tree.leaves(rp), jax.tree.leaves(rp2))]
    assert any(changed)
    for ((path, a), (_, b)), ch in zip(zip(sorted_port(params),
                                           sorted_port(p2)), changed):
        assert np.isfinite(b).all()
        assert bool(np.any(a != b)) == ch, path
