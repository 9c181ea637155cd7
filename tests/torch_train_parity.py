"""Shared helpers of the training parity tests (``test_torch_train_loss.py``,
``test_torch_train_step.py``): the reference's parameters carried into the
port (``models.convert``), the same numpy batches from a seed, and leaf
comparisons in the reference's leaf order.

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
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import recsys_batch
from repro.models import recsys as ref_recsys
from repro.models import transformer as ref_tf

from repro_torch.configs import get_smoke_config
from repro_torch.models import (lm_params_from_reference, recsys,
                                recsys_params_from_reference)
from repro_torch._tree import tree_leaves

LM_ARCHS = ["stablelm-1.6b", "codeqwen1.5-7b", "yi-9b"]
RS_ARCHS = ["wide-deep", "autoint", "dien", "sasrec"]
BF16_U = 2.0 ** -8
F32_REL, BF16_REL = 1e-5, 4 * BF16_U


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
