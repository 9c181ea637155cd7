"""One ``make_train_step`` of the port against the reference's jitted one,
for every dense LM and recsys smoke arch (``tests/test_models_smoke.py::
test_train_step_finite_and_updates`` on the port): the loss, the gradient
norm, the learning rate, the new parameters, ``m``, ``v`` and ``step``,
from the reference's parameters and AdamW state carried across.
Tolerances: ``tests/torch_train_parity.py``.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import lm_token_batch
from repro.models import get_api as ref_get_api
from repro.models import make_train_step as ref_make_train_step
from repro.models import recsys as ref_recsys
from repro.models import transformer as ref_tf
from repro.train import adamw_init as ref_adamw_init

from repro_torch.configs import get_smoke_config
from repro_torch.models import (adamw_state_from_reference, get_api,
                                make_train_step, recsys, transformer)
from repro_torch._tree import tree_leaves
from repro_torch.train import adamw_init
from torch_train_parity import (BF16_REL, BF16_U, F32_REL, LM_ARCHS,
                                RS_ARCHS, close, lm_pair, rs_pair,
                                sorted_port)


# ---------------------------------------------------------------------------
# make_train_step: one step of the port against the reference's jitted one
# ---------------------------------------------------------------------------

def _params_close(port_tree, ref_tree, m_ref, lr, grad_rel):
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


def _step_case(cfg, rp, rbatch, pcfg, params, tbatch, ref_loss, loss, f32):
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
    p2, state2, met = make_train_step(loss, api.opt_cfg)(params, state,
                                                         tbatch)
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
    _params_close(p2, rp2, rstate2["m"], float(rmet["lr"]), rel)
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


@pytest.mark.parametrize("arch,f32", [(a, False) for a in LM_ARCHS]
                         + [("stablelm-1.6b", True)],
                         ids=LM_ARCHS + ["stablelm-1.6b-f32"])
def test_lm_train_step_matches_reference(arch, f32):
    cfg, rp, pcfg, params = lm_pair(arch, f32)
    tokens = lm_token_batch(cfg.vocab_size, 2, 16, 7)
    _step_case(cfg, rp, {"tokens": jnp.asarray(tokens)}, pcfg, params,
               {"tokens": torch.from_numpy(tokens)},
               lambda p, b: ref_tf.lm_loss(cfg, p, b["tokens"]),
               lambda p, b: transformer.lm_loss(pcfg, p, b["tokens"]), f32)


@pytest.mark.parametrize("arch", RS_ARCHS)
def test_recsys_train_step_matches_reference(arch):
    cfg, rp, rb, params, tb = rs_pair(arch, seed=4)
    _step_case(cfg, rp, rb, get_smoke_config(arch), params, tb,
               partial(ref_recsys.loss_fn, cfg),
               partial(recsys.loss_fn, get_smoke_config(arch)), True)
