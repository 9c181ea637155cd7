"""One ``make_train_step`` of the port against the reference's jitted one,
for every dense LM and recsys smoke arch (``tests/test_models_smoke.py::
test_train_step_finite_and_updates`` on the port): the loss, the gradient
norm, the learning rate, the new parameters, ``m``, ``v`` and ``step``,
from the reference's parameters and AdamW state carried across.
Tolerances: ``tests/torch_train_parity.py``.
"""
from functools import partial

import jax.numpy as jnp
import pytest
import torch

from repro.data import lm_token_batch
from repro.models import recsys as ref_recsys
from repro.models import transformer as ref_tf

from repro_torch.configs import get_smoke_config
from repro_torch.models import recsys, transformer
from torch_train_parity import LM_ARCHS, RS_ARCHS, lm_pair, rs_pair, step_case


# ---------------------------------------------------------------------------
# make_train_step: one step of the port against the reference's jitted one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,f32", [(a, False) for a in LM_ARCHS]
                         + [("stablelm-1.6b", True)],
                         ids=LM_ARCHS + ["stablelm-1.6b-f32"])
def test_lm_train_step_matches_reference(arch, f32):
    cfg, rp, pcfg, params = lm_pair(arch, f32)
    tokens = lm_token_batch(cfg.vocab_size, 2, 16, 7)
    step_case(cfg, rp, {"tokens": jnp.asarray(tokens)}, pcfg, params,
               {"tokens": torch.from_numpy(tokens)},
               lambda p, b: ref_tf.lm_loss(cfg, p, b["tokens"]),
               lambda p, b: transformer.lm_loss(pcfg, p, b["tokens"]), f32)


@pytest.mark.parametrize("arch", RS_ARCHS)
def test_recsys_train_step_matches_reference(arch):
    cfg, rp, rb, params, tb = rs_pair(arch, seed=4)
    step_case(cfg, rp, rb, get_smoke_config(arch), params, tb,
               partial(ref_recsys.loss_fn, cfg),
               partial(recsys.loss_fn, get_smoke_config(arch)), True)
