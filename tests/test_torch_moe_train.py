"""The MoE configs' training against the JAX reference's, on the CPU:
``transformer.lm_loss`` (the CE plus 0.01 x the balance loss summed over
the layers) with remat on and off, every gradient leaf (the router's
through the gates and the balance loss, each expert's through the gather
dispatch, deepseek's leading dense layer), and one ``make_train_step``,
at f32 and bf16 as shipped, from the reference's parameters carried
across. Tolerances: ``tests/torch_train_parity.py``.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import lm_token_batch
from repro.models import transformer as ref_tf

from repro_torch.launch import train
from repro_torch.models import transformer, value_and_grad
from repro_torch.train import CheckpointManager
from repro_torch._tree import tree_leaves
from torch_train_parity import (BF16_REL, F32_REL, close, lm_pair,
                                step_case)

MOE_ARCHS = ["granite-moe-3b-a800m", "deepseek-moe-16b"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("f32,remat", [(True, True), (True, False),
                                       (False, True), (False, False)],
                         ids=["f32-remat", "f32", "bf16-remat", "bf16"])
def test_lm_loss_value_and_grads_match_reference(arch, f32, remat):
    cfg, rp, pcfg, params = lm_pair(arch, f32)
    tokens = lm_token_batch(cfg.vocab_size, 2, 16, 3)
    (rl, rm), rg = jax.jit(jax.value_and_grad(
        partial(ref_tf.lm_loss, cfg, remat=remat), has_aux=True))(
            rp, jnp.asarray(tokens))
    (loss, metrics), grads = value_and_grad(
        lambda p, b: transformer.lm_loss(pcfg, p, b, remat=remat), params,
        torch.from_numpy(tokens))
    rtol = 1e-6 if f32 else 1e-3
    np.testing.assert_allclose(float(loss), float(rl), rtol=rtol)
    np.testing.assert_allclose(float(metrics["loss"]), float(rm["loss"]),
                               rtol=rtol)
    np.testing.assert_allclose(float(metrics["aux"]), float(rm["aux"]),
                               rtol=rtol)
    assert float(metrics["aux"]) > 0
    assert torch.equal(loss, metrics["loss"] + 0.01 * metrics["aux"])
    for (_, g), (_, p) in zip(tree_leaves(grads), tree_leaves(params)):
        assert g.dtype == p.dtype and g.shape == p.shape
    close(grads, rg, F32_REL if f32 else BF16_REL, "grad")
    assert float(grads["layers"]["router"].abs().max()) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_remat_changes_nothing(arch):
    """Remat recomputes each MoE block (its routing included) and gives
    the same loss bit for bit and the same gradients up to the order in
    which autograd adds a weight's contributions."""
    cfg, rp, pcfg, params = lm_pair(arch, True)
    tokens = torch.from_numpy(lm_token_batch(cfg.vocab_size, 2, 16, 5))
    (a, _), ga = value_and_grad(
        lambda p, b: transformer.lm_loss(pcfg, p, b, remat=True), params,
        tokens)
    (b, _), gb = value_and_grad(
        lambda p, b: transformer.lm_loss(pcfg, p, b, remat=False), params,
        tokens)
    assert torch.equal(a, b)
    for (path, x), (_, y) in zip(tree_leaves(ga), tree_leaves(gb)):
        assert float((x - y).abs().max()) <= 1e-6 * float(y.abs().max()), path


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_moe_train_step_matches_reference(arch, f32):
    cfg, rp, pcfg, params = lm_pair(arch, f32)
    tokens = lm_token_batch(cfg.vocab_size, 2, 16, 7)
    step_case(cfg, rp, {"tokens": jnp.asarray(tokens)}, pcfg, params,
              {"tokens": torch.from_numpy(tokens)},
              lambda p, b: ref_tf.lm_loss(cfg, p, b["tokens"]),
              lambda p, b: transformer.lm_loss(pcfg, p, b["tokens"]), f32)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_driver_trains_the_moe_configs(arch, tmp_path, capsys):
    """``launch/train.py`` trains a MoE config as the ``lm`` family."""
    train.main(["--device", "cpu", "--arch", arch, "--steps", "3", "--batch",
                "2", "--seq", "16", "--ckpt-dir", str(tmp_path),
                "--log-every", "1"])
    out = capsys.readouterr().out
    assert "family=lm" in out and "step     2 loss=" in out
    assert "nan" not in out.lower()
    assert CheckpointManager(str(tmp_path)).all_steps() == [2]
