"""The port's training losses against the JAX reference's, on the CPU:
``transformer.lm_loss`` (remat on and off, one CE chunk and several, a
padded vocabulary) and ``recsys.loss_fn`` for the four towers, value and
every gradient leaf, with the reference's parameters carried across.
Tolerances: ``tests/torch_train_parity.py``.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import lm_token_batch
from repro.models import recsys as ref_recsys
from repro.models import transformer as ref_tf

from repro_torch.kernels.embed_bag import embed_bag_ref
from repro_torch.models import recsys, transformer, value_and_grad
from repro_torch._tree import tree_leaves
from torch_train_parity import (BF16_REL, F32_REL, RS_ARCHS, close, lm_pair,
                                rs_pair, sorted_port)


# ---------------------------------------------------------------------------
# lm_loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("f32,S,remat,overrides", [
    (True, 16, True, {}),
    (True, 16, False, {}),
    (True, 512, True, {"num_layers": 1}),     # the chunked CE branch
    (True, 512, False, {"num_layers": 1}),
    (True, 20, True, {"vocab_size": 200}),    # padded vocabulary masked
    (False, 16, True, {}),                    # bf16 as shipped
    (False, 512, True, {"num_layers": 1}),
], ids=["f32-S16-remat", "f32-S16", "f32-S512-remat", "f32-S512",
        "f32-padded-vocab", "bf16-S16-remat", "bf16-S512-remat"])
def test_lm_loss_value_and_grads_match_reference(f32, S, remat, overrides):
    cfg, rp, pcfg, params = lm_pair("stablelm-1.6b", f32, **overrides)
    assert (cfg.vocab_padded != cfg.vocab_size) == ("vocab_size" in overrides)
    tokens = lm_token_batch(cfg.vocab_size, 2, S, 3)
    (rl, rm), rg = jax.jit(jax.value_and_grad(
        partial(ref_tf.lm_loss, cfg, remat=remat), has_aux=True))(
            rp, jnp.asarray(tokens))
    (loss, metrics), grads = value_and_grad(
        lambda p, b: transformer.lm_loss(pcfg, p, b, remat=remat), params,
        torch.from_numpy(tokens))
    assert loss.dtype == torch.float32 and not loss.requires_grad
    assert float(metrics["aux"]) == 0.0
    np.testing.assert_allclose(float(loss), float(rl),
                               rtol=1e-6 if f32 else 1e-3)
    np.testing.assert_allclose(float(metrics["loss"]), float(rm["loss"]),
                               rtol=1e-6 if f32 else 1e-3)
    for (_, g), (_, p) in zip(tree_leaves(grads), tree_leaves(params)):
        assert g.dtype == p.dtype and g.shape == p.shape
    close(grads, rg, F32_REL if f32 else BF16_REL, "grad")


def test_lm_loss_chunks_equal_one_chunk_and_remat_changes_nothing():
    """The chunked CE (S = 512, two chunks of CE_CHUNK) adds to what one
    chunk over the whole sequence gives; remat recomputes the same loss,
    bit for bit, and the same gradients up to the order in which autograd
    adds a weight's contributions (1e-6 of a leaf's largest)."""
    assert transformer.CE_CHUNK == ref_tf.CE_CHUNK == 256
    cfg, rp, pcfg, params = lm_pair("stablelm-1.6b", True, num_layers=1)
    tokens = torch.from_numpy(lm_token_batch(cfg.vocab_size, 2, 512, 5))
    (l_remat, _), g_remat = value_and_grad(
        lambda p, b: transformer.lm_loss(pcfg, p, b, remat=True), params,
        tokens)
    (l_plain, _), g_plain = value_and_grad(
        lambda p, b: transformer.lm_loss(pcfg, p, b, remat=False), params,
        tokens)
    assert torch.equal(l_remat, l_plain)
    for (path, a), (_, b) in zip(tree_leaves(g_remat), tree_leaves(g_plain)):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-6 * scale, path
    x, _ = transformer.forward_hidden(pcfg, params, tokens[:, :-1])
    whole = transformer._ce_chunk(pcfg, params["lm_head"], x,
                                  tokens[:, 1:]) / (2 * 512)
    np.testing.assert_allclose(float(l_plain), float(whole), rtol=1e-6)


# ---------------------------------------------------------------------------
# recsys.loss_fn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", RS_ARCHS)
def test_recsys_loss_value_and_grads_match_reference(arch):
    cfg, rp, rb, params, tb = rs_pair(arch)
    (rl, _), rg = jax.jit(jax.value_and_grad(
        partial(ref_recsys.loss_fn, cfg), has_aux=True))(rp, rb)
    (loss, metrics), grads = value_and_grad(
        partial(recsys.loss_fn, cfg), params, tb)
    np.testing.assert_allclose(float(loss), float(rl), rtol=1e-6)
    assert torch.equal(loss, metrics["loss"])
    close(grads, rg, 1e-5, "grad")
    if arch == "wide-deep":
        # the bag's table gets the scatter-added gradient of its rows only
        used = np.unique(tb["bag_ids"].numpy())
        used = used[used >= 0]
        rows = grads["bag_table"].abs().sum(1).nonzero().flatten().numpy()
        assert set(rows) <= set(used.tolist()) and len(rows) > 0
    # a leaf the loss never reads gets a zero gradient, as under jax.grad
    for (path, g), r in zip(sorted_port(grads), jax.tree.leaves(rg)):
        if not np.any(np.asarray(r)):
            assert not g.any(), path


def test_wide_deep_loss_through_the_bag_function_signature():
    """``loss_fn``'s ``bag=`` stands in for the bag as ``forward``'s does:
    the plain bag gives the same value and gradients on the CPU."""
    cfg, rp, rb, params, tb = rs_pair("wide-deep", seed=3)
    (a, _), ga = value_and_grad(partial(recsys.loss_fn, cfg), params, tb)
    (b, _), gb = value_and_grad(partial(recsys.loss_fn, cfg,
                                        bag=embed_bag_ref), params, tb)
    assert torch.equal(a, b)
    for (_, x), (_, y) in zip(tree_leaves(ga), tree_leaves(gb)):
        assert torch.equal(x, y)
