"""The port's embedding models against the JAX reference's, on the CPU.

The same numpy inputs from a seed go through ``repro.models`` and
``repro_torch.models``, with the reference's initial parameters carried
across by ``repro_torch.models.convert``. Tolerances: 1e-5 (relative and
absolute) where both run in f32 (the two CPU backends round their GEMMs and
transcendentals differently, by a few ulps); 2e-2 for the LMs as shipped in
bf16, the tolerance the reference's own prefill/decode test uses
(``tests/test_models_smoke.py``), since one bf16 rounding of an activation
is 2^-8 relative. Retrieval ids are compared exactly, ties included.
"""
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import lm_token_batch, recsys_batch
from repro.models import nequip as ref_nequip
from repro.models import recsys as ref_recsys
from repro.models import transformer as ref_tf
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import (RecSysModel, TransformerLM, nequip,
                                recsys_params_from_reference, recsys,
                                transformer)
from repro_torch._tree import tree_leaves
from torch_train_parity import lm_forward_case, lm_pair

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
LM_ARCHS = ["stablelm-1.6b", "codeqwen1.5-7b", "yi-9b"]
MOE_ARCHS = ["granite-moe-3b-a800m", "deepseek-moe-16b"]
RS_ARCHS = ["wide-deep", "autoint", "dien", "sasrec"]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return x.float().numpy()


# ---------------------------------------------------------------------------
# recsys towers
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _recsys_params(arch):
    """The reference's initial params and the port's carried copy (one
    draw per arch for the whole file; nothing here mutates them)."""
    ref_params = ref_recsys.init_params(ref_smoke_config(arch),
                                        jax.random.PRNGKey(0))
    return ref_params, recsys_params_from_reference(
        get_smoke_config(arch), jax.tree.map(np.asarray, ref_params), "cpu")


def _recsys_pair(arch, batch_size=8, seed=1):
    cfg = ref_smoke_config(arch)
    ref_params, params = _recsys_params(arch)
    batch = recsys_batch(cfg, batch_size, seed)
    return (cfg, ref_params, {k: jnp.asarray(v) for k, v in batch.items()},
            params, recsys.batch_to(batch, "cpu"))


@pytest.mark.parametrize("arch", RS_ARCHS)
def test_recsys_forward_and_user_repr_match(arch):
    cfg, rp, rb, params, tb = _recsys_pair(arch)
    rlogit, ruser = jax.jit(partial(ref_recsys.forward, cfg))(rp, rb)
    logit, user = recsys.forward(cfg, params, tb)
    assert logit.shape == (8,) and user.shape == (8, cfg.embed_dim)
    np.testing.assert_allclose(_t(logit), _np(rlogit), **F32_TOL)
    np.testing.assert_allclose(_t(user), _np(ruser), **F32_TOL)
    np.testing.assert_allclose(_t(recsys.user_repr(cfg, params, tb)),
                               _np(jax.jit(partial(ref_recsys.user_repr, cfg))(
                                   rp, rb)),
                               **F32_TOL)


@pytest.mark.parametrize("arch", RS_ARCHS)
def test_recsys_retrieval_scores_match(arch):
    """Equal ids, and past the catalogue (k > n_items) the ``-inf`` padding
    rows tie: both take them from the lowest id up."""
    cfg, rp, rb, params, tb = _recsys_pair(arch)
    for k in (7, 100, cfg.n_items + 4):
        rtop, ridx = jax.jit(partial(ref_recsys.retrieval_scores, cfg,
                                     k=k))(rp, rb)
        top, idx = recsys.retrieval_scores(cfg, params, tb, k=k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
        np.testing.assert_allclose(_t(top), _np(rtop), **F32_TOL)
    assert np.isinf(_t(top)[:, -4:]).all()
    np.testing.assert_array_equal(idx.numpy()[:, -4:],
                                  np.broadcast_to(cfg.n_items + np.arange(4),
                                                  (8, 4)))


def test_topk_ties_go_to_the_lowest_index_as_lax_top_k():
    rng = np.random.default_rng(0)
    x = rng.integers(-3, 4, size=(16, 300)).astype(np.float32)
    x[rng.random(x.shape) < 0.1] = -np.inf
    x[rng.random(x.shape) < 0.05] = -0.0
    x[:, 100:] = np.where(x[:, 100:] > 2, np.inf, x[:, 100:])
    for k in (1, 5, 37, 300):
        rv, ri = jax.lax.top_k(jnp.asarray(x), k)
        v, i = recsys.topk_lowest_index(torch.from_numpy(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
        assert np.array_equal(np.signbit(v.numpy()), np.signbit(rv))


def test_wide_deep_bag_goes_through_embed_bag():
    """The bag is the port's ``embed_bag`` wrapper (the kernel on a CUDA
    tensor); any bag function of the same contract can stand in."""
    from repro_torch.kernels.embed_bag import embed_bag, embed_bag_ref
    cfg, rp, rb, params, tb = _recsys_pair("wide-deep")
    calls = []

    def counting(table, ids, mode):
        calls.append((tuple(table.shape), tuple(ids.shape), mode))
        return embed_bag_ref(table, ids, mode)
    logit, user = recsys.forward(cfg, params, tb, bag=counting)
    assert calls == [((cfg.vocab_size, cfg.embed_dim), (8, cfg.bag_len),
                      "sum")]
    l2, u2 = recsys.forward(cfg, params, tb)
    assert torch.equal(logit, l2) and torch.equal(user, u2)
    assert recsys.forward.__kwdefaults__["bag"] is embed_bag


def test_recsys_batch_size_one_and_serving_module():
    cfg, rp, rb, params, tb = _recsys_pair("sasrec", batch_size=1, seed=5)
    model = RecSysModel(cfg, params)
    batch = recsys_batch(cfg, 1, 5)
    logit, user = model(batch)
    rlogit, ruser = jax.jit(partial(ref_recsys.forward, cfg))(rp, rb)
    np.testing.assert_allclose(_t(logit), _np(rlogit), **F32_TOL)
    np.testing.assert_allclose(_t(user), _np(ruser), **F32_TOL)
    top, idx = model.retrieval_scores(batch, k=5)
    assert torch.equal(idx, recsys.retrieval_scores(cfg, params, tb, 5)[1])
    assert not any(b.requires_grad for b in model.buffers())


# ---------------------------------------------------------------------------
# dense LMs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_matches_reference_f32(arch):
    lm_forward_case(arch, f32=True)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_matches_reference_bf16_as_shipped(arch):
    lm_forward_case(arch, f32=False)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_stablelm_published_width_one_layer(f32):
    """d_model 2048, 32 heads (head_dim 64), d_ff 5632: stablelm-1.6b's
    published widths, one layer and a 1,024-row vocabulary."""
    full = get_config("stablelm-1.6b")
    lm_forward_case("stablelm-1.6b", f32, B=2, S=10, num_layers=1,
             vocab_size=1024, d_model=full.d_model, num_heads=full.num_heads,
             num_kv_heads=full.num_kv_heads, d_ff=full.d_ff)


def test_long_sequence_attends_in_query_chunks():
    """S = 2 x Q_CHUNK takes the chunked branch in both packages."""
    cfg, rp, pcfg, params = lm_pair("yi-9b", f32=True, num_layers=1)
    S = 2 * transformer.Q_CHUNK
    assert S == 2 * ref_tf.Q_CHUNK
    tokens = lm_token_batch(cfg.vocab_size, 1, S, 4)[:, :S]
    rh, _ = jax.jit(partial(ref_tf.forward_hidden, cfg))(rp, jnp.asarray(tokens))
    h, _ = transformer.forward_hidden(pcfg, params, torch.from_numpy(tokens))
    np.testing.assert_allclose(_t(h), _np(rh), **F32_TOL)


def test_decode_chain_matches_forward():
    """prefill, then several decode steps from ``init_cache``-shaped room,
    against the full forward (f32 params; the cache is written in place)."""
    cfg, rp, pcfg, params = lm_pair("stablelm-1.6b", f32=True)
    tokens = torch.from_numpy(lm_token_batch(cfg.vocab_size, 3, 15, 8))
    full, _ = transformer.forward(pcfg, params, tokens)
    _, pre = transformer.prefill(pcfg, params, tokens[:, :8])
    cache = {k: torch.zeros((cfg.num_layers, 3, 16, cfg.num_kv_heads,
                             cfg.head_dim)) for k in ("k", "v")}
    for k in cache:
        cache[k][:, :, :8] = pre[k]
    for t in range(8, 16):
        logits, cache = transformer.decode_step(
            pcfg, params, cache, tokens[:, t], torch.full((3,), t))
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   **F32_TOL)
    bf = transformer.init_cache(pcfg, 3, 16, device="cpu")
    assert bf["k"].dtype == torch.bfloat16
    assert bf["k"].shape == (cfg.num_layers, 3, 16, cfg.num_kv_heads,
                             cfg.head_dim)


def test_transformer_module_wraps_the_functional_forwards():
    cfg, rp, pcfg, params = lm_pair("codeqwen1.5-7b", f32=False)
    model = TransformerLM(pcfg, params)
    tokens = torch.from_numpy(lm_token_batch(cfg.vocab_size, 2, 9, 1))
    assert torch.equal(model(tokens), transformer.forward(pcfg, params,
                                                          tokens)[0])
    assert torch.equal(model.forward_hidden(tokens),
                       transformer.forward_hidden(pcfg, params, tokens)[0])
    cache = model.init_cache(2, 12)
    logits, cache = model.decode_step(cache, tokens[:, 0],
                                      torch.zeros(2, dtype=torch.int64))
    assert logits.shape == (2, cfg.vocab_size)
    state = model.state_dict()
    assert set(state) == {"/".join(map(str, p)) for p, _ in
                          tree_leaves(params)}
    again = TransformerLM(pcfg, model.params)
    assert torch.equal(again(tokens), model(tokens))


# ---------------------------------------------------------------------------
# initialisation and the carry
# ---------------------------------------------------------------------------

def _modules(arch):
    """(the reference's module, the port's) of an arch's family."""
    if arch in LM_ARCHS + MOE_ARCHS:
        return ref_tf, transformer
    if arch == "nequip":
        return ref_nequip, nequip
    return ref_recsys, recsys


@pytest.mark.parametrize("arch", LM_ARCHS + MOE_ARCHS + ["nequip"]
                         + RS_ARCHS)
def test_init_params_have_the_reference_shapes_dtypes_and_scales(arch):
    """The port draws its own stream, with the reference's tree, shapes,
    dtypes and scales (std within 10% on leaves of 1,000+ entries; the LM
    weights, 0.02 x a standard normal cut at +-2, stay within +-0.04)."""
    ref_mod, mod = _modules(arch)
    ours = dict(tree_leaves(mod.init_params(get_smoke_config(arch), seed=3,
                                            device="cpu")))
    ref = {tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path): r
           for path, r in jax.tree_util.tree_flatten_with_path(
               ref_mod.init_params(ref_smoke_config(arch),
                                   jax.random.PRNGKey(0)))[0]}
    assert ours.keys() == ref.keys()
    for path, t in ours.items():
        r = ref[path]
        assert tuple(t.shape) == r.shape, path
        assert str(t.dtype).split(".")[-1] == str(r.dtype), path
        a, b = _t(t), _np(r)
        if b.std() == 0:
            np.testing.assert_array_equal(a, b)
        elif a.size >= 1000:
            assert abs(a.std() / b.std() - 1) < 0.1, path
        if t.dtype == torch.bfloat16:        # 0.02 x N(0, 1) cut at +-2
            assert abs(a).max() <= 1.01 * 2 * 0.02


def test_init_is_a_function_of_the_generator():
    cfg = get_smoke_config("sasrec")
    a = recsys.init_params(cfg, seed=4, device="cpu")
    b = recsys.init_params(cfg, torch.Generator().manual_seed(4),
                           device="cpu")
    c = recsys.init_params(cfg, seed=5, device="cpu")
    for (_, x), (_, y), (_, z) in zip(tree_leaves(a), tree_leaves(b),
                                      tree_leaves(c)):
        assert torch.equal(x, y)
    assert not torch.equal(a["item_embed"], c["item_embed"])


def test_carry_checks_shapes():
    cfg = ref_smoke_config("dien")
    tree = jax.tree.map(np.asarray, ref_recsys.init_params(
        cfg, jax.random.PRNGKey(0)))
    tree["gru"]["wz"] = tree["gru"]["wz"][:, :3]
    with pytest.raises(ValueError, match="shape"):
        recsys_params_from_reference(get_smoke_config("dien"), tree, "cpu")
    del tree["gru"]
    with pytest.raises(ValueError, match="structures differ"):
        recsys_params_from_reference(get_smoke_config("dien"), tree, "cpu")
