"""The port's MoE layers against the JAX reference's, on the CPU.

``_moe_route`` fed the reference's own f32 logits: the choices, their
ranks within each expert and what is kept equal, the bf16 gates bit for
bit, the balance loss within 1 ulp. ``moe_ffn`` (routing, the gather
dispatch, the experts, the combine, the shared experts) for both MoE smoke
configs at f32 (1e-5) and bf16 as shipped (2e-2), an overflowing expert,
one granite-moe-3b layer at its published widths, and the forwards
(``forward``, ``prefill``, ``decode_step``) with deepseek's leading dense
layer. ``moe_ffn_ref`` (the plain per-expert loop) against ``moe_ffn``.
Parameters are the reference's, carried across by ``models.convert``.
"""
import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import transformer as ref_tf

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import lm_params_from_reference, transformer
from repro_torch.models.recsys import topk_lowest_index
from repro_torch._tree import tree_leaves
from torch_train_parity import lm_forward_case

MOE_ARCHS = ["granite-moe-3b-a800m", "deepseek-moe-16b"]
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


@lru_cache(maxsize=None)
def _layer(arch, f32, full_width=False):
    """``(ref cfg, ref layer, port cfg, port layer)``: MoE layer 0 of the
    reference's seed-1 draw (one layer and a 256-row vocabulary at the
    published widths when ``full_width``), carried to the port."""
    if full_width:
        cut = dict(num_layers=1, vocab_size=256)
        cfg = dataclasses.replace(ref_config(arch), **cut)
        pcfg = dataclasses.replace(get_config(arch), **cut)
    else:
        cfg, pcfg = ref_smoke_config(arch), get_smoke_config(arch)
    rp = ref_tf.init_params(cfg, jax.random.PRNGKey(1))
    if f32:
        rp = jax.tree.map(lambda a: a.astype(jnp.float32), rp)
    params = lm_params_from_reference(pcfg, jax.tree.map(np.asarray, rp),
                                      "cpu")
    return (cfg, jax.tree.map(lambda a: a[0], rp["layers"]), pcfg,
            {k: v[0] for k, v in params["layers"].items()})


def _tokens(T, D, seed, f32, offset=None):
    x = np.random.default_rng(seed).normal(size=(T, D)).astype(np.float32)
    if offset is not None:
        x = x + offset
    dt = (jnp.float32, torch.float32) if f32 else (jnp.bfloat16,
                                                   torch.bfloat16)
    return jnp.asarray(x, dt[0]), torch.from_numpy(x).to(dt[1])


def _route_pair(cfg, pcfg, rlp, lp, xj, xt, C):
    """Both packages' routes of one block, the port fed the reference's
    logits."""
    ref = ref_tf._moe_route(cfg, rlp["router"], xj, C)
    logits = np.asarray(xj.astype(jnp.float32) @ rlp["router"])
    port = transformer._moe_route(pcfg, lp["router"], xt, C,
                                  logits=torch.from_numpy(logits.copy()))
    return ref, port


def _assert_route_equal(ref, port):
    r_e, r_rank, r_keep, r_gates, r_aux = (np.asarray(a) for a in ref)
    flat_e, rank, keep, gates, aux = port
    np.testing.assert_array_equal(flat_e.numpy(), r_e)
    np.testing.assert_array_equal(rank.numpy(), r_rank)
    np.testing.assert_array_equal(keep.numpy(), r_keep)
    assert gates.dtype == torch.bfloat16 and r_gates.dtype == jnp.bfloat16
    np.testing.assert_array_equal(gates.view(torch.int16).numpy(),
                                  r_gates.view(np.int16))
    assert aux.dtype == torch.float32
    assert abs(float(aux) - float(r_aux)) <= np.spacing(np.float32(r_aux))


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("T,C", [(64, None), (64, 3), (7, None), (1, 1)],
                         ids=["T64", "T64-C3", "T7", "T1"])
def test_route_equals_the_reference_given_its_logits(arch, T, C):
    cfg, rlp, pcfg, lp = _layer(arch, True)
    xj, xt = _tokens(T, cfg.d_model, T, True)
    C = C or transformer.capacity(pcfg, T)
    ref, port = _route_pair(cfg, pcfg, rlp, lp, xj, xt, C)
    _assert_route_equal(ref, port)


def test_capacity_is_the_reference_expression():
    """C = max(int(T K / E x factor), 1), the float rounding included."""
    for arch in MOE_ARCHS:
        cfg = get_config(arch)
        for T in (1, 4, 7, 64, 2048, 8192, 8256):
            for cf in (1.0, 1.25, cfg.num_experts / cfg.top_k * 1.001):
                c = dataclasses.replace(cfg, capacity_factor=cf)
                assert transformer.capacity(c, T) == max(
                    int(T * c.top_k / c.num_experts * cf), 1)
    c = get_config("deepseek-moe-16b")
    assert transformer.capacity(c, 8192) == 960
    assert transformer.capacity(c, 4) == 1


def _routing_flips(cfg, rlp, lp, xj, xt):
    """Tokens whose top-k choices differ between the packages, and the
    reference's smallest top-k margin (the K-th minus the (K+1)-th
    probability) over all tokens."""
    rprobs = np.asarray(jax.nn.softmax(xj.astype(jnp.float32)
                                       @ rlp["router"], axis=-1))
    _, ridx = jax.lax.top_k(jnp.asarray(rprobs), cfg.top_k)
    probs = torch.softmax(xt.float() @ lp["router"], dim=-1)
    _, idx = topk_lowest_index(probs, cfg.top_k)
    flips = int((idx.numpy() != np.asarray(ridx)).any(1).sum())
    srt = -np.sort(-rprobs, axis=1)
    margin = float((srt[:, cfg.top_k - 1] - srt[:, cfg.top_k]).min())
    return flips, margin


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_moe_ffn_matches_reference(arch, f32):
    cfg, rlp, pcfg, lp = _layer(arch, f32)
    xj, xt = _tokens(64, cfg.d_model, 5, f32)
    flips, margin = _routing_flips(cfg, rlp, lp, xj, xt)
    assert flips == 0, (f"{flips} tokens routed differently; the "
                        f"reference's smallest top-k margin is {margin:.3g}")
    ry, raux = ref_tf.moe_ffn(cfg, rlp, xj)
    y, aux = transformer.moe_ffn(pcfg, lp, xt)
    assert y.dtype == xt.dtype and y.shape == xt.shape
    tol = F32_TOL if f32 else BF16_TOL
    np.testing.assert_allclose(y.float().numpy(), np.asarray(ry, np.float32),
                               **tol)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-6)
    # the plain per-expert loop computes the same function
    y2, aux2, dropped = transformer.moe_ffn_ref(pcfg, lp, xt)
    np.testing.assert_allclose(y2.float().numpy(), y.float().numpy(), **tol)
    assert float(aux2) == float(aux)
    flat_e, rank, keep, _, _ = transformer._moe_route(
        pcfg, lp["router"], xt, transformer.capacity(pcfg, 64))
    assert dropped == int((~keep).sum())


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_overflow_drops_the_same_tokens_in_token_order(arch):
    """A router biased so that every token's first choice is expert 3:
    past its capacity the later tokens are dropped, the same ones in both
    packages; the per-expert loop drops the same ones."""
    cfg, rlp, pcfg, lp = _layer(arch, True)
    D, E = cfg.d_model, cfg.num_experts
    u = np.zeros(D, np.float32)
    u[:8] = 1.0
    router = np.array(rlp["router"])
    router[:, 3] += 0.5 * u
    rlp = {**rlp, "router": jnp.asarray(router)}
    lp = {**lp, "router": torch.from_numpy(router)}
    xj, xt = _tokens(64, D, 9, True, offset=u)
    C = transformer.capacity(pcfg, 64)
    ref, port = _route_pair(cfg, pcfg, rlp, lp, xj, xt, C)
    _assert_route_equal(ref, port)
    flat_e, rank, keep = (t.numpy() for t in port[:3])
    first = flat_e.reshape(64, cfg.top_k)[:, 0]
    assert (first == 3).all()
    to3 = np.nonzero(flat_e == 3)[0]
    assert len(to3) == 64 > C
    np.testing.assert_array_equal(rank[to3], np.arange(64))   # token order
    np.testing.assert_array_equal(keep[to3], np.arange(64) < C)
    ry, _ = ref_tf.moe_ffn(cfg, rlp, xj)
    y, _ = transformer.moe_ffn(pcfg, lp, xt)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **F32_TOL)
    y2, _, dropped = transformer.moe_ffn_ref(pcfg, lp, xt)
    np.testing.assert_allclose(y2.numpy(), y.numpy(), **F32_TOL)
    assert dropped == int((~keep).sum()) >= 64 - C


def test_shared_experts_add_their_swiglu():
    """deepseek's shared experts: a SwiGLU of ``num_shared_experts`` x
    ``d_ff`` columns over every token, added to the routed output; with
    the routed experts zeroed, the output is that SwiGLU alone."""
    cfg, rlp, pcfg, lp = _layer("deepseek-moe-16b", True)
    assert pcfg.num_shared_experts == 1
    assert lp["ws_gate"].shape == (cfg.d_model,
                                   cfg.d_ff * cfg.num_shared_experts)
    xj, xt = _tokens(32, cfg.d_model, 3, True)
    zero = {k: (torch.zeros_like(v) if k.startswith("we_") else v)
            for k, v in lp.items()}
    y, _ = transformer.moe_ffn(pcfg, zero, xt)
    shared = transformer.swiglu(xt, lp["ws_gate"], lp["ws_up"],
                                lp["ws_down"])
    assert torch.equal(y, shared)
    rzero = {k: (jnp.zeros_like(v) if k.startswith("we_") else v)
             for k, v in rlp.items()}
    ry, _ = ref_tf.moe_ffn(cfg, rzero, xj)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **F32_TOL)
    routed, _ = transformer._moe_ffn_dense(pcfg, lp, xt)
    full, _ = transformer.moe_ffn(pcfg, lp, xt)
    assert torch.equal(full, routed + shared)


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_granite_layer_at_published_width(f32):
    """One granite-moe-3b-a800m MoE layer as published (d_model 1,536, 40
    experts, top-8, d_ff 512) on 64 tokens."""
    cfg, rlp, pcfg, lp = _layer("granite-moe-3b-a800m", f32, True)
    assert (pcfg.d_model, pcfg.num_experts, pcfg.top_k, pcfg.d_ff) == \
        (1536, 40, 8, 512)
    assert lp["we_gate"].shape == (40, 1536, 512)
    xj, xt = _tokens(64, cfg.d_model, 11, f32)
    flips, margin = _routing_flips(cfg, rlp, lp, xj, xt)
    assert flips == 0, (f"{flips} tokens routed differently; the "
                        f"reference's smallest top-k margin is {margin:.3g}")
    ry, raux = ref_tf.moe_ffn(cfg, rlp, xj)
    y, aux = transformer.moe_ffn(pcfg, lp, xt)
    np.testing.assert_allclose(y.float().numpy(), np.asarray(ry, np.float32),
                               **(F32_TOL if f32 else BF16_TOL))
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_forwards_match_reference(arch, f32):
    """``forward_hidden`` (with the balance loss summed over the layers),
    ``forward``, ``prefill`` (the dense layer's KV first) and
    ``decode_step`` (the layers counted across both stacks)."""
    lm_forward_case(arch, f32)


def test_deepseek_tree_has_its_leading_dense_layer():
    cfg = get_smoke_config("deepseek-moe-16b")
    spec = transformer.param_spec(cfg)
    assert spec["dense_layers"]["w_gate"].shape == (1, cfg.d_model,
                                                    cfg.dense_ff)
    assert spec["layers"]["we_gate"].shape == (
        cfg.num_layers - 1, cfg.num_experts, cfg.d_model, cfg.d_ff)
    assert spec["layers"]["router"].dtype == torch.float32
    assert "dense_layers" not in transformer.param_spec(
        get_smoke_config("granite-moe-3b-a800m"))
    full = get_config("deepseek-moe-16b")
    n = sum(int(np.prod(leaf.shape)) for _, leaf in
            tree_leaves(transformer.param_spec(full)))
    assert 16.3e9 < n < 16.6e9


def test_decode_chain_matches_forward_when_nothing_drops():
    """With a capacity factor at which no expert overflows (decode routes
    each step's B tokens as one block, the forward all B x S), prefill and
    a chain of decode steps give the forward's logits."""
    pcfg = get_smoke_config("deepseek-moe-16b")
    pcfg = dataclasses.replace(pcfg, capacity_factor=pcfg.num_experts
                               / pcfg.top_k * 1.001)
    params = transformer.init_params(pcfg, seed=2, device="cpu")
    params = {k: (v.float() if torch.is_tensor(v) else
                  {n: w.float() for n, w in v.items()})
              for k, v in params.items()}
    tokens = torch.randint(0, pcfg.vocab_size, (3, 14),
                           generator=torch.Generator().manual_seed(0))
    full, _ = transformer.forward(pcfg, params, tokens)
    _, pre = transformer.prefill(pcfg, params, tokens[:, :8])
    cache = {k: torch.zeros((pcfg.num_layers, 3, 14, pcfg.num_kv_heads,
                             pcfg.head_dim)) for k in ("k", "v")}
    for k in cache:
        cache[k][:, :, :8] = pre[k]
    for t in range(8, 14):
        logits, cache = transformer.decode_step(
            pcfg, params, cache, tokens[:, t], torch.full((3,), t))
        np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                   **F32_TOL)


def test_carry_checks_moe_trees():
    """``lm_params_from_reference`` carries a MoE tree (deepseek's
    ``dense_layers`` included) leaf for leaf, bit for bit, and refuses a
    wrong shape or a missing stack."""
    cfg = ref_smoke_config("deepseek-moe-16b")
    tree = jax.tree.map(np.asarray, ref_tf.init_params(
        cfg, jax.random.PRNGKey(4)))
    pcfg = get_smoke_config("deepseek-moe-16b")
    params = lm_params_from_reference(pcfg, tree, "cpu")
    for path, t in tree_leaves(params):
        r = tree
        for k in path:
            r = r[k]
        assert str(t.dtype).split(".")[-1] == str(r.dtype), path
        np.testing.assert_array_equal(t.float().numpy(),
                                      r.astype(np.float32))
    bad = {**tree, "layers": {**tree["layers"],
                              "we_up": tree["layers"]["we_up"][:, :4]}}
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_reference(pcfg, bad, "cpu")
    with pytest.raises(ValueError, match="structures differ"):
        lm_params_from_reference(pcfg, {k: v for k, v in tree.items()
                                        if k != "dense_layers"}, "cpu")
