"""The port's training substrate against the JAX reference's, on the CPU:
AdamW, clipping, the schedule, gradient compression, checkpoints (and
checkpoints crossing the packages), and the gradient of ``embed_bag``.

The same numpy inputs from a seed go through ``repro.train`` (jitted, as
its train step runs it) and ``repro_torch.train``. Tolerances, in f32 ulps
of a leaf's largest magnitude (2^-24 of it):

* the global norm: 64 ulps. Within a leaf the two backends reduce in
  different orders;
* unclipped AdamW steps: ``m`` and ``v`` equal (XLA's CPU backend fuses
  ``b1 * m + x`` into one multiply-add, and so does the port's
  ``add_(alpha=)``), the parameters within 1 ulp (``pow`` and ``cos`` of
  two libraries in the bias corrections and the learning rate);
* clipped steps add the norm's difference through the clip scale: ``m`` to
  64 ulps, ``v`` (squared) to 128, the parameters to 8;
* the learning rate: 8 ulps of itself (``cos`` and ``pow`` of two
  libraries; XLA's jitted schedule differs from its own eager one by ~5
  ulps at some steps);
* compression on the same grads: top-k grads and buffers equal; int8
  grads within 2 ulps of the accumulated gradient's largest magnitude (XLA
  turns ``/ 127.0`` into a multiply by its reciprocal, and fuses the
  buffer's ``g - q * scale`` into one multiply-add), a bf16 leaf within
  one bf16 rounding; the buffers, which carry the difference from step to
  step, within 8 ulps over three steps.
"""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from functools import partial

from repro.train import (AdamWConfig as RAdamWConfig, CheckpointManager as
                         RCheckpointManager, CompressorConfig as
                         RCompressorConfig, adamw_init as r_adamw_init,
                         adamw_update as r_adamw_update,
                         clip_by_global_norm as r_clip,
                         compress_init as r_compress_init,
                         compressed_grads as r_compressed_grads)
from repro.models.recsys import embed_bag_jnp
from repro.train.optimizer import schedule as r_schedule

from repro_torch._tree import tree_leaves, tree_map
from repro_torch.core.common import host_array
from repro_torch.kernels.embed_bag import (EmbedBagFunction, embed_bag,
                                           embed_bag_backward_ref,
                                           embed_bag_ref)
from repro_torch.models.convert import (adamw_state_from_reference,
                                        adamw_state_to_reference,
                                        tensor_from_numpy)
from repro_torch.train import (AdamWConfig, CheckpointManager,
                               CompressorConfig, adamw_init, adamw_update,
                               clip_by_global_norm, compress_init,
                               compressed_grads)
from repro_torch.train.optimizer import schedule

ULP = 2.0 ** -24


def _t(tree):
    """A numpy tree as the port's tensors on the CPU (bf16 bits kept)."""
    return tree_map(lambda a: tensor_from_numpy(a, "cpu"), tree)


def _np_leaves(tree):
    return [np.asarray(a, np.float32) for a in jax.tree.leaves(tree)]


def _port_leaves(tree):
    """The port's leaves in the reference's order (JAX sorts dict keys)."""
    pairs = sorted(tree_leaves(tree), key=lambda pl: [str(k) for k in pl[0]])
    return [t.float().numpy() for _, t in pairs]


def _close_in_ulps(port, ref, ulps, what):
    for i, (p, r) in enumerate(zip(port, ref)):
        scale = max(float(np.abs(r).max()), 1e-30)
        err = float(np.abs(p - r).max()) / scale / ULP
        assert err <= ulps, f"{what} leaf {i}: {err:.1f} ulps > {ulps}"


def _tree(rng, scale):
    """A tree of mixed leaves: a bf16 matrix, f32 vectors, a list."""
    a = (rng.normal(size=(64, 32)) * scale).astype(np.float32)
    return {"a": a.astype(ml_dtypes.bfloat16),
            "b": (rng.normal(size=7) * scale).astype(np.float32),
            "c": [(rng.normal(size=(3, 5)) * scale).astype(np.float32),
                  (rng.normal(size=40) * scale).astype(np.float32)]}


# ---------------------------------------------------------------------------
# the reference's own substrate tests, on the port
# ---------------------------------------------------------------------------

def test_adamw_converges_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=200,
                      weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params)
    for _ in range(200):
        grads = {"w": 2 * params["w"]}
        params, state, m = adamw_update(cfg, grads, state, params)
    assert float(params["w"].abs().max()) < 0.2
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 200


def test_grad_clip():
    g = {"a": torch.ones(100) * 10.0}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert abs(float(norm) - 100.0) < 1e-3
    assert abs(float(torch.sqrt(torch.sum(clipped["a"] ** 2))) - 1.0) < 1e-3
    small, n2 = clip_by_global_norm({"a": torch.full((4,), 0.1)}, 1.0)
    assert torch.equal(small["a"], torch.full((4,), 0.1))


def test_schedule_warmup_then_decay_matches_reference():
    cfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    rcfg = RAdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in range(120)]
    assert lrs[0] < lrs[9] <= 1e-3 + 1e-9
    assert lrs[99] < lrs[50] < lrs[11]
    ref = np.asarray([r_schedule(rcfg, jnp.int32(s)) for s in range(120)],
                     np.float32)
    np.testing.assert_allclose(np.float32(lrs), ref, rtol=2 * 2.0 ** -23,
                               atol=0)
    assert schedule(cfg, torch.tensor(3)).dtype == torch.float32


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    state = {"p": {"w": torch.arange(6.0).reshape(2, 3),
                   "h": torch.linspace(-1, 1, 5).to(torch.bfloat16)},
             "step": torch.tensor(7, dtype=torch.int32)}
    for s in (10, 20, 30):
        mgr.save(s, state, extra={"stream_step": s * 2})
    assert mgr.all_steps() == [20, 30]          # keep=2 rotated
    like = tree_map(torch.zeros_like, state)
    restored, meta = mgr.restore(like)
    for (_, a), (_, b) in zip(tree_leaves(restored), tree_leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert meta["step"] == 30 and meta["stream_step"] == 60
    with np.load(tmp_path / "ckpt_0000000030" / "state.npz") as npz:
        assert sorted(npz.files) == ["['p']['h']", "['p']['w']", "['step']"]
        assert npz["['p']['h']"].dtype == np.float32   # bf16 written as f32


def test_checkpoint_async_and_atomic(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_write=True)
    state = {"w": torch.ones(4)}
    mgr.save(1, state)
    state["w"].add_(1)                 # the saved copy was taken in save()
    mgr.wait()
    assert mgr.latest_step() == 1
    assert not any(f.startswith("tmp.") for f in os.listdir(tmp_path))
    restored, _ = mgr.restore({"w": torch.zeros(4)})
    assert torch.equal(restored["w"], torch.ones(4))
    assert mgr._pending is None


def test_resume_from_latest_after_crash(tmp_path):
    """A crashed half-write leaves a tmp dir or an incomplete ckpt dir:
    both are invisible to resume, and the next write reclaims them."""
    mgr = CheckpointManager(str(tmp_path), keep=3, async_write=False)
    mgr.save(5, {"w": torch.zeros(2)}, extra={"stream_step": 5})
    os.makedirs(tmp_path / "tmp.99", exist_ok=True)
    os.makedirs(tmp_path / "ckpt_0000000077", exist_ok=True)
    mgr2 = CheckpointManager(str(tmp_path), keep=3)
    assert mgr2.latest_step() == 5 and mgr2.all_steps() == [5]
    mgr2.save(6, {"w": torch.ones(2)})
    mgr2.wait()
    assert sorted(os.listdir(tmp_path)) == ["ckpt_0000000005",
                                            "ckpt_0000000006"]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({})


@pytest.mark.parametrize("scheme", ["topk", "int8"])
def test_compression_error_feedback(scheme):
    cfg = CompressorConfig(scheme=scheme, topk_frac=0.1)
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(
        size=256).astype(np.float32))}
    ef = compress_init(g)
    cg, ef2 = compressed_grads(cfg, g, ef)
    np.testing.assert_allclose(cg["w"].numpy() + ef2["w"].numpy(),
                               g["w"].numpy(), rtol=1e-5, atol=1e-6)
    if scheme == "topk":
        assert int((cg["w"] != 0).sum()) <= 26 + 1


def test_compression_none_passthrough():
    g = {"w": torch.ones(4)}
    ef = compress_init(g)
    cg, ef2 = compressed_grads(CompressorConfig(scheme="none"), g, ef)
    assert cg is g and ef2 is ef
    with pytest.raises(ValueError):
        compressed_grads(CompressorConfig(scheme="fp4"), g, ef)


# ---------------------------------------------------------------------------
# the same grads through both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clipped", [False, True], ids=["unclipped", "clipped"])
def test_adamw_steps_match_reference(clipped):
    """12 steps over a mixed bf16/f32 tree, the warm-up, its end and the
    cosine included; every step's params, m, v, lr and grad norm."""
    rng = np.random.default_rng(3)
    params = _tree(rng, 0.5)
    kw = dict(lr=1e-2, warmup_steps=4, total_steps=10)
    cfg, rcfg = AdamWConfig(**kw), RAdamWConfig(**kw)
    rp = jax.tree.map(jnp.asarray, params)
    rs = r_adamw_init(rp)
    tp = _t(params)
    ts = adamw_init(tp)
    assert ts["step"].dtype == torch.int32
    upd = jax.jit(partial(r_adamw_update, rcfg))
    tol = (8, 64, 128) if clipped else (1, 0, 0)
    for s in range(12):
        g = _tree(rng, 3.0 if clipped else 0.01)
        rp, rs, rm = upd(jax.tree.map(jnp.asarray, g), rs, rp)
        tp, ts, tm = adamw_update(cfg, _t(g), ts, tp)
        assert float(rm["grad_norm"] > 1.0) == float(clipped)
        assert tp["a"].dtype == torch.bfloat16 and ts["m"]["a"].dtype == \
            torch.float32
        _close_in_ulps(_port_leaves(tp), _np_leaves(rp), tol[0], "params")
        _close_in_ulps(_port_leaves(ts["m"]), _np_leaves(rs["m"]), tol[1], "m")
        _close_in_ulps(_port_leaves(ts["v"]), _np_leaves(rs["v"]), tol[2], "v")
        _close_in_ulps([tm["grad_norm"].numpy()], [np.asarray(rm["grad_norm"])],
                       64, "grad norm")
        _close_in_ulps([tm["lr"].numpy()], [np.asarray(rm["lr"])], 8, "lr")
        assert int(ts["step"]) == int(rs["step"]) == s + 1
    # the state carries across both ways, bit for bit
    back = adamw_state_to_reference(ts)
    again = adamw_state_from_reference(back, "cpu")
    for (_, a), (_, b) in zip(tree_leaves(again), tree_leaves(ts)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(4)
    g = _tree(rng, 2.0)
    rc, rn = jax.jit(partial(r_clip, max_norm=1.0))(
        jax.tree.map(jnp.asarray, g))
    tc, tn = clip_by_global_norm(_t(g), 1.0)
    # a bf16 leaf times the f32 scale is f32, as under JAX's promotion
    assert tc["a"].dtype == torch.float32
    assert np.asarray(rc["a"]).dtype == np.float32
    _close_in_ulps([tn.numpy()], [np.asarray(rn)], 64, "norm")
    _close_in_ulps(_port_leaves(tc), _np_leaves(rc), 64, "clipped")


@pytest.mark.parametrize("scheme", ["topk", "int8"])
def test_compressed_grads_match_reference(scheme):
    """Three steps of error feedback on the same grads: compressed grads
    and buffers equal the reference's; a tie at the top-k threshold keeps
    every tied entry."""
    rng = np.random.default_rng(5)
    rcfg = RCompressorConfig(scheme=scheme, topk_frac=0.1)
    cfg = CompressorConfig(scheme=scheme, topk_frac=0.1)
    g0 = _tree(rng, 1.0)
    ref_ef = r_compress_init(jax.tree.map(jnp.asarray, g0))
    ef = compress_init(_t(g0))
    comp = jax.jit(partial(r_compressed_grads, rcfg))
    for s in range(3):
        g = _tree(rng, 1.0)
        g["c"][1][:8] = 5.0                    # 8 ties at the threshold
        rg, ref_ef = comp(jax.tree.map(jnp.asarray, g), ref_ef)
        tg, ef = compressed_grads(cfg, _t(g), ef)
        assert tg["a"].dtype == torch.bfloat16
        if scheme == "topk":
            for p, r in zip(_port_leaves(tg) + _port_leaves(ef),
                            _np_leaves(rg) + _np_leaves(ref_ef)):
                np.testing.assert_array_equal(p, r)
            continue
        # ulps of the accumulated gradient, whose largest magnitude the
        # dequantised leaf keeps (q = +-127 there); the bf16 leaf to one
        # bf16 rounding
        _close_in_ulps(_port_leaves(tg)[1:], _np_leaves(rg)[1:], 2, "int8")
        np.testing.assert_allclose(_port_leaves(tg)[0], _np_leaves(rg)[0],
                                   rtol=2.0 ** -8, atol=0)
        for p, r, d in zip(_port_leaves(ef), _np_leaves(ref_ef),
                           _np_leaves(rg)):
            assert np.abs(p - r).max() <= 8 * ULP * np.abs(d).max()
    if scheme == "topk":
        assert int((tg["c"][1] == 5.0).sum()) >= 8


# ---------------------------------------------------------------------------
# checkpoints cross the packages
# ---------------------------------------------------------------------------

def _state_pair(rng):
    params = _tree(rng, 1.0)
    ref = {"params": jax.tree.map(jnp.asarray, params),
           "opt": r_adamw_init(jax.tree.map(jnp.asarray, params)),
           "ef": r_compress_init(jax.tree.map(jnp.asarray, params))}
    g = jax.tree.map(jnp.asarray, _tree(rng, 1.0))
    p2, o2, _ = jax.jit(partial(r_adamw_update, RAdamWConfig()))(
        g, ref["opt"], ref["params"])
    ref.update(params=p2, opt=o2)
    tp = _t(params)
    port_like = {"params": tree_map(torch.zeros_like, tp),
                 "opt": adamw_init(tp), "ef": compress_init(tp)}
    return ref, port_like


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    ref, port_like = _state_pair(np.random.default_rng(6))
    RCheckpointManager(str(tmp_path), async_write=False).save(
        4, ref, extra={"stream_step": 4})
    state, meta = CheckpointManager(str(tmp_path)).restore(port_like)
    assert meta == {"step": 4, "stream_step": 4}
    assert state["params"]["a"].dtype == torch.bfloat16
    assert state["opt"]["step"].dtype == torch.int32
    ref_leaves = jax.tree.leaves(ref)
    port = sorted(tree_leaves(state), key=lambda pl: [str(k) for k in pl[0]])
    assert len(port) == len(ref_leaves)
    for (_, t), r in zip(port, ref_leaves):
        r = np.asarray(r)
        assert str(r.dtype) == str(t.dtype).replace("torch.", "")
        np.testing.assert_array_equal(host_array(t).view(r.dtype)
                                      if t.dtype == torch.bfloat16
                                      else t.numpy(), r)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    rng = np.random.default_rng(7)
    ref, port_like = _state_pair(rng)
    # the port's state: the reference's values carried across
    port = {"params": _t(jax.tree.map(np.asarray, ref["params"])),
            "opt": adamw_state_from_reference(
                jax.tree.map(np.asarray, ref["opt"]), "cpu"),
            "ef": _t(jax.tree.map(np.asarray, ref["ef"]))}
    writer = CheckpointManager(str(tmp_path), async_write=True)
    writer.save(9, port)
    writer.wait()
    mgr = RCheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 9
    like = jax.tree.map(jnp.zeros_like, ref)
    restored, meta = mgr.restore(like)
    assert meta["step"] == 9
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(ref)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the gradient of embed_bag
# ---------------------------------------------------------------------------

def _bag_inputs(v, d, b, l, seed):
    rng = np.random.default_rng(seed)
    tab = rng.normal(size=(v, d)).astype(np.float32)
    idx = rng.integers(-1, v + 3, size=(b, l)).astype(np.int32)
    idx[0] = -1                                  # an all-padding bag
    idx[1, :] = 2                                # one id l times
    idx[2, : l // 2] = v + 1                     # ids past V
    gout = rng.normal(size=(b, d)).astype(np.float32)
    return tab, idx, gout


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("v,d,b,l", [(50, 8, 9, 6), (300, 16, 40, 33),
                                     (7, 4, 12, 20)])
def test_embed_bag_backward_matches_autograd_f32(mode, v, d, b, l):
    """f32: equal to autograd through ``embed_bag_ref`` up to the order of
    the f32 sums (1e-6)."""
    tab, idx, gout = _bag_inputs(v, d, b, l, v + b)
    t = torch.from_numpy(tab).requires_grad_()
    ix, g = torch.from_numpy(idx), torch.from_numpy(gout)
    (embed_bag_ref(t, ix, mode) * g).sum().backward()
    grad = embed_bag_backward_ref(g, ix, v, torch.float32, mode)
    assert grad.dtype == torch.float32 and grad.shape == (v, d)
    np.testing.assert_allclose(grad.numpy(), t.grad.numpy(), rtol=1e-6,
                               atol=1e-6)
    # a loop over every (bag, id): duplicates accumulate, pads and ids
    # past V add nothing, "mean" divides by the count of ids >= 0
    want = np.zeros((v, d), np.float64)
    for bi in range(b):
        cnt = max(int((idx[bi] >= 0).sum()), 1) if mode == "mean" else 1
        for i in idx[bi]:
            if 0 <= i < v:
                want[i] += gout[bi] / cnt
    np.testing.assert_allclose(grad.numpy(), want, rtol=1e-5, atol=1e-5)
    untouched = np.setdiff1d(np.arange(v), idx[(idx >= 0) & (idx < v)])
    assert (grad[untouched] == 0).all()


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embed_bag_backward_bf16(mode):
    """bf16 table: the f32 sums cast once, so equal to the f32 gradient
    rounded to bf16 (within one bf16 rounding, 2^-8 relative); autograd
    through ``embed_bag_ref`` on the bf16 table accumulates in bf16, so it
    is held to the bound of n bf16 additions, n = the most times one row
    is gathered: n * 2^-8 * the sum of the magnitudes added."""
    v, d, b, l = 60, 8, 30, 24
    tab, idx, gout = _bag_inputs(v, d, b, l, 11)
    ix, g = torch.from_numpy(idx), torch.from_numpy(gout)
    t16 = torch.from_numpy(tab).to(torch.bfloat16).requires_grad_()
    grad = embed_bag_backward_ref(g, ix, v, torch.bfloat16, mode)
    assert grad.dtype == torch.bfloat16
    f32 = embed_bag_backward_ref(g, ix, v, torch.float32, mode)
    np.testing.assert_allclose(grad.float().numpy(), f32.numpy(),
                               rtol=2.0 ** -8, atol=0)
    (embed_bag_ref(t16, ix, mode) * g).sum().backward()
    mag = embed_bag_backward_ref(g.abs(), ix, v, torch.float32, mode)
    n = np.bincount(idx[(idx >= 0) & (idx < v)], minlength=v).max()
    bound = n * 2.0 ** -8 * mag.numpy() + 1e-30
    assert (np.abs(t16.grad.float().numpy() - grad.float().numpy())
            <= bound).all()


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("v,d,b,l", [(50, 8, 9, 6), (300, 16, 40, 33),
                                     (7, 4, 12, 20)])
def test_embed_bag_backward_matches_the_reference_vjp(mode, v, d, b, l):
    """The table's gradient the card's ``EmbedBagFunction`` returns
    (``embed_bag_backward_ref``) against ``jax.vjp`` of the reference's
    ``embed_bag_jnp``, which is wide-deep's bag gradient there, on the same
    f32 table, ids and cotangent: 1e-6 of the gradient's largest magnitude
    (the two scatter-adds sum duplicates in different orders). The ids
    include duplicates, ``-1`` pads and ids at or past V: the reference's
    jnp gather clamps those to row V - 1 in its forward, but the transpose
    of that gather drops them, as the port's backward and its kernel's
    one-hot do, so no row differs."""
    tab, idx, gout = _bag_inputs(v, d, b, l, 2 * v + b)
    assert (idx >= v).any() and (idx == -1).any()
    _, vjp = jax.vjp(lambda t: embed_bag_jnp(t, jnp.asarray(idx), mode),
                     jnp.asarray(tab))
    (want,) = vjp(jnp.asarray(gout))
    want = np.asarray(want)
    grad = embed_bag_backward_ref(torch.from_numpy(gout),
                                  torch.from_numpy(idx), v, torch.float32,
                                  mode).numpy()
    np.testing.assert_allclose(grad, want, rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))


def test_embed_bag_function_runs_its_backward_under_each_grad_mode(
        monkeypatch):
    """Every CUDA table goes through ``EmbedBagFunction``. With the kernel
    stood in for by the plain forward (the Function takes CUDA tensors
    only), its backward is ``embed_bag_backward_ref`` and equals
    ``jax.vjp`` of the reference's bag; under ``no_grad`` and
    ``inference_mode``, or on a table without grad, it records nothing."""
    from repro_torch.kernels.embed_bag import ops
    monkeypatch.setattr(ops, "embed_bag_cuda", embed_bag_ref)
    v, d, b, l = 60, 8, 16, 10
    tab, idx, gout = _bag_inputs(v, d, b, l, 5)
    ix, g = torch.from_numpy(idx), torch.from_numpy(gout)
    t = torch.from_numpy(tab).requires_grad_()
    out = EmbedBagFunction.apply(t, ix, "sum")
    assert type(out.grad_fn).__name__ == "EmbedBagFunctionBackward"
    out.backward(g)
    _, vjp = jax.vjp(lambda x: embed_bag_jnp(x, jnp.asarray(idx)),
                     jnp.asarray(tab))
    want = np.asarray(vjp(jnp.asarray(gout))[0])
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            o = EmbedBagFunction.apply(t, ix, "sum")
        assert o.grad_fn is None and not o.requires_grad
        np.testing.assert_array_equal(o.numpy(), out.detach().numpy())
    o = EmbedBagFunction.apply(t.detach(), ix, "sum")
    assert o.grad_fn is None


def test_embed_bag_on_cpu_is_differentiable_through_the_plain_version():
    """A CPU table takes ``embed_bag_ref`` (no kernel launch, no count)
    and autograd differentiates it; the result is the backward's."""
    tab, idx, gout = _bag_inputs(40, 8, 10, 12, 3)
    t = torch.from_numpy(tab).requires_grad_()
    before = embed_bag.launches
    out = embed_bag(t, torch.from_numpy(idx), "mean")
    assert embed_bag.launches == before and out.requires_grad
    (out * torch.from_numpy(gout)).sum().backward()
    np.testing.assert_allclose(
        t.grad.numpy(), embed_bag_backward_ref(
            torch.from_numpy(gout), torch.from_numpy(idx), 40, torch.float32,
            "mean").numpy(), rtol=1e-6, atol=1e-6)


def test_donated_update_is_the_same_update_in_place():
    """``adamw_update`` (and so ``make_train_step``) donates its inputs: it
    writes the new parameters and moments into the old tensors. One chunk a
    leaf, several chunks a leaf, and a non-contiguous leaf (updated whole)
    give the same bits, bf16 leaves included."""
    from repro_torch.train import optimizer
    gen = torch.Generator().manual_seed(0)

    def tree():
        return {"a": torch.randn(5, 7, generator=gen).bfloat16(),
                "b": [torch.randn(3, generator=gen),
                      torch.randn(2, 300, generator=gen)]}
    params, grads = tree(), tree()
    cfg = AdamWConfig(warmup_steps=1)
    runs = []
    for chunk, strided in ((optimizer.UPDATE_CHUNK, False), (64, False),
                           (64, True)):
        p = tree_map(torch.clone, params)
        if strided:                  # the same values, column-major
            p["b"][1] = p["b"][1].t().contiguous().t()
            assert not p["b"][1].is_contiguous()
        s = adamw_init(p)
        ids = [id(t) for _, t in tree_leaves(p)] + \
            [id(t) for _, t in tree_leaves({"m": s["m"], "v": s["v"]})]
        old = optimizer.UPDATE_CHUNK
        optimizer.UPDATE_CHUNK = chunk
        try:
            for _ in range(2):       # the second step has nonzero moments
                keep = [t.clone() for _, t in tree_leaves(p)]
                p, s, m = adamw_update(cfg, grads, s, p)
                assert [id(t) for _, t in tree_leaves(p)] + [
                    id(t) for _, t in tree_leaves(
                        {"m": s["m"], "v": s["v"]})] == ids
                assert not all(torch.equal(a, b) for a, (_, b) in
                               zip(keep, tree_leaves(p)))
        finally:
            optimizer.UPDATE_CHUNK = old
        runs.append((p, s, m))
    (p1, s1, m1), rest = runs[0], runs[1:]
    for p2, s2, m2 in rest:
        for a, b in zip(tree_leaves({"p": p1, "m": s1["m"], "v": s1["v"]}),
                        tree_leaves({"p": p2, "m": s2["m"], "v": s2["v"]})):
            assert torch.equal(a[1], b[1]), a[0]
        assert torch.equal(s1["step"], s2["step"])
        assert torch.equal(m1["grad_norm"], m2["grad_norm"])


def _aligned_f32(n, align=64):
    """``n`` f32 values whose data lies at a multiple of ``align`` bytes
    (a slice of an over-allocated buffer): JAX on the CPU aliases such an
    array rather than copying it."""
    buf = np.empty(n + align // 4, np.float32)
    off = (-buf.ctypes.data % align) // 4
    a = buf[off:off + n]
    assert a.ctypes.data % align == 0
    a[:] = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    return a


def test_inplace_update_leaves_the_callers_arrays_alone():
    """A step of the port's in-place AdamW on tensors made from numpy
    arrays changes neither the arrays nor a JAX array over the same
    buffer: the port updates memory of its own, whatever the reference
    does with its copy of the array at the same time."""
    a = _aligned_f32(40)
    before = a.copy()
    ja = jnp.asarray(a)                  # may share ``a``'s buffer
    params = _t({"w": a})
    state = adamw_state_from_reference(
        {"m": {"w": np.zeros(40, np.float32)},
         "v": {"w": np.zeros(40, np.float32)},
         "step": np.zeros((), np.int32)}, "cpu")
    grads = {"w": torch.ones(40)}
    params, state, _ = adamw_update(AdamWConfig(warmup_steps=1), grads,
                                    state, params)
    assert not torch.equal(params["w"], torch.from_numpy(before))
    np.testing.assert_array_equal(a, before)
    np.testing.assert_array_equal(np.asarray(ja), before)
    from repro_torch.core.common import tensor_from_host
    t = tensor_from_host(a)
    assert t.untyped_storage().data_ptr() != a.ctypes.data
