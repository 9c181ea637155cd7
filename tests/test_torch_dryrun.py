"""The port's dry run (``repro_torch.launch.dryrun``, ``models.api``'s step
cells, the kernels' custom ops) against the JAX reference's, on the CPU.

* ``param_shapes`` / ``opt_shapes``: equal to the reference's
  ``jax.eval_shape`` trees (paths, shapes, dtypes) for all 10 archs.
* ``make_step``: every one of the 40 cells equal to the reference's
  ``make_step(shape, {"data": 1, "model": 1})`` in name, ``with_opt``,
  ``donate`` and every argument leaf.
* FLOPs at small configs: the port's counted products equal the
  reference's ``dot_general`` FLOPs, ``2 x batch x M x N x K``, counted by
  walking ``jax.make_jaxpr(bundle.fn)`` (abstract tracing, no compile):
  ``scan`` bodies times their length, every sub-jaxpr (``pjit``,
  ``remat``/``checkpoint``, ``custom_jvp``/``custom_vjp``) recursed into.

  Remat in the reference's jaxpr: ``value_and_grad`` of a layer under
  ``jax.checkpoint(nothing_saveable)`` holds the layer's products once in
  the forward scan, and once more inside the ``checkpoint`` equation of
  the backward scan, which recomputes them before their transposes,
  except the products whose outputs no gradient needs (dead code: an LM
  layer's ``w_down``). PyTorch's non-reentrant checkpoint recomputes the
  layer in the backward and stops once every saved tensor is back, which
  leaves out the same products: the LM and recsys counts are equal with
  no credit.

  Named differences, NequIP only. Both packages contract
  ``_interaction``'s ``einsum("emi,ej,ijk->emk")`` pairwise along
  opt_einsum's path: ``Y . C`` first, then ``h . (YC)``; or, on paths
  with ``l_f = 0`` and a wide ``l_in``, ``h x Y`` first, then
  ``(hY) . C``. ``_nequip_train_products`` counts a train step's products
  path by path with three switches, one per difference, and reproduces
  both counts exactly (at several depths and ``l_max``); each credit is
  the change of one switch:
  (1) ``k1_dots``: a pairwise step whose contracted axes have size 1 (the
      ``Y . C`` of ``l_f = 0``, the ``h . (YC)`` of ``l_in = 0``, the outer
      product ``h x Y``) is a ``dot_general`` in JAX and an elementwise
      product in ``torch.einsum``, and so are its transposes. In the
      forward alone this is the only difference: the reference's K = 1
      dots, read off its jaxpr.
  (2) ``full_vjp``: the reference's layers are one ``lax.scan``, whose
      backward runs every layer's whole VJP; autograd computes only the
      gradients that reach a parameter. So the reference alone computes,
      in the last layer, the gradients into the ``l > 0`` outputs (which
      the energy never reads: their paths' radial MLPs and CG transposes,
      the ``l > 0`` ``lin_out`` and ``self`` maps), and in the first layer
      the gradients into the ``l > 0`` inputs, which are constant zeros;
      the layers between compute every gradient in both.
  (3) ``hoisted``: JAX's partial evaluation of the forward scan hoists the
      loop-invariant ``Y . C`` (it depends only on the edge directions and
      the CG tensors) out of the layer loop, so the reference computes it
      once in the forward and once a layer in its rematerialised backward,
      ``L + 1`` times; the port computes it in each layer's forward and
      recompute, ``2 L`` times. This credit is negative: the port does
      more.
* The count is affine in depth: an LM at L, L+1, L+2 layers (FLOPs and
  bytes) and DIEN at three ``seq_len`` (FLOPs) give equal differences
  (what the reference's ``_extrapolate`` assumes).
* The custom ops' fakes give their plain versions' shapes and dtypes, a
  fake trace of wide-deep's train step holds one ``embed_bag`` a forward,
  and no trace reaches a launcher.
* The memory tracker on a hand-counted chain, and on one in-place AdamW
  step (``aliased`` = parameters + moments).
* One published-shape cell per family traced whole.
"""
import dataclasses
import math

import jax
import jax.extend.core as jex
import numpy as np
import opt_einsum
import pytest
import torch
from jax.sharding import Mesh

from repro.configs import (ARCHS as R_ARCHS, get_config as r_get_config,
                           get_smoke_config as r_smoke, shapes_for
                           as r_shapes_for)
from repro.configs.base import ShapeSpec as RShapeSpec
from repro.models.api import get_api as r_get_api

from repro_torch._tree import tree_leaves
from repro_torch.configs import ARCHS, get_config, get_smoke_config, shapes_for
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels import _build
from repro_torch.kernels._build import tracing
from repro_torch.kernels.embed_bag import embed_bag, embed_bag_ref
from repro_torch.kernels.l2dist import l2dist, l2dist_ref
from repro_torch.kernels.topk_dist import topk_dist, topk_dist_ref
from repro_torch.launch import dryrun
from repro_torch.models.api import get_api
from repro_torch.models.e3 import paths


# ---------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------

def _ref_key(path) -> tuple:
    out = []
    for k in path:
        if hasattr(k, "key"):
            out.append(str(k.key))
        elif hasattr(k, "idx"):
            out.append(k.idx)
        else:
            raise TypeError(k)
    return tuple(out)


def _ref_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_ref_key(p): (tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in flat}


def _port_leaves(tree) -> dict:
    return {tuple(str(k) if isinstance(k, str) else k for k in p):
            (tuple(s.shape), str(s.dtype).removeprefix("torch."))
            for p, s in tree_leaves(tree)}


def _ref_bundle(cfg, shape):
    api = r_get_api(cfg)
    bundle = api.make_step(shape, {"data": 1, "model": 1})
    return bundle.api or api, bundle


def _dots(jaxpr, mult=1, acc=None):
    """``{"dot": FLOPs, "k1": FLOPs of the K = 1 products}`` of every
    ``dot_general`` in ``jaxpr`` and its sub-jaxprs."""
    acc = {"dot": 0, "k1": 0} if acc is None else acc
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval.shape
            K = math.prod(lhs[i] for i in lc)
            n = 2 * math.prod(eqn.outvars[0].aval.shape) * K * mult
            acc["dot"] += n
            if K == 1:
                acc["k1"] += n
        m = mult * (eqn.params["length"] if eqn.primitive.name == "scan"
                    else 1)
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(sub, jex.ClosedJaxpr):
                    _dots(sub.jaxpr, m, acc)
                elif isinstance(sub, jex.Jaxpr):
                    _dots(sub, m, acc)
    return acc


def _ref_flops(cfg, shape, fn=None):
    api, bundle = _ref_bundle(cfg, shape)
    args = [api.param_shapes()] + ([api.opt_shapes()] if bundle.with_opt
                                   else []) + list(bundle.args)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    with mesh:
        jp = jax.make_jaxpr(fn or bundle.fn)(*args)
    return _dots(jp.jaxpr)


def _port_trace(cfg, shape):
    api, bundle = dryrun._bundle(cfg, shape)
    return dryrun.trace_step(bundle.fn, dryrun.call_shapes(api, bundle))


def _products(rec) -> int:
    fam = rec["cost"]["flops_by_family"]
    return sum(v for k, v in fam.items() if k in ("matmul", "attention"))


# ---------------------------------------------------------------------------
# shapes and cells
# ---------------------------------------------------------------------------

def test_arch_registries_agree():
    assert tuple(ARCHS) == tuple(R_ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_shapes_match_reference(arch):
    r_api, api = r_get_api(r_get_config(arch)), get_api(get_config(arch))
    assert _port_leaves(api.param_shapes()) == _ref_leaves(
        r_api.param_shapes())
    assert _port_leaves(api.opt_shapes()) == _ref_leaves(r_api.opt_shapes())


CELLS = [(a, s) for a in ARCHS for s in shapes_for(get_config(a))]


def test_forty_cells():
    assert len(CELLS) == 40
    assert CELLS == dryrun.cells()


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_step_bundle_matches_reference(arch, shape):
    r_cfg = r_get_config(arch)
    r_api, rb = _ref_bundle(r_cfg, r_shapes_for(r_cfg)[shape])
    cfg = get_config(arch)
    api, b = dryrun._bundle(cfg, shapes_for(cfg)[shape])
    assert (b.name, b.with_opt, b.donate) == (rb.name, rb.with_opt,
                                              rb.donate)
    assert _port_leaves(list(b.args)) == _ref_leaves(list(rb.args))
    assert _port_leaves(api.param_shapes()) == _ref_leaves(
        r_api.param_shapes())
    names = [f.name for f in dataclasses.fields(cfg)]
    assert [getattr(api.config, n) for n in names] == [
        getattr(r_api.config, n) for n in names]
    if b.with_opt:
        assert _port_leaves(api.opt_shapes()) == _ref_leaves(
            r_api.opt_shapes())


def test_gnn_cells_keep_n_graphs_a_python_int():
    cfg = get_config("nequip")
    for name in ("molecule", "full_graph_sm"):
        api, b = dryrun._bundle(cfg, shapes_for(cfg)[name])
        assert "n_graphs" not in b.args[0]
    # the full-graph cell adds the node-feature frontend to its config
    api, _ = dryrun._bundle(cfg, shapes_for(cfg)["full_graph_sm"])
    assert api.config.d_feat == 1433 and "feat_proj" in api.param_shapes()


# ---------------------------------------------------------------------------
# FLOPs against the reference's dot_generals
# ---------------------------------------------------------------------------

_LM_SMALL = {
    "stablelm_1_6b": dict(num_layers=2, d_model=64, num_heads=4,
                          num_kv_heads=2, d_ff=128, vocab_size=500),
    "granite_moe_3b_a800m": dict(num_layers=2, d_model=64, num_heads=4,
                                 num_kv_heads=2, d_ff=32, vocab_size=500,
                                 num_experts=8, top_k=2),
    "deepseek_moe_16b": dict(num_layers=3, first_dense_layers=1,
                             dense_ff=96, d_model=64, num_heads=4,
                             num_kv_heads=4, d_ff=32, vocab_size=500,
                             num_experts=8, top_k=2, num_shared_experts=2),
}
_LM_CASES = [(a, k) for a in _LM_SMALL for k in ("train", "prefill",
                                                 "decode")]


@pytest.mark.parametrize("arch,kind", _LM_CASES,
                         ids=[f"{a}-{k}" for a, k in _LM_CASES])
def test_lm_flops_match_reference_dots(arch, kind):
    kw = _LM_SMALL[arch]
    sk = dict(name="small", kind=kind, seq_len=32, global_batch=2)
    ref = _ref_flops(dataclasses.replace(r_get_config(arch), **kw),
                     RShapeSpec(**sk))
    rec = _port_trace(dataclasses.replace(get_config(arch), **kw),
                      ShapeSpec(**sk))
    assert _products(rec) == ref["dot"]
    assert rec["cost"]["flops_by_family"]["attention"] > 0


_RECSYS_CASES = [(a, k) for a in ("wide_deep", "autoint", "dien", "sasrec")
                 for k in ("train", "serve", "retrieval")]


@pytest.mark.parametrize("arch,kind", _RECSYS_CASES,
                         ids=[f"{a}-{k}" for a, k in _RECSYS_CASES])
def test_recsys_flops_match_reference_dots(arch, kind):
    sk = dict(name="small", kind=kind, batch=1 if kind == "retrieval" else 8,
              n_candidates=500 if kind == "retrieval" else 0)
    ref = _ref_flops(r_smoke(arch), RShapeSpec(**sk))
    rec = _port_trace(get_smoke_config(arch), ShapeSpec(**sk))
    assert _products(rec) == ref["dot"]
    fam = rec["cost"]["flops_by_family"]
    if arch == "wide_deep":      # the bag: the reference's gather-and-sum
        cfg = get_smoke_config(arch)
        assert fam["embed_bag"] == sk["batch"] * cfg.bag_len * cfg.embed_dim
    assert ("attention" in fam) == (arch in ("autoint", "sasrec"))


_MOLECULE = dict(name="molecule", kind="graph", n_nodes=10, n_edges=20,
                 graph_batch=4)


def _yc_first(i: int, j: int, k: int, E: int, M: int) -> bool:
    """Whether opt_einsum (both packages' einsum) contracts ``Y . C``
    first on a path with these dimensions, rather than ``h x Y``."""
    path, _ = opt_einsum.contract_path(
        "emi,ej,ijk->emk", np.empty((E, M, i)), np.empty((E, j)),
        np.empty((i, j, k)), optimize="auto")
    return path[0] == (1, 2)


def _nequip_train_products(cfg, E: int, N: int, *, k1_dots: bool,
                           full_vjp: bool, hoisted: bool) -> int:
    """The products of one NequIP train step on ``E`` edges and ``N``
    nodes, ``2 x batch x M x N x K`` each: every layer's forward and its
    recompute (remat), and the backward's transposes. The reference is
    ``(True, True, True)``, the port ``(False, False, False)``; each switch
    is one named difference of the module docstring. ``full_vjp=False`` is
    autograd's rule: a layer computes a gradient only where a parameter's
    gradient needs it (the last layer's energy reads its ``l = 0`` output;
    the first layer's ``l > 0`` inputs are zeros that need none)."""
    M, R, L, H = cfg.d_hidden, cfg.n_rbf, cfg.n_layers, 16
    ls = range(cfg.l_max + 1)
    mout = {l: M * (1 + cfg.l_max) if l == 0 else M for l in ls}
    P = [(p, tuple(2 * l + 1 for l in p)) for p in paths(cfg.l_max)]
    # which outputs, inputs and paths each layer differentiates
    need, layers = {0}, []
    for n in reversed(range(L)):
        req = set(ls) if n > 0 else {0}        # inputs that need a gradient
        out = need | ({0} if need else set())  # the gates read the l = 0 out
        if full_vjp:
            out, req = set(ls), set(ls)
        live = {p for p, _ in P if p[2] in out}
        layers.append((out, req, live))
        need = {l for l in req if l in out or any(p[0] == l for p in live)}
    total = 0
    for out, req, live in layers:
        for p, (i, j, k) in P:
            total += 2 * (2 * E * R * H + 2 * E * H * M)  # radial, fw + rec
            if p in live:                                 # dhid, dw2, dw1
                total += 2 * (2 * E * H * M) + 2 * E * R * H
            t = p in live and p[0] in req                 # a transpose to h
            if _yc_first(i, j, k, E, M):
                if k1_dots or j > 1:                      # Y . C
                    total += 2 * E * i * j * k * (1 if hoisted else 2)
                if k1_dots or i > 1:                      # h . (YC)
                    total += 2 * E * M * i * k * (2 + t)
            else:
                if k1_dots:                               # h x Y
                    total += 2 * E * M * i * j * (2 + t)
                if k1_dots or i * j > 1:                  # (hY) . C
                    total += 2 * E * M * i * j * k * (2 + t)
        for l in ls:
            # lin_out and self, fw + rec; where differentiated, both
            # weights' grads, lin_out's input grad and self's if required
            f = 2 * N * (2 * l + 1) * M * mout[l]
            total += 4 * f + ((3 + (l in req)) * f if l in out else 0)
    if hoisted:                       # the forward's Y . C, once
        total += sum(2 * E * i * j * k for _, (i, j, k) in P
                     if _yc_first(i, j, k, E, M) and (k1_dots or j > 1))
    # energy head: w1, w2 forward; grads of w2, hidden, w1, features
    return total + 2 * N * M * H + 2 * N * H + 2 * (2 * N * H) \
        + 2 * (2 * N * M * H)


@pytest.mark.parametrize("layers", [2, 3])
def test_nequip_forward_flops_match_reference_dots(layers):
    """The energy alone: equal after crediting the K = 1 products."""
    from repro.models import nequip as r_nequip
    from repro_torch.models import nequip
    r_cfg = dataclasses.replace(r_smoke("nequip"), n_layers=layers)
    cfg = dataclasses.replace(get_smoke_config("nequip"), n_layers=layers)
    r_api, rb = _ref_bundle(r_cfg, RShapeSpec(**_MOLECULE))
    batch = rb.args[0]
    ng = _MOLECULE["graph_batch"]
    jp = jax.make_jaxpr(lambda p, b: r_nequip.forward(
        r_cfg, p, {**b, "n_graphs": ng}))(r_api.param_shapes(), batch)
    ref = _dots(jp.jaxpr)
    api, b = dryrun._bundle(cfg, ShapeSpec(**_MOLECULE))
    rec = dryrun.trace_step(
        lambda p, bt: nequip.forward(cfg, p, {**bt, "n_graphs": ng}),
        [api.param_shapes(), b.args[0]])
    assert ref["k1"] > 0
    assert _products(rec) == ref["dot"] - ref["k1"]


@pytest.mark.parametrize("l_max,layers", [(2, 2), (2, 3), (1, 1)])
def test_nequip_train_flops_match_reference_dots(l_max, layers):
    """Exact: the model of the module docstring reproduces both counts,
    and the port's is the reference's less credits (1)-(3)."""
    kw = dict(l_max=l_max, n_layers=layers)
    r_cfg = dataclasses.replace(r_smoke("nequip"), **kw)
    cfg = dataclasses.replace(get_smoke_config("nequip"), **kw)
    ref = _ref_flops(r_cfg, RShapeSpec(**_MOLECULE))["dot"]
    port = _products(_port_trace(cfg, ShapeSpec(**_MOLECULE)))
    api, b = dryrun._bundle(cfg, ShapeSpec(**_MOLECULE))
    E, N = b.args[0]["src"].shape[0], b.args[0]["positions"].shape[0]

    def model(k1_dots, full_vjp, hoisted):
        return _nequip_train_products(cfg, E, N, k1_dots=k1_dots,
                                      full_vjp=full_vjp, hoisted=hoisted)
    assert model(True, True, True) == ref
    k1 = model(True, True, True) - model(False, True, True)
    dead = model(False, True, True) - model(False, False, True)
    hoist = model(False, False, True) - model(False, False, False)
    assert k1 > 0 and dead > 0 and (hoist < 0) == (layers > 1)
    assert port == ref - k1 - dead - hoist


# ---------------------------------------------------------------------------
# affine in depth
# ---------------------------------------------------------------------------

def _depth_counts(cfg, field, values, shape):
    out = []
    for v in values:
        rec = _port_trace(dataclasses.replace(cfg, **{field: v}), shape)
        out.append((rec["cost"]["flops"], rec["cost"]["bytes_accessed"]))
    return out


def test_lm_count_is_affine_in_depth():
    cfg = dataclasses.replace(get_config("stablelm_1_6b"),
                              **_LM_SMALL["stablelm_1_6b"])
    c = _depth_counts(cfg, "num_layers", (2, 3, 4),
                      ShapeSpec("small", "train", seq_len=32,
                                global_batch=2))
    for i in range(2):
        assert c[1][i] - c[0][i] == c[2][i] - c[1][i] > 0


def test_dien_flops_are_affine_in_seq_len():
    """FLOPs only: the bytes grow faster than ``seq_len``, because the
    backward of each step's ``alphas[:, t]`` and ``mask[:, t]`` writes a
    whole ``[B, T]`` gradient (eager autograd's ``select_backward``)."""
    c = _depth_counts(get_smoke_config("dien"), "seq_len", (4, 5, 6),
                      ShapeSpec("small", "train", batch=8))
    assert c[1][0] - c[0][0] == c[2][0] - c[1][0] > 0
    assert c[2][1] - c[1][1] > c[1][1] - c[0][1] > 0


# ---------------------------------------------------------------------------
# the custom ops
# ---------------------------------------------------------------------------

@pytest.fixture
def no_launcher(monkeypatch):
    """Any attempt to load a kernel's library fails the test."""
    def refuse(self):
        raise AssertionError(f"a dry run reached the {self.name} launcher")
    monkeypatch.setattr(_build.Library, "get", refuse)


def _meta(t):
    if not isinstance(t, torch.Tensor):
        return t
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def _fake_and_plain(fn, plain, *tensors, **kw):
    with tracing():
        fake = fn(*(_meta(t) for t in tensors), **kw)
    return fake, plain(*tensors, **kw)


@pytest.mark.parametrize("nq,n,d,k,ydt", [
    (5, 300, 16, 10, torch.float32), (5, 300, 16, 200, torch.float32),
    (3, 40, 8, 64, torch.float32), (4, 300, 24, 10, torch.bfloat16),
    (4, 90, 24, 129, torch.bfloat16)])
def test_topk_dist_fake_matches_plain(no_launcher, nq, n, d, k, ydt):
    g = torch.Generator().manual_seed(0)
    Q = torch.randn(nq, d, generator=g)
    Y = torch.randn(n, d, generator=g).to(ydt)
    fake, plain = _fake_and_plain(topk_dist, topk_dist_ref, Q, Y, k)
    for f, p in zip(fake, plain):
        assert f.device.type == "meta"
        assert (f.shape, f.dtype) == (p.shape, p.dtype)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_l2dist_fake_matches_plain(no_launcher, metric, dt):
    g = torch.Generator().manual_seed(1)
    X = torch.randn(6, 20, generator=g).to(dt)
    Y = torch.randn(50, 20, generator=g).to(dt)
    fake, plain = _fake_and_plain(l2dist, l2dist_ref, X, Y, metric=metric)
    assert (fake.shape, fake.dtype) == (plain.shape, plain.dtype)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embed_bag_fake_matches_plain(no_launcher, mode):
    g = torch.Generator().manual_seed(2)
    table = torch.randn(100, 8, generator=g)
    ids = torch.randint(-1, 100, (12, 5), generator=g)
    fake, plain = _fake_and_plain(embed_bag, embed_bag_ref, table, ids, mode)
    assert (fake.shape, fake.dtype) == (plain.shape, plain.dtype)


@pytest.mark.parametrize("name", ["topk_dist", "l2dist", "embed_bag"])
def test_meta_tensors_take_the_ops_only_in_a_dry_run(no_launcher, name):
    """A ``meta`` tensor reaches a kernel's op (its shape function) only
    under ``tracing``; outside a dry run it takes neither the op nor the
    plain version."""
    call = {"topk_dist": lambda: topk_dist(_meta(torch.empty(3, 8)),
                                           _meta(torch.empty(20, 8)), 4),
            "l2dist": lambda: l2dist(_meta(torch.empty(2, 4)),
                                     _meta(torch.empty(3, 4))),
            "embed_bag": lambda: embed_bag(
                _meta(torch.empty(10, 4)),
                _meta(torch.empty(2, 3, dtype=torch.int64)))}[name]
    with tracing():
        out = call()
    assert all(t.device.type == "meta"
               for t in (out if isinstance(out, tuple) else (out,)))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        call()


def test_wide_deep_train_trace_holds_one_bag_a_forward(no_launcher):
    cfg = get_config("wide_deep")
    sh = shapes_for(cfg)["train_batch"]
    rec = _port_trace(cfg, sh)
    assert rec["cost"]["flops_by_family"]["embed_bag"] == \
        sh.batch * cfg.bag_len * cfg.embed_dim
    from repro_torch.kernels.embed_bag import embed_bag as eb
    assert eb.launches == 0


# ---------------------------------------------------------------------------
# the memory tracker
# ---------------------------------------------------------------------------

def test_tracker_on_a_hand_counted_chain():
    """a (arg, 4 KiB) -> b = a @ w (8 KiB) -> c = b * 2 (8 KiB), b freed ->
    d = c.sum(): peak b + c = 16 KiB (w an argument too); the output d
    (4 bytes) a 512-byte block."""
    a = torch.empty(32, 32, device="meta")
    w = torch.empty(32, 64, device="meta")

    def chain(a, w):
        b = a @ w
        c = b * 2
        del b
        e = c + 1             # b is gone: c + e live
        del c
        return e.sum()
    rec = dryrun.count_step(chain, [a, w])
    pb = rec["per_device_bytes"]
    assert pb["arguments"] == 4096 + 8192
    assert pb["total_peak_estimate"] == 4096 + 8192 + 16384
    assert pb["outputs"] == 512 and pb["aliased"] == 0
    assert pb["temps"] == 16384 - 512
    assert rec["cost"]["flops"] == 2 * 32 * 32 * 64
    # mm: a, w, b; mul: b, c; add: c, e; sum: e, d
    assert rec["cost"]["bytes_accessed"] == 4 * (
        1024 + 2048 + 2048 + 2048 + 2048 + 2048 + 2048 + 2048 + 1)


def test_tracker_counts_the_inplace_adamw_step_as_aliased():
    cfg = get_smoke_config("wide_deep")
    api, b = dryrun._bundle(cfg, ShapeSpec("small", "train", batch=8))
    rec = dryrun.trace_step(b.fn, dryrun.call_shapes(api, b))
    ps = api.param_shapes()
    moments = 2 * dryrun.arg_bytes(api.opt_shapes()["m"])
    assert rec["per_device_bytes"]["aliased"] == dryrun.arg_bytes(ps) \
        + moments


# ---------------------------------------------------------------------------
# published cells, whole
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", [("stablelm_1_6b", "decode_32k"),
                                        ("wide_deep", "train_batch"),
                                        ("nequip", "molecule")])
def test_published_cell_traces_whole(no_launcher, arch, shape):
    rec = dryrun.run_cell(arch, shape, search=(arch == "wide_deep"))
    pb, c = rec["per_device_bytes"], rec["cost"]
    assert rec["arch"] == arch and rec["step"].endswith("_step")
    assert c["flops"] > 0 and c["bytes_accessed"] > 0
    assert pb["total_peak_estimate"] >= pb["arguments"] > 0
    assert 0.5 < c["flops"] / rec["model_flops"] < 2.0
    assert rec["roofline_ms"]["bound"] in ("compute", "memory")
    assert rec["fits"] == (pb["total_peak_estimate"]
                           <= dryrun.HBM_BYTES - dryrun.RESERVE_BYTES)
    if arch == "stablelm_1_6b":           # 128 x 32k of KV cache: 826 GB
        assert not rec["fits"] and pb["aliased"] == pb["arguments"] - \
            dryrun.arg_bytes(get_api(get_config(arch)).param_shapes()) \
            - 2 * 512
    if arch == "wide_deep":
        assert rec["fits"] and rec["largest_fitting_batch"] == 65536


def test_cli_writes_records_and_fails_on_a_bad_cell(tmp_path, capsys):
    assert dryrun.main(["--arch", "sasrec", "--shape", "serve_p99",
                        "--out", str(tmp_path), "--no-search"]) == 0
    assert (tmp_path / "dryrun_h100_sasrec_serve_p99.json").exists()
    assert "[ok]" in capsys.readouterr().out
    with pytest.raises(KeyError):
        dryrun.main(["--arch", "no-such-arch", "--out", str(tmp_path)])
