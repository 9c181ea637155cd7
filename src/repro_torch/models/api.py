"""Uniform per-architecture API: ``get_api``, ``make_train_step`` and the
(arch x shape) step cells, as the JAX reference's ``models/api.py``.

``get_api(config)`` returns an ``ArchAPI``: the config, its family
(``lm`` for the dense and MoE configs, ``gnn`` for NequIP, ``recsys``),
``init_params`` and the AdamW config. ``param_shapes()`` and
``opt_shapes()`` give the trees of ``ShapeDtype`` (shape and dtype, the
reference's ``jax.ShapeDtypeStruct``) that ``init_params`` and
``adamw_init`` would make, without allocating anything.
``make_step(shape)`` gives a ``StepBundle`` for one cell: the step
function, the abstract arguments after the parameters (and optimizer
state), and the arguments the step updates in place. The dry run
(``launch.dryrun``) traces these bundles on fake tensors.

Not ported: the pspec methods, ``filter_pspecs``, ``_bspec`` and
``_axes_spec``, and the ``act_spec=`` arguments. They are GSPMD layouts for
the reference's device meshes; the port's step runs on one card.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable

import torch

from .._tree import tree_leaves, tree_map
from ..configs.base import GNNConfig, LMConfig, RecSysConfig, ShapeSpec
from ..train.optimizer import AdamWConfig, adamw_update
from . import nequip, recsys, transformer


def value_and_grad(loss_fn: Callable, params, batch):
    """``((loss, metrics), grads)``, as ``jax.value_and_grad(loss_fn,
    has_aux=True)(params, batch)``: the gradient with respect to every
    parameter leaf by ``torch.autograd`` (a leaf the loss does not use
    gets a zero gradient, as under ``jax.grad``), the loss and metrics
    detached."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = [p for _, p in tree_leaves(live)]
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = iter([torch.zeros_like(p) if g is None else g
                  for p, g in zip(leaves, grads)])
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree_map(lambda p: next(grads), params))


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    ``value_and_grad`` of ``loss_fn(params, batch) -> (loss, metrics)``,
    then ``adamw_update``; the metrics gain ``lr`` and ``grad_norm``.
    ``params`` and the moments are updated in place (the reference's
    jitted step donates both), so a model whose parameters, gradients and
    moments fill the card trains without a second copy."""
    def step(params, opt_state, batch):
        (_, metrics), grads = value_and_grad(loss_fn, params, batch)
        params, opt_state, om = adamw_update(opt_cfg, grads, opt_state,
                                             params)
        return params, opt_state, {**metrics, **om}
    return step


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """An abstract argument: a shape and a dtype, nothing allocated (the
    reference's ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        n = self.dtype.itemsize
        for d in self.shape:
            n *= d
        return n


@dataclasses.dataclass
class StepBundle:
    """One (arch x shape) cell: ``fn(params, [opt_state], *args)``.

    ``donate`` holds the argument numbers (of that full call) the step
    updates in place, as the reference's ``donate_argnums``: the
    parameters and moments of a train step (``adamw_update`` writes them),
    the KV cache of a decode step. ``api`` is the ``ArchAPI`` of the
    bundle's config where the shape changes it (a GNN cell that adds a
    node-feature frontend), else None."""
    name: str
    fn: Callable
    args: tuple            # ShapeDtype trees (after params / opt state)
    with_opt: bool
    donate: tuple = ()
    api: "ArchAPI | None" = None


@dataclasses.dataclass
class ArchAPI:
    config: Any
    family: str
    init_params: Callable       # (generator=None, *, seed=0, device="cuda")
    opt_cfg: AdamWConfig
    param_spec: Callable = None  # () -> the tree of ``_params.Leaf``

    def param_shapes(self) -> Any:
        return tree_map(lambda leaf: ShapeDtype(tuple(leaf.shape),
                                                leaf.dtype),
                        self.param_spec())

    def opt_shapes(self) -> Any:
        """``adamw_init``'s tree: f32 moments shaped like the parameters,
        an int32 ``step``."""
        def moment(s):
            return ShapeDtype(s.shape, torch.float32)
        ps = self.param_shapes()
        return {"m": tree_map(moment, ps), "v": tree_map(moment, ps),
                "step": ShapeDtype((), torch.int32)}

    def make_step(self, shape: ShapeSpec) -> StepBundle:
        if self.family == "lm":
            return _lm_step(self, shape)
        if self.family == "gnn":
            return _gnn_step(self, shape)
        if self.family == "recsys":
            return _recsys_step(self, shape)
        raise ValueError(self.family)


def get_api(config) -> ArchAPI:
    opt = AdamWConfig()
    for kind, family, mod in ((LMConfig, "lm", transformer),
                              (GNNConfig, "gnn", nequip),
                              (RecSysConfig, "recsys", recsys)):
        if isinstance(config, kind):
            return ArchAPI(config, family, partial(mod.init_params, config),
                           opt, partial(mod.param_spec, config))
    raise TypeError(type(config))


def _pad_to(n: int, mult: int) -> int:
    return n + (-n) % mult


def _i32(*s) -> ShapeDtype:
    return ShapeDtype(tuple(s), torch.int32)


def _f32(*s) -> ShapeDtype:
    return ShapeDtype(tuple(s), torch.float32)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _lm_step(api: ArchAPI, shape: ShapeSpec) -> StepBundle:
    cfg: LMConfig = api.config
    B, S = shape.global_batch, shape.seq_len

    if shape.kind == "train":
        fn = make_train_step(
            lambda p, b: transformer.lm_loss(cfg, p, b["tokens"]),
            api.opt_cfg)
        return StepBundle("train_step", fn, ({"tokens": _i32(B, S + 1)},),
                          with_opt=True, donate=(0, 1))

    if shape.kind == "prefill":
        def fn(params, batch):
            return transformer.prefill(cfg, params, batch["tokens"])
        return StepBundle("prefill_step", fn, ({"tokens": _i32(B, S)},),
                          with_opt=False)

    # decode: one token against a seq_len KV cache
    KV, hd, L = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    kv = ShapeDtype((L, B, S, KV, hd), transformer.COMPUTE_DTYPE)

    def fn(params, cache, token, pos):
        return transformer.decode_step(cfg, params, cache, token, pos)
    return StepBundle("serve_step", fn, ({"k": kv, "v": kv}, _i32(B),
                                         _i32(B)),
                      with_opt=False, donate=(1,))


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

GNN_PAD = 512   # the reference pads node and edge arrays for any mesh size


def _gnn_batch_specs(shape: ShapeSpec):
    """``(batch, n_graphs, d_feat)``: the reference's arrays, padded to
    multiples of ``GNN_PAD``; ``minibatch_lg`` is its 1,024-seed 15-10
    fanout subgraph over the global node arrays."""
    if shape.name == "minibatch_lg":
        s = shape.batch_nodes
        n_edges = s * shape.fanout[0] + s * shape.fanout[0] * shape.fanout[1]
        n_nodes, n_graphs, d_feat = shape.n_nodes, 1, 0
    else:
        g = max(shape.graph_batch, 1)
        n_nodes, n_edges = shape.n_nodes * g, shape.n_edges * g
        n_graphs, d_feat = g, shape.d_feat
    Np, Ep = _pad_to(n_nodes, GNN_PAD), _pad_to(n_edges, GNN_PAD)
    batch = {"positions": _f32(Np, 3), "species": _i32(Np),
             "src": _i32(Ep), "dst": _i32(Ep), "edge_mask": _f32(Ep),
             "node_mask": _f32(Np), "graph_id": _i32(Np),
             "energy_target": _f32(n_graphs)}
    if d_feat:
        batch["node_feats"] = _f32(Np, d_feat)
    return batch, n_graphs, d_feat


def _gnn_step(api: ArchAPI, shape: ShapeSpec) -> StepBundle:
    cfg: GNNConfig = api.config
    batch, n_graphs, d_feat = _gnn_batch_specs(shape)
    own = None
    if d_feat and cfg.d_feat != d_feat:
        cfg = dataclasses.replace(cfg, d_feat=d_feat)
        own = api = get_api(cfg)

    def loss(p, b):                    # ``n_graphs`` stays a Python int
        return nequip.loss_fn(cfg, p, {**b, "n_graphs": n_graphs})
    return StepBundle("train_step", make_train_step(loss, api.opt_cfg),
                      (batch,), with_opt=True, donate=(0, 1), api=own)


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------

def _recsys_batch_specs(cfg: RecSysConfig, B: int, kind: str) -> dict:
    batch: dict = {}
    if cfg.kind in ("wide_deep", "autoint"):
        batch["sparse_ids"] = _i32(B, cfg.n_sparse)
        if cfg.kind == "wide_deep":
            batch["bag_ids"] = _i32(B, cfg.bag_len)
    elif cfg.kind == "dien":
        batch["hist_ids"] = _i32(B, cfg.seq_len)
        batch["target_id"] = _i32(B)
    elif cfg.kind == "sasrec":
        batch["seq_ids"] = _i32(B, cfg.seq_len)
        if kind == "train":
            batch["pos_ids"] = _i32(B, cfg.seq_len)
            batch["neg_ids"] = _i32(B, cfg.seq_len)
        else:
            batch["target_id"] = _i32(B)
    if kind == "train" and cfg.kind != "sasrec":
        batch["label"] = _i32(B)
    return batch


def _recsys_step(api: ArchAPI, shape: ShapeSpec) -> StepBundle:
    cfg: RecSysConfig = api.config
    B = shape.batch
    if shape.kind == "train":
        fn = make_train_step(partial(recsys.loss_fn, cfg), api.opt_cfg)
        return StepBundle("train_step", fn,
                          (_recsys_batch_specs(cfg, B, "train"),),
                          with_opt=True, donate=(0, 1))
    batch = _recsys_batch_specs(cfg, B, "serve")
    if shape.kind == "serve":
        def fn(params, batch):
            return recsys.forward(cfg, params, batch)[0]
        return StepBundle("serve_step", fn, (batch,), with_opt=False)

    # retrieval: 1 query x the item catalogue
    def fn(params, batch):
        return recsys.retrieval_scores(cfg, params, batch, k=100)
    return StepBundle("retrieval_step", fn, (batch,), with_opt=False)
