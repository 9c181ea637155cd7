"""Per-architecture training API: ``get_api`` and ``make_train_step``.

The training half of the JAX reference's ``models/api.py``. ``get_api``
returns an ``ArchAPI`` (the config, its family, ``init_params`` and the
AdamW config); ``make_train_step`` turns a loss into one optimizer step.
The families are ``lm`` (the dense and MoE configs), ``gnn`` (NequIP) and
``recsys``.

Not ported here: ``StepBundle``, ``ArchAPI.make_step``, the ``_*_step``
cells and the pspec methods. They build abstract shapes and GSPMD specs for
the reference's dry run and go with its XLA-only tooling (ROADMAP §1 item
14e).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable

import torch

from .._tree import tree_leaves, tree_map
from ..configs.base import GNNConfig, LMConfig, RecSysConfig
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


@dataclasses.dataclass
class ArchAPI:
    config: Any
    family: str
    init_params: Callable       # (generator=None, *, seed=0, device="cuda")
    opt_cfg: AdamWConfig


def get_api(config) -> ArchAPI:
    opt = AdamWConfig()
    if isinstance(config, LMConfig):
        return ArchAPI(config, "lm", partial(transformer.init_params, config),
                       opt)
    if isinstance(config, GNNConfig):
        return ArchAPI(config, "gnn", partial(nequip.init_params, config),
                       opt)
    if isinstance(config, RecSysConfig):
        return ArchAPI(config, "recsys", partial(recsys.init_params, config),
                       opt)
    raise TypeError(type(config))
