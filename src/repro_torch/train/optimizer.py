"""AdamW with global-norm clipping and a linear-warmup cosine schedule.

The JAX reference's ``train/optimizer.py`` over the port's parameter trees
(dicts and lists of tensors, ``models._params``). The optimizer state is a
tree shaped like the parameters (``m`` and ``v`` in f32) plus an int32
``step``.

The reference computes the learning rate, the bias corrections and the clip
scale in f32 under ``jit``; here they are f32 tensors on the parameters'
device (Python floats would compute them in f64 and drift the parameters by
ulps on every step). A bf16 parameter is updated in f32 and rounded back;
its moments stay f32. ``adamw_update`` writes the new parameters and
moments into the old tensors, ``UPDATE_CHUNK`` elements at a time, with the
multiply-adds XLA fuses fused here too (the reference's jitted train step
donates its parameters and state): the old and new states never coexist,
and the temporaries are those of one chunk. A caller that reads the old
parameters after a step copies them first.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .._tree import tree_leaves, tree_map
from ..core.common import has_data


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _leaves(tree) -> list:
    return [leaf for _, leaf in tree_leaves(tree)]


def adamw_init(params) -> dict:
    """Zero moments in f32, shaped like ``params``; ``step`` an int32
    scalar on the parameters' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    first = _leaves(params)[0]
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), in f32: linear warm-up to
    ``lr`` over ``warmup_steps``, then a cosine to ``min_lr_frac * lr`` at
    ``total_steps``."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _global_norm(leaves: list) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares, the
    leaves added in tree order as the reference's Python ``sum`` adds
    them."""
    total = sum(torch.sum(torch.square(g.to(torch.float32))) for g in leaves)
    return torch.sqrt(total)


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(max_norm / (gnorm + 1e-9), 1.0)


def _scaled(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``g * scale`` with JAX's promotion: a bf16 leaf times the f32 scale
    is f32 (torch would keep bf16 for a 0-dim f32 operand)."""
    return g.to(torch.promote_types(g.dtype, scale.dtype)) * scale


def clip_by_global_norm(grads, max_norm: float):
    """Scale every leaf by ``min(1, max_norm / (norm + 1e-9))``; returns
    ``(clipped grads, global norm)``."""
    gnorm = _global_norm(_leaves(grads))
    scale = _clip_scale(gnorm, max_norm)
    return tree_map(lambda g: _scaled(g, scale), grads), gnorm


UPDATE_CHUNK = 1 << 24     # elements the update computes at a time


def adamw_update(cfg: AdamWConfig, grads, state: dict, params):
    """One AdamW step: ``(params, new state, {"lr", "grad_norm"})``.

    ``params`` and ``state``'s moments are overwritten with the new values
    and returned. Clipping is applied leaf by leaf inside the update (the
    same arithmetic as clipping the whole tree first, without a clipped
    copy of every gradient)."""
    with torch.no_grad():
        gnorm = _global_norm(_leaves(grads))
        scale = _clip_scale(gnorm, cfg.grad_clip)
        step = state["step"] + 1
        lr = schedule(cfg, step)
        stepf = step.to(torch.float32)
        b1, b2 = cfg.b1, cfg.b2
        bc1 = 1 - torch.pow(b1, stepf)
        bc2 = 1 - torch.pow(b2, stepf)

        # ``torch.add(a, b, alpha=c)`` is one fused multiply-add, as XLA
        # fuses ``c * b + a``: the same roundings as the reference, and no
        # temporary for the product. The last one needs ``lr`` as a number;
        # a dry run's stand-in ``lr`` has none, and any number makes the
        # same operations.
        lr_f = float(lr) if has_data(lr) else cfg.lr

        def upd(g, m, v, p):
            """The new ``m``, ``v`` and ``p`` written into ``m``, ``v`` and
            ``p`` (``out=`` stores what the functional form returns)."""
            g = _scaled(g, scale).to(torch.float32)
            torch.add(torch.mul(g, 1 - b1), m, alpha=b1, out=m)
            torch.add(torch.mul(g, 1 - b2).mul_(g), v, alpha=b2, out=v)
            del g
            denom = torch.div(v, bc2).sqrt_().add_(cfg.eps)
            delta = torch.div(m, bc1).div_(denom)
            del denom
            pf = p.to(torch.float32)
            delta.add_(pf, alpha=cfg.weight_decay)
            torch.sub(pf, delta, alpha=lr_f, out=p)   # rounded to p's dtype

        def upd_leaf(g, m, v, p):
            if not all(t.is_contiguous() for t in (p, m, v)):
                upd(g, m, v, p)         # no flat view: the leaf at once
                return
            g = g.reshape(-1)
            pf, mf, vf = (t.view(-1) for t in (p, m, v))
            for i in range(0, p.numel(), UPDATE_CHUNK):
                sl = slice(i, i + UPDATE_CHUNK)
                upd(g[sl], mf[sl], vf[sl], pf[sl])

        tree_map(upd_leaf, grads, state["m"], state["v"], params)
        return (params, {"m": state["m"], "v": state["v"], "step": step},
                {"lr": lr, "grad_norm": gnorm})
