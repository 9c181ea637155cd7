"""Gradient compression with error feedback.

The JAX reference's ``train/compress.py``. Two schemes, each with an
error-feedback buffer so that what compression drops is added back into
the next step's gradient:

  * ``topk``: keep the entries of each leaf whose magnitude is at least the
    k-th largest (``k = max(int(n * topk_frac), 1)``; ties at the threshold
    keep more than k), the rest go to the buffer;
  * ``int8``: per-leaf symmetric int8 quantisation (round half to even, as
    ``jnp.round`` and ``torch.round`` both do), the residual to the buffer.
"""
from __future__ import annotations

import dataclasses

import torch

from .._tree import tree_map


@dataclasses.dataclass(frozen=True)
class CompressorConfig:
    scheme: str = "none"          # none | topk | int8
    topk_frac: float = 0.05


def compress_init(params):
    """Error-feedback buffers, shaped like the grads (f32)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _topk_leaf(g: torch.Tensor, frac: float):
    flat = g.reshape(-1).to(torch.float32)
    k = max(int(flat.shape[0] * frac), 1)
    mag = flat.abs()
    thresh = torch.topk(mag, k).values[-1]
    kept = torch.where(mag >= thresh, flat, 0.0)
    return kept.reshape(g.shape), (flat - kept).reshape(g.shape)


def _int8_leaf(g: torch.Tensor):
    gf = g.to(torch.float32)
    scale = torch.clamp_min(gf.abs().max(), 1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return deq, gf - deq


def compressed_grads(cfg: CompressorConfig, grads, ef):
    """Returns ``(compressed grads, new error buffers)``; ``"none"`` hands
    both back as they are."""
    if cfg.scheme == "none":
        return grads, ef
    if cfg.scheme not in ("topk", "int8"):
        raise ValueError(cfg.scheme)

    def one(g, e):
        acc = g.to(torch.float32) + e
        if cfg.scheme == "topk":
            out, res = _topk_leaf(acc, cfg.topk_frac)
        else:
            out, res = _int8_leaf(acc)
        return out.to(g.dtype), res

    with torch.no_grad():
        out = tree_map(one, grads, ef)
    return (tree_map(lambda g, o: o[0], grads, out),
            tree_map(lambda g, o: o[1], grads, out))
