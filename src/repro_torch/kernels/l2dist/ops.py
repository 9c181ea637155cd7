"""The ``l2dist`` wrapper: checks, empty shapes, and dispatch.

A CUDA tensor launches the hand-written kernel (``l2dist.py``) through the
custom op ``repro_torch::l2dist``, or raises; only a tensor that lies on
the CPU takes the plain version (``ref.py``). The op's fake (a shape
function for fake and meta tensors) and its FLOP formula let a dry run
trace and count it without launching it.
``use_ref=True`` routes to the plain version on any device: it is the
differentiable path, as in the reference (the kernel has no backward, and
a kernel call whose input requires grad raises).
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from .l2dist import _DTYPES, l2dist_cuda
from .._build import takes_kernel
from .ref import l2dist_ref

_FORMS = ("l2", "ip")


def l2dist(X: torch.Tensor, Y: torch.Tensor, *, metric: str = "l2",
           use_ref: bool = False) -> torch.Tensor:
    """Pairwise distance ``f32[Q, N]`` between rows of ``X[Q, d]`` and
    ``Y[N, d]`` (f32 or bf16, accumulated in f32).

    ``metric="l2"`` (squared L2, clamped at 0) or ``"ip"`` (``1 - <x, y>``,
    the registry's ``ip``/``cosine`` form).
    """
    if metric not in _FORMS:
        raise ValueError(f"unsupported kernel metric form {metric!r}; "
                         f"expected one of {_FORMS}")
    if X.dim() != 2 or Y.dim() != 2 or X.shape[1] != Y.shape[1]:
        raise ValueError(f"l2dist takes X[Q, d] and Y[N, d], got "
                         f"{tuple(X.shape)} and {tuple(Y.shape)}")
    if X.device != Y.device:
        raise ValueError(f"l2dist inputs lie on several devices: "
                         f"{X.device} and {Y.device}")
    if use_ref or X.device.type == "cpu":
        return l2dist_ref(X, Y, metric=metric)
    if not takes_kernel(X):
        raise ValueError(f"l2dist runs on CUDA or CPU tensors, not "
                         f"{X.device}")
    if torch.is_grad_enabled() and (X.requires_grad or Y.requires_grad):
        raise RuntimeError("the l2dist CUDA kernel has no backward; call "
                           "l2dist(..., use_ref=True) to differentiate")
    nq, N, d = X.shape[0], Y.shape[0], X.shape[1]
    if nq == 0 or N == 0 or d == 0:          # nothing to launch
        fill = 0.0 if metric == "l2" else 1.0
        return torch.full((nq, N), fill, dtype=torch.float32,
                          device=X.device)
    return torch.ops.repro_torch.l2dist(X, Y, metric)


#: kernel launches so far (CUDA calls only; reset it to 0 to count a run)
l2dist.launches = 0


@torch.library.custom_op("repro_torch::l2dist", mutates_args=())
def _l2dist_op(X: torch.Tensor, Y: torch.Tensor,
               metric: str) -> torch.Tensor:
    out = l2dist_cuda(X, Y, metric)
    l2dist.launches += 1
    return out


@_l2dist_op.register_fake
def _(X, Y, metric):
    if X.dtype != Y.dtype or X.dtype not in _DTYPES:
        raise TypeError(f"l2dist kernel takes two float32 or two bfloat16 "
                        f"inputs, got {X.dtype} and {Y.dtype}")
    return X.new_empty((X.shape[0], Y.shape[0]), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.l2dist)
def _l2dist_flops(X, Y, metric, *args, out_shape=None, **kwargs) -> int:
    """The contraction the kernel computes: ``2 q N d``."""
    return 2 * X[0] * Y[0] * X[1]
