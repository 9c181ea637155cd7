"""The ``topk_dist`` wrapper: checks, the empty batch, and dispatch.

A CUDA tensor launches the hand-written kernel (``topk_dist.py``) through
the custom op ``repro_torch::topk_dist``, or raises; only a tensor that
lies on the CPU takes the plain version (``ref.py``). There is no fallback
from the kernel to the plain version. The op's fake (a shape function for
fake and meta tensors, never run on real data) and its FLOP formula let a
dry run trace and count the op without launching it.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from .topk_dist import _YTYPES, topk_dist_cuda
from .._build import takes_kernel
from .ref import topk_dist_ref

_FORMS = ("l2", "ip")


def topk_dist(Q: torch.Tensor, Y: torch.Tensor, k: int, *,
              metric: str = "l2", mask: torch.Tensor | None = None):
    """k nearest rows of ``Y[N, d]`` per query row of ``Q[q, d]``.

    Returns ``(dists[q, k] f32, ids[q, k] i32)`` sorted ascending by
    ``(distance, id)`` in the ``metric`` form (``"l2"`` squared L2, ``"ip"``
    ``1 - <q, y>``). ``mask`` (bool/int ``[N]``, nonzero = eligible)
    restricts results; rows with fewer than k eligible candidates pad with
    ``(inf, -1)``.
    """
    if metric not in _FORMS:
        raise ValueError(f"unsupported kernel metric form {metric!r}; "
                         f"expected one of {_FORMS}")
    if Q.dim() != 2 or Y.dim() != 2 or Q.shape[1] != Y.shape[1]:
        raise ValueError(f"topk_dist takes Q[q, d] and Y[N, d], got "
                         f"{tuple(Q.shape)} and {tuple(Y.shape)}")
    if k < 1:
        raise ValueError(f"k must be positive, got {k}")
    if mask is not None and mask.numel() != Y.shape[0]:
        raise ValueError(f"mask has {mask.numel()} entries for "
                         f"{Y.shape[0]} candidates")
    devices = {Q.device, Y.device} | ({mask.device} if mask is not None
                                      else set())
    if len(devices) != 1:
        raise ValueError(f"topk_dist inputs lie on several devices: "
                         f"{devices}")
    nq, N = Q.shape[0], Y.shape[0]
    if nq == 0 or N == 0:                    # nothing to scan
        return (torch.full((nq, k), float("inf"), dtype=torch.float32,
                           device=Q.device),
                torch.full((nq, k), -1, dtype=torch.int32, device=Q.device))
    if Q.device.type == "cpu":
        return topk_dist_ref(Q, Y, k, metric=metric, mask=mask)
    if not takes_kernel(Q):
        raise ValueError(f"topk_dist runs on CUDA or CPU tensors, not "
                         f"{Q.device}")
    return torch.ops.repro_torch.topk_dist(Q, Y, k, metric, mask)


#: kernel launches so far (CUDA calls only; reset it to 0 to count a run)
topk_dist.launches = 0


@torch.library.custom_op("repro_torch::topk_dist", mutates_args=())
def _topk_dist_op(Q: torch.Tensor, Y: torch.Tensor, k: int, metric: str,
                  mask: torch.Tensor | None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    out = topk_dist_cuda(Q, Y, k, metric, mask)
    topk_dist.launches += 1
    return out


@_topk_dist_op.register_fake
def _(Q, Y, k, metric, mask):
    """The outputs the launcher makes, after the checks it makes: ``k``
    columns on either route (the large-k route pads past ``N`` with
    ``(inf, -1)``)."""
    if Q.dtype not in _YTYPES or Y.dtype not in _YTYPES:
        raise TypeError(f"topk_dist kernel takes float32 or bfloat16 "
                        f"inputs, got {Q.dtype} and {Y.dtype}")
    if k < 1:
        raise ValueError(f"topk_dist kernel takes k >= 1, got {k}")
    nq = Q.shape[0]
    return (Q.new_empty((nq, k), dtype=torch.float32),
            Q.new_empty((nq, k), dtype=torch.int32))


@register_flop_formula(torch.ops.repro_torch.topk_dist)
def _topk_dist_flops(Q, Y, k, metric, mask, *args, out_shape=None,
                     **kwargs) -> int:
    """The contraction the kernel computes: ``2 q N d``."""
    return 2 * Q[0] * Y[0] * Q[1]
