"""Plain PyTorch version of ``beam_expand``: one expansion step of the
lockstep beam search, as whole ``[B, M0]`` and ``[B, M0, d]`` tensors."""
from __future__ import annotations

from typing import Callable

import torch

#: ``core.common``'s padding, restated: ``core.search`` imports this package
INF = float("inf")
INVALID = -1


def beam_expand_ref(point_fn: Callable[[torch.Tensor, torch.Tensor],
                                       torch.Tensor],
                    Q: torch.Tensor, vectors: torch.Tensor,
                    nbrs_l: torch.Tensor, cur: torch.Tensor,
                    running: torch.Tensor, visited: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(nd[B, M0], ni[B, M0])``: the distance and id of each fresh
    neighbour slot of ``cur``'s row (``(inf, -1)`` elsewhere); marks every
    valid slot of a running lane in ``visited[B, N + 1]`` (column ``N`` is
    the sink of the other slots)."""
    N = visited.shape[1] - 1
    nb = nbrs_l[cur].long()                               # [B, M0]
    valid = (nb >= 0) & running[:, None]
    nc = nb.clamp_min(0)
    fresh = valid & ~visited.gather(1, nc)
    visited.scatter_(1, torch.where(valid, nc, N), True)

    nd = torch.where(fresh, point_fn(Q, vectors[nc]), INF)
    return nd, torch.where(fresh, nc, INVALID)
