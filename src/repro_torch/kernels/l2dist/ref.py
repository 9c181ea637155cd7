"""Plain PyTorch version of ``l2dist``: the pairwise distance matrix.

Mirrors the reference's oracle (``repro/kernels/l2dist/ref.py``): inputs
widen to f32, one matrix product, and the ``"l2"`` form is clamped at 0.
Differentiable through autograd.
"""
from __future__ import annotations

import torch


def l2dist_ref(X: torch.Tensor, Y: torch.Tensor, *,
               metric: str = "l2") -> torch.Tensor:
    """``out[i, j]`` pairwise distance in f32, matmul form.

    ``metric="l2"`` gives ``||X[i] - Y[j]||^2``; ``metric="ip"`` gives
    ``1 - <X[i], Y[j]>`` (the registry's ``ip``/``cosine`` form).
    """
    X = X.float()
    Y = Y.float()
    xy = X @ Y.T
    if metric == "l2":
        nx = torch.sum(X * X, dim=-1, keepdim=True)
        ny = torch.sum(Y * Y, dim=-1, keepdim=True).T
        return torch.clamp_min(nx + ny - 2.0 * xy, 0.0)
    if metric == "ip":
        return 1.0 - xy
    raise ValueError(f"unsupported kernel metric form {metric!r}; "
                     "expected 'l2' or 'ip'")
