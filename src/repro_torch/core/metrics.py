"""Metric-space registry: pluggable distance functions for the HNSW core.

Built-in spaces (hnswlib-compatible naming):

  * ``l2``     — squared L2 ``||q - x||^2`` (ordering-equivalent to L2).
  * ``ip``     — inner-product distance ``1 - <q, x>``.
  * ``cosine`` — same distance function as ``ip``; vectors and queries are
                 unit-normalised at ingest (``normalize_ingest=True``).

Distances accumulate in float32 whatever the storage dtype, and round
where the reference's do as XLA compiles them: the l2 point form's
difference in the inputs' common dtype (bf16 for two bf16 vectors), then
its square and sum in f32; the ip point form's products and both
pairwise (matmul) forms wholly in f32. Shapes carry an explicit batch:
``point_fn(q[..., d], X[..., C, d]) -> [..., C]`` and
``pairwise_fn(A[..., n, d], B[..., m, d]) -> [..., n, m]``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


def sqdist_point(q: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Squared L2 distance from ``q[..., d]`` to rows of ``X[..., C, d]``."""
    diff = (X - q.unsqueeze(-2)).float()
    return torch.sum(diff * diff, dim=-1)


def sqdist_pairwise(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Pairwise squared L2 ``[..., n, m]`` in matmul form, clamped at 0."""
    A, B = A.float(), B.float()
    na = torch.sum(A * A, dim=-1, keepdim=True)
    nb = torch.sum(B * B, dim=-1).unsqueeze(-2)
    d = na + nb - 2.0 * (A @ B.transpose(-1, -2))
    return torch.clamp_min(d, 0.0)


def ipdist_point(q: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Inner-product distance ``1 - <q, x>`` to rows of ``X[..., C, d]``."""
    return 1.0 - torch.sum(X.float() * q.float().unsqueeze(-2), dim=-1)


def ipdist_pairwise(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Pairwise inner-product distance ``[..., n, m]``: ``1 - A @ B^T``."""
    return 1.0 - (A.float() @ B.float().transpose(-1, -2))


@dataclasses.dataclass(frozen=True)
class Metric:
    """One metric space: distance functions + ingest policy.

    ``kernel_form`` names the distance form the exact scan tier's
    ``topk_dist`` kernel implements for this space (``"l2"`` or ``"ip"``);
    ``None`` means the exact tier uses the dense ``pairwise_fn`` instead.
    """
    name: str
    point_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    pairwise_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    normalize_ingest: bool = False
    kernel_form: str | None = None


_METRICS: dict[str, Metric] = {}


def register_metric(metric: Metric, *, overwrite: bool = False) -> Metric:
    """Register a metric space under ``metric.name``; returns it."""
    if metric.name in _METRICS and not overwrite:
        raise ValueError(f"metric space {metric.name!r} is already "
                         f"registered; pass overwrite=True to replace it")
    _METRICS[metric.name] = metric
    return metric


def get_metric(space: str) -> Metric:
    """Look up a registered metric space (uniform error on miss)."""
    try:
        return _METRICS[space]
    except KeyError:
        raise ValueError(
            f"unknown metric space {space!r}; registered spaces: "
            f"{list_metrics()}") from None


def list_metrics() -> tuple[str, ...]:
    return tuple(sorted(_METRICS))


def dist_point(space: str, q: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Distance from ``q[..., d]`` to rows of ``X[..., C, d]`` in ``space``."""
    return get_metric(space).point_fn(q, X)


def dist_pairwise(space: str, A: torch.Tensor, B: torch.Tensor
                  ) -> torch.Tensor:
    """Pairwise distances ``[..., n, m]`` in ``space``."""
    return get_metric(space).pairwise_fn(A, B)


def normalize_rows(X, eps: float = 1e-12):
    """Unit-normalise rows (numpy or torch); zero rows stay zero-ish."""
    if isinstance(X, torch.Tensor):
        norms = (X * X).sum(dim=-1, keepdim=True) ** 0.5
        return X / torch.clamp_min(norms, eps)
    X = np.asarray(X)
    return X / ((X * X).sum(axis=-1, keepdims=True) ** 0.5 + eps)


def kernel_form(space: str) -> str | None:
    """The ``topk_dist`` kernel form for ``space`` (``"l2"``/``"ip"``/None)."""
    return get_metric(space).kernel_form


register_metric(Metric("l2", sqdist_point, sqdist_pairwise,
                       kernel_form="l2"))
register_metric(Metric("ip", ipdist_point, ipdist_pairwise,
                       kernel_form="ip"))
register_metric(Metric("cosine", ipdist_point, ipdist_pairwise,
                       normalize_ingest=True, kernel_form="ip"))
