"""Seeded synthetic datasets (numpy) with the paper's dataset widths.

Clustered Gaussians at SIFT d=128, GIST d=960 or ImageNet d=150; every
metric is relative to exact brute force. The same seed gives the same
vectors as the reference package's generator.
"""
from __future__ import annotations

import numpy as np


def clustered_vectors(n: int, d: int, n_clusters: int = 32, seed: int = 0,
                      scale: float = 0.15,
                      noise_seed: int | None = None) -> np.ndarray:
    """Mixture-of-Gaussians point cloud on the unit sphere shell.

    ``noise_seed`` (port only) draws fresh rows of the mixture that ``seed``
    defines: the same cluster centres, new assignments and noise — queries
    and replacement rows for an index built from ``seed``.
    """
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    if noise_seed is not None:
        rng = np.random.default_rng(noise_seed)
    assign = rng.integers(0, n_clusters, size=n)
    X = centers[assign] + scale * rng.normal(size=(n, d))
    return X.astype(np.float32)


def brute_force_knn(X: np.ndarray, Q: np.ndarray, k: int) -> np.ndarray:
    """Exact ground truth ids [q, k] by squared L2 (blocked to bound memory)."""
    out = np.empty((Q.shape[0], k), np.int64)
    xn = (X * X).sum(1)
    for i in range(0, Q.shape[0], 256):
        q = Q[i:i + 256]
        d = xn[None, :] - 2 * q @ X.T
        out[i:i + 256] = np.argsort(d, axis=1)[:, :k]
    return out


def exact_knn(X: np.ndarray, Q: np.ndarray, k: int,
              space: str = "l2") -> np.ndarray:
    """Space-aware exact ground truth ids [q, k] (l2 / ip / cosine)."""
    if space == "l2":
        return brute_force_knn(X, Q, k)
    if space == "cosine":
        X = X / (np.linalg.norm(X, axis=1, keepdims=True) + 1e-12)
        Q = Q / (np.linalg.norm(Q, axis=1, keepdims=True) + 1e-12)
    elif space != "ip":
        raise ValueError(f"no exact ground truth for space {space!r}")
    return np.argsort(1.0 - Q @ X.T, axis=1)[:, :k]
