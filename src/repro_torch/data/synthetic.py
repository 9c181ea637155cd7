"""Seeded synthetic datasets (numpy) with the paper's dataset widths.

Clustered Gaussians at SIFT d=128, GIST d=960 or ImageNet d=150; every
metric is relative to exact brute force. LM token streams and recsys
batches feed the embedding models. The same seed gives the same arrays as
the reference package's generators.
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


def lm_token_batch(vocab: int, batch: int, seq: int, seed: int) -> np.ndarray:
    """Zipf-ish synthetic token stream, [batch, seq+1] int32."""
    rng = np.random.default_rng(seed)
    z = rng.zipf(1.3, size=(batch, seq + 1)) - 1
    return np.minimum(z, vocab - 1).astype(np.int32)


def recsys_batch(cfg, batch: int, seed: int) -> dict:
    """One recsys batch for ``cfg.kind`` (numpy, int32 ids; ``-1`` pads
    wide-deep's behaviour bag and DIEN's history)."""
    rng = np.random.default_rng(seed)
    V = cfg.vocab_size
    out = {"label": rng.integers(0, 2, size=batch).astype(np.int32)}
    if cfg.kind in ("wide_deep", "autoint"):
        out["sparse_ids"] = rng.integers(0, V, size=(batch, cfg.n_sparse)).astype(np.int32)
        if cfg.kind == "wide_deep":
            bag = rng.integers(0, V, size=(batch, cfg.bag_len)).astype(np.int32)
            drop = rng.random((batch, cfg.bag_len)) < 0.3
            bag[drop] = -1
            out["bag_ids"] = bag
    elif cfg.kind == "dien":
        hist = rng.integers(0, cfg.n_items, size=(batch, cfg.seq_len)).astype(np.int32)
        cut = rng.integers(1, cfg.seq_len + 1, size=batch)
        hist[np.arange(cfg.seq_len)[None, :] >= cut[:, None]] = -1
        out["hist_ids"] = hist
        out["target_id"] = rng.integers(0, cfg.n_items, size=batch).astype(np.int32)
    elif cfg.kind == "sasrec":
        seq = rng.integers(0, cfg.n_items, size=(batch, cfg.seq_len)).astype(np.int32)
        out["seq_ids"] = seq
        out["pos_ids"] = np.roll(seq, -1, axis=1).astype(np.int32)
        out["pos_ids"][:, -1] = rng.integers(0, cfg.n_items, size=batch)
        out["neg_ids"] = rng.integers(0, cfg.n_items,
                                      size=(batch, cfg.seq_len)).astype(np.int32)
        out["target_id"] = out["pos_ids"][:, -1].copy()
    return out
