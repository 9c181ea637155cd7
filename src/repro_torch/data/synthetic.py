"""Seeded synthetic datasets (numpy) with the paper's dataset widths.

Clustered Gaussians at SIFT d=128, GIST d=960 or ImageNet d=150; every
metric is relative to exact brute force. LM token streams and recsys
batches feed the embedding models, graph batches with pair-potential
energies the GNN. The same seed gives the same arrays as
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


def _pair_potential(pos: np.ndarray, src: np.ndarray, dst: np.ndarray,
                    graph_id: np.ndarray, n_graphs: int) -> np.ndarray:
    """Cheap learnable target: sum over edges of a Morse-ish pair term."""
    r = np.linalg.norm(pos[dst] - pos[src], axis=1) + 1e-9
    e = np.exp(-r) - 0.5 * np.exp(-2 * r)
    out = np.zeros(n_graphs)
    np.add.at(out, graph_id[dst], e)
    return out.astype(np.float32)


def gnn_batch(cfg, n_nodes: int, n_edges: int, seed: int,
              n_graphs: int = 1, d_feat: int = 0) -> dict:
    """Random geometric-ish graph batch with synthetic energy targets.

    Edges are drawn over all nodes, then every edge across two graphs
    becomes a self-loop of its ``dst`` (which ``nequip.forward`` masks
    out): with many small graphs almost every edge does (ROADMAP §3).
    """
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(n_nodes, 3)) * 2.0).astype(np.float32)
    species = rng.integers(0, cfg.n_species, size=n_nodes).astype(np.int32)
    src = rng.integers(0, n_nodes, size=n_edges).astype(np.int32)
    dst = rng.integers(0, n_nodes, size=n_edges).astype(np.int32)
    nodes_per_graph = n_nodes // n_graphs
    graph_id = np.minimum(np.arange(n_nodes) // nodes_per_graph,
                          n_graphs - 1).astype(np.int32)
    # keep edges within one graph
    src = np.where(graph_id[src] == graph_id[dst], src, dst)
    batch = {
        "positions": pos,
        "species": species,
        "src": src,
        "dst": dst,
        "edge_mask": np.ones(n_edges, np.float32),
        "node_mask": np.ones(n_nodes, np.float32),
        "graph_id": graph_id,
        "n_graphs": n_graphs,
        "energy_target": _pair_potential(pos, src, dst, graph_id, n_graphs),
    }
    if d_feat:
        batch["node_feats"] = rng.normal(size=(n_nodes, d_feat)).astype(np.float32)
    return batch
