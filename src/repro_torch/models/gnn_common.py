"""GNN substrate: CSR neighbour sampling (GraphSAGE fanout) and graph
batching, as the reference's ``models/gnn_common.py``.

``minibatch_lg`` needs a real neighbour sampler: layered fanout sampling
(15-10) over a CSR adjacency, vectorised on the tensors' device (sampling
with replacement, the standard GraphSAGE estimator; a zero-degree node
self-loops). The samplers draw from a ``torch.Generator``; ``draws=`` (a
layer's ``r``) stands in for the reference's ``jax.random`` integers, so
a test can feed them across.
"""
from __future__ import annotations

import numpy as np
import torch


def to_csr(n_nodes: int, src, dst, device=None):
    """Edge list -> CSR ``(indptr int64 [n+1], indices int32 [E])`` with
    ``dst`` as the owner row, each row's sources in edge order (a stable
    sort by ``dst``), on ``device`` (default: the edges' own)."""
    src, dst = torch.as_tensor(src), torch.as_tensor(dst)
    if device is not None:
        src, dst = src.to(device), dst.to(device)
    order = torch.sort(dst, stable=True).indices
    indices = src[order].int()
    del order
    counts = torch.bincount(dst.long(), minlength=n_nodes)
    indptr = torch.zeros(n_nodes + 1, dtype=torch.int64, device=dst.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return indptr, indices


def sample_layer(generator: torch.Generator | None, indptr: torch.Tensor,
                 indices: torch.Tensor, seeds: torch.Tensor, fanout: int,
                 r: torch.Tensor | None = None):
    """Sample ``fanout`` in-neighbours per seed (with replacement).

    ``r [S, fanout]``: integers in [0, 2^30), drawn from ``generator``
    unless given. Returns ``(src, dst)``, int32 ``[S*fanout]``; a
    zero-degree seed self-loops.
    """
    seeds = seeds.long()
    start = indptr[seeds]
    deg = (indptr[seeds + 1] - start)                             # [S]
    if r is None:
        r = torch.randint(0, 1 << 30, (seeds.shape[0], fanout),
                          generator=generator, device=seeds.device)
    off = r.to(seeds.device).long() % torch.clamp(deg, min=1)[:, None]
    nbr = indices[torch.clamp(start[:, None] + off, 0,
                              indices.shape[0] - 1)].long()
    nbr = torch.where(deg[:, None] > 0, nbr, seeds[:, None])      # self-loop
    return (nbr.reshape(-1).int(),
            seeds.repeat_interleave(fanout).int())


def sample_subgraph(generator: torch.Generator | None, indptr, indices,
                    seeds: torch.Tensor, fanout: tuple[int, ...],
                    draws=None):
    """Layered fanout sampling: each layer samples the previous layer's
    sources; returns the layers' ``(src, dst)`` edge lists concatenated.
    ``draws``: one ``r`` per layer, as ``sample_layer`` takes it."""
    srcs, dsts = [], []
    frontier = seeds
    for i, f in enumerate(fanout):
        s, d = sample_layer(generator, indptr, indices, frontier, f,
                            r=None if draws is None else draws[i])
        srcs.append(s)
        dsts.append(d)
        frontier = s
    return torch.cat(srcs), torch.cat(dsts)


def batch_molecules(positions: np.ndarray, species: np.ndarray,
                    edges: np.ndarray, n_graphs: int):
    """Disjoint-union batch of identical-size molecules.

    positions [G, A, 3], species [G, A], edges [G, E, 2] ->
    flat arrays with graph_id, node offsets applied.
    """
    G, A, _ = positions.shape
    pos = positions.reshape(G * A, 3)
    spec = species.reshape(G * A)
    off = (np.arange(G) * A)[:, None, None]
    e = edges + off
    src = e[..., 0].reshape(-1)
    dst = e[..., 1].reshape(-1)
    graph_id = np.repeat(np.arange(G), A)
    return pos, spec, src, dst, graph_id
