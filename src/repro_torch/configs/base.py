"""Config dataclasses + the (arch x shape) registry.

Every assigned architecture gets one module in this package exporting
``CONFIG`` (and a reduced ``SMOKE_CONFIG``); shapes are per-family. The
values equal the JAX reference's field for field. All dataclasses are
frozen and hashable.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                      # dense FFN width, or per-expert width (MoE)
    vocab_size: int
    moe: bool = False
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    first_dense_layers: int = 0    # leading dense layers in MoE models
    dense_ff: int = 0              # their FFN width
    capacity_factor: float = 1.25
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    # expert sharding strategy: "expert" = EP over model axis, "ffn" = TP
    # inside each expert (used when num_experts doesn't divide the axis)
    moe_shard: str = "expert"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def vocab_padded(self) -> int:
        """Embedding-table rows padded to a multiple of 128 so the vocab
        dim shards evenly over any power-of-two model axis (MaxText-style);
        logical vocab stays exact — padding logits are masked in the loss."""
        return self.vocab_size + (-self.vocab_size) % 128

    def param_count(self) -> int:
        """Total parameters (for 6*N*D roofline bookkeeping)."""
        D, V, H = self.d_model, self.vocab_size, self.num_heads
        KV, hd = self.num_kv_heads, self.head_dim
        attn = D * H * hd + 2 * D * KV * hd + H * hd * D
        n = V * D + D * V          # embed + head (untied)
        n += self.num_layers * (attn + 2 * D)  # attn + norms
        moe_layers = self.num_layers - self.first_dense_layers if self.moe else 0
        dense_layers = self.num_layers - moe_layers
        ff_dense = self.dense_ff if (self.moe and self.first_dense_layers) else self.d_ff
        n += dense_layers * 3 * D * ff_dense
        if self.moe:
            per_expert = 3 * D * self.d_ff
            n += moe_layers * (self.num_experts + self.num_shared_experts) * per_expert
            n += moe_layers * D * self.num_experts  # router
        n += D  # final norm
        return n

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: top_k + shared experts only)."""
        if not self.moe:
            return self.param_count()
        D = self.d_model
        full = self.param_count()
        moe_layers = self.num_layers - self.first_dense_layers
        per_expert = 3 * D * self.d_ff
        inactive = moe_layers * (self.num_experts - self.top_k) * per_expert
        return full - inactive


# ---------------------------------------------------------------------------
# GNN family (NequIP)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int = 5
    d_hidden: int = 32             # multiplicity per irrep l
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 64            # species-embedding vocab (stub frontend)
    d_feat: int = 0                # raw node-feature dim for citation shapes


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RecSysConfig:
    name: str
    kind: str                      # wide_deep | sasrec | autoint | dien
    n_sparse: int = 0
    embed_dim: int = 32
    vocab_size: int = 1_000_000    # rows per sparse table
    mlp: Tuple[int, ...] = ()
    # autoint
    n_attn_layers: int = 0
    n_heads: int = 0
    d_attn: int = 0
    # sasrec / dien sequence
    seq_len: int = 0
    n_blocks: int = 0
    gru_dim: int = 0
    n_items: int = 1_000_000       # item-catalogue size (retrieval tower)
    bag_len: int = 32              # multi-hot behaviour-bag length (EmbeddingBag)

    @property
    def items_padded(self) -> int:
        """Catalogue rows padded to a multiple of 512 so the item table
        shards evenly over all mesh axes (padding scores masked at top-k)."""
        return self.n_items + (-self.n_items) % 512


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                      # train | prefill | decode | serve | graph | retrieval
    seq_len: int = 0
    global_batch: int = 0
    # gnn
    n_nodes: int = 0
    n_edges: int = 0
    batch_nodes: int = 0
    fanout: Tuple[int, ...] = ()
    d_feat: int = 0
    graph_batch: int = 0
    # recsys
    batch: int = 0
    n_candidates: int = 0


LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", seq_len=4096, global_batch=256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", seq_len=32768, global_batch=32),
    "decode_32k": ShapeSpec("decode_32k", "decode", seq_len=32768, global_batch=128),
    "long_500k": ShapeSpec("long_500k", "decode", seq_len=524288, global_batch=1),
}

GNN_SHAPES = {
    "full_graph_sm": ShapeSpec("full_graph_sm", "graph", n_nodes=2708,
                               n_edges=10556, d_feat=1433),
    "minibatch_lg": ShapeSpec("minibatch_lg", "graph", n_nodes=232965,
                              n_edges=114_615_892, batch_nodes=1024,
                              fanout=(15, 10)),
    "ogb_products": ShapeSpec("ogb_products", "graph", n_nodes=2_449_029,
                              n_edges=61_859_140, d_feat=100),
    "molecule": ShapeSpec("molecule", "graph", n_nodes=30, n_edges=64,
                          graph_batch=128),
}

RECSYS_SHAPES = {
    "train_batch": ShapeSpec("train_batch", "train", batch=65536),
    "serve_p99": ShapeSpec("serve_p99", "serve", batch=512),
    "serve_bulk": ShapeSpec("serve_bulk", "serve", batch=262144),
    "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval", batch=1,
                                n_candidates=1_000_000),
}


def shapes_for(config) -> dict:
    if isinstance(config, LMConfig):
        return LM_SHAPES
    if isinstance(config, GNNConfig):
        return GNN_SHAPES
    if isinstance(config, RecSysConfig):
        return RECSYS_SHAPES
    raise TypeError(type(config))
