"""autoint [arXiv:1810.11921]: 39 fields, embed 16, 3 attn layers 2 heads d=32."""
import dataclasses

from .base import RecSysConfig

CONFIG = RecSysConfig(
    name="autoint",
    kind="autoint",
    n_sparse=39,
    embed_dim=16,
    n_attn_layers=3,
    n_heads=2,
    d_attn=32,
    vocab_size=1_000_000,
    n_items=1_000_000,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="autoint-smoke", n_sparse=6, embed_dim=8, n_attn_layers=2,
    n_heads=2, d_attn=16, vocab_size=1000, n_items=1000)
