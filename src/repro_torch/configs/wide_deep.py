"""wide-deep [arXiv:1606.07792]: 40 sparse fields, embed 32, MLP 1024-512-256."""
import dataclasses

from .base import RecSysConfig

CONFIG = RecSysConfig(
    name="wide-deep",
    kind="wide_deep",
    n_sparse=40,
    embed_dim=32,
    mlp=(1024, 512, 256),
    vocab_size=1_000_000,
    n_items=1_000_000,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="wide-deep-smoke", n_sparse=6, embed_dim=8, mlp=(32, 16),
    vocab_size=1000, n_items=1000, bag_len=8)
