"""sasrec [arXiv:1808.09781]: embed 50, 2 blocks, 1 head, seq 50."""
import dataclasses

from .base import RecSysConfig

CONFIG = RecSysConfig(
    name="sasrec",
    kind="sasrec",
    embed_dim=50,
    n_blocks=2,
    n_heads=1,
    seq_len=50,
    vocab_size=1_000_000,
    n_items=1_000_000,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="sasrec-smoke", embed_dim=16, n_blocks=2, seq_len=12,
    vocab_size=500, n_items=500)
