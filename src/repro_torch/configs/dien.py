"""dien [arXiv:1809.03672]: embed 18, seq 100, GRU 108, AUGRU, MLP 200-80."""
import dataclasses

from .base import RecSysConfig

CONFIG = RecSysConfig(
    name="dien",
    kind="dien",
    embed_dim=18,
    seq_len=100,
    gru_dim=108,
    mlp=(200, 80),
    vocab_size=1_000_000,
    n_items=1_000_000,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="dien-smoke", embed_dim=8, seq_len=16, gru_dim=24,
    mlp=(32, 16), vocab_size=500, n_items=500)
