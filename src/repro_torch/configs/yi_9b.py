"""yi-9b [arXiv:2403.04652] — dense llama-arch with aggressive GQA (kv=4)."""
import dataclasses

from .base import LMConfig

CONFIG = LMConfig(
    name="yi-9b",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="yi-smoke", num_layers=2, d_model=64, num_heads=8,
    num_kv_heads=2, d_ff=128, vocab_size=256)
