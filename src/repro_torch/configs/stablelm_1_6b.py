"""stablelm-1.6b [hf:stabilityai/stablelm-2-1_6b]."""
import dataclasses

from .base import LMConfig

CONFIG = LMConfig(
    name="stablelm-1.6b",
    num_layers=24,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="stablelm-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=128, vocab_size=256)
