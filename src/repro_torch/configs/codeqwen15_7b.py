"""codeqwen1.5-7b [hf:Qwen/CodeQwen1.5-7B] — dense qwen1.5 arch."""
import dataclasses

from .base import LMConfig

CONFIG = LMConfig(
    name="codeqwen1.5-7b",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="codeqwen-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=128, vocab_size=256)
