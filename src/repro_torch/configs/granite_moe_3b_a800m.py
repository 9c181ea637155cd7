"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-3b-a800m-base].

Assignment line: 32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155,
MoE 40e top-8. (The bracket note "32 experts" conflicts with the headline
"40e top-8"; we follow the headline — matches the 3b-a800m card.)
40 experts don't divide the 16-way model axis -> TP inside each expert.
"""
import dataclasses

from .base import LMConfig

CONFIG = LMConfig(
    name="granite-moe-3b-a800m",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    moe=True,
    num_experts=40,
    top_k=8,
    moe_shard="ffn",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="granite-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=32, vocab_size=256, num_experts=8, top_k=2)
