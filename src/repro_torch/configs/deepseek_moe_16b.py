"""deepseek-moe-16b [arXiv:2401.06066].

28L d_model=2048 16H (kv=16) d_ff=1408 vocab=102400, 2 shared + 64 routed
top-6 fine-grained experts; first layer dense (d_ff=10944) per the paper.
64 experts divide the 16-way model axis -> expert parallelism.
"""
import dataclasses

from .base import LMConfig

CONFIG = LMConfig(
    name="deepseek-moe-16b",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    moe=True,
    num_experts=64,
    top_k=6,
    num_shared_experts=2,
    first_dense_layers=1,
    dense_ff=10944,
    moe_shard="expert",
)

SMOKE_CONFIG = dataclasses.replace(
    CONFIG, name="deepseek-smoke", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=32, vocab_size=256, num_experts=8, top_k=2,
    num_shared_experts=1, first_dense_layers=1, dense_ff=128)
