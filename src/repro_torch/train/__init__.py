"""The training substrate: AdamW, checkpointing, gradient compression."""
from .optimizer import AdamWConfig, adamw_init, adamw_update, clip_by_global_norm
from .checkpoint import CheckpointManager
from .compress import CompressorConfig, compress_init, compressed_grads

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
           "CheckpointManager", "CompressorConfig", "compress_init",
           "compressed_grads"]
