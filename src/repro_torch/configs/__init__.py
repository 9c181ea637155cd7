"""Architecture registry: one module per assigned architecture.

The same configs as the JAX reference's registry, value for value. The
port runs the dense LMs and the four recsys towers; the MoE LMs and NequIP
are listed because the registry names them (their models are not ported
yet, see ``repro_torch.models``).
"""
from __future__ import annotations

import importlib

from .base import (GNN_SHAPES, GNNConfig, LM_SHAPES, LMConfig, RECSYS_SHAPES,
                   RecSysConfig, ShapeSpec, shapes_for)

ARCHS = (
    "granite_moe_3b_a800m",
    "deepseek_moe_16b",
    "codeqwen15_7b",
    "yi_9b",
    "stablelm_1_6b",
    "nequip",
    "wide_deep",
    "sasrec",
    "autoint",
    "dien",
)

_ALIASES = {
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "codeqwen1.5-7b": "codeqwen15_7b",
    "yi-9b": "yi_9b",
    "stablelm-1.6b": "stablelm_1_6b",
    "wide-deep": "wide_deep",
}


def _module(arch: str):
    arch = _ALIASES.get(arch, arch).replace("-", "_")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; options: {ARCHS}")
    return importlib.import_module(f"{__name__}.{arch}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    """Reduced same-family config for CPU smoke tests."""
    return _module(arch).SMOKE_CONFIG


__all__ = ["ARCHS", "get_config", "get_smoke_config", "LMConfig", "GNNConfig",
           "RecSysConfig", "ShapeSpec", "shapes_for", "LM_SHAPES",
           "GNN_SHAPES", "RECSYS_SHAPES"]
