"""The embedding models that feed the index, serving side.

``transformer`` (the dense LMs: codeqwen, yi, stablelm) and ``recsys``
(wide-deep, AutoInt, DIEN, SASRec) mirror the JAX reference's modules of
those names; ``convert`` carries the reference's parameters across;
``TransformerLM`` and ``RecSysModel`` hold a model's parameters as an
``nn.Module``. The MoE LMs and NequIP are not ported yet.
"""
from . import convert, recsys, transformer
from .convert import (lm_params_from_reference, recsys_params_from_reference,
                      tensor_from_numpy)
from .modules import ParamModule, RecSysModel, TransformerLM

__all__ = ["convert", "recsys", "transformer", "lm_params_from_reference",
           "recsys_params_from_reference", "tensor_from_numpy",
           "ParamModule", "RecSysModel", "TransformerLM"]
