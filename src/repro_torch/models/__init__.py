"""The embedding models that feed the index, the GNN, and their training
API.

``transformer`` (the LMs: codeqwen, yi, stablelm, and the MoE configs
granite-moe and deepseek-moe), ``recsys`` (wide-deep, AutoInt, DIEN,
SASRec), ``nequip`` with ``e3`` and ``gnn_common``, and ``dist_ctx`` mirror
the JAX reference's modules of those names; ``api`` holds ``get_api`` and
``make_train_step``; ``convert`` carries the reference's parameters
across; ``TransformerLM`` and ``RecSysModel`` hold a model's parameters as
an ``nn.Module``.
"""
from . import (api, convert, dist_ctx, e3, gnn_common, nequip, recsys,
               transformer)
from .api import ArchAPI, get_api, make_train_step, value_and_grad
from .convert import (adamw_state_from_reference, adamw_state_to_reference,
                      gnn_params_from_reference, lm_params_from_reference,
                      recsys_params_from_reference, tensor_from_numpy)
from .modules import ParamModule, RecSysModel, TransformerLM

__all__ = ["api", "convert", "dist_ctx", "e3", "gnn_common", "nequip",
           "recsys", "transformer", "ArchAPI", "get_api", "make_train_step",
           "value_and_grad", "adamw_state_from_reference",
           "adamw_state_to_reference", "gnn_params_from_reference",
           "lm_params_from_reference", "recsys_params_from_reference",
           "tensor_from_numpy", "ParamModule", "RecSysModel",
           "TransformerLM"]
