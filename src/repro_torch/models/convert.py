"""Carry parameters across from the JAX reference's trees.

The reference's params (and its AdamW state), taken to numpy on its side
(``jax.tree.map(np.asarray, params)``), come in as a tree of dicts and
lists of numpy arrays; the port's tree has the same structure, so the carry
is a tree map that checks every leaf's shape against the model's
``param_spec``. Dtypes are kept as they come (the forwards follow the
parameters' dtype, so an f32-cast tree runs in f32). A JAX bf16 array comes to numpy as ``ml_dtypes.bfloat16``,
which ``torch.from_numpy`` does not take: its bits travel as int16 and are
viewed as ``torch.bfloat16`` again, unchanged.
"""
from __future__ import annotations

import torch

from ..core.common import host_array, tensor_from_host
from .._tree import tree_map
from . import nequip, recsys, transformer
from ._params import Leaf


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """A numpy array (``ml_dtypes.bfloat16`` included) as a tensor on
    ``device``, bit for bit."""
    return tensor_from_host(a, device)


def _carry(spec, tree, device):
    def leaf(s: Leaf, a):
        t = tensor_from_numpy(a, device)
        if tuple(t.shape) != tuple(s.shape):
            raise ValueError(f"reference leaf of shape {tuple(t.shape)}, "
                             f"expected {tuple(s.shape)}")
        return t
    return tree_map(leaf, spec, tree)


def lm_params_from_reference(cfg, tree, device="cuda") -> dict:
    """The reference's LM params (numpy leaves; dense or MoE, with a MoE
    config's ``dense_layers``) as the port's tree on ``device``."""
    return _carry(transformer.param_spec(cfg), tree, device)


def gnn_params_from_reference(cfg, tree, device="cuda") -> dict:
    """The reference's NequIP params (numpy leaves) as the port's tree on
    ``device``."""
    return _carry(nequip.param_spec(cfg), tree, device)


def recsys_params_from_reference(cfg, tree, device="cuda") -> dict:
    """The reference's recsys params (numpy leaves) as the port's tree on
    ``device``."""
    return _carry(recsys.param_spec(cfg), tree, device)


def adamw_state_from_reference(state, device="cuda") -> dict:
    """The reference's ``adamw_init`` / ``adamw_update`` state (numpy
    leaves: ``m`` and ``v`` trees, a scalar ``step``) as the port's, on
    ``device``, bit for bit."""
    def carry(tree):
        return tree_map(lambda a: tensor_from_numpy(a, device), tree)
    return {"m": carry(state["m"]), "v": carry(state["v"]),
            "step": tensor_from_numpy(state["step"], device)}


def adamw_state_to_reference(state) -> dict:
    """The port's AdamW state as the reference's tree of numpy arrays."""
    def host(tree):
        return tree_map(host_array, tree)
    return {"m": host(state["m"]), "v": host(state["v"]),
            "step": host_array(state["step"])}
