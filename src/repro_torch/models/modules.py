"""``nn.Module`` wrappers that hold a model's parameters.

Each wrapper registers every leaf of the parameter tree as a buffer (so
``.to()``, ``state_dict()`` and the device follow the module) and exposes
the functional forwards of its model under ``torch.inference_mode``: they
serve. Training works on the parameter tree itself
(``models.api.make_train_step``).
"""
from __future__ import annotations

import torch
from torch import nn

from .._tree import tree_leaves
from . import recsys, transformer


def _insert(node, path: tuple, leaf) -> None:
    """Put ``leaf`` at ``path`` under ``node``; paths arrive in tree order,
    so a list grows one position at a time."""
    key, rest = path[0], path[1:]
    if not rest:
        if isinstance(node, list):
            node.append(leaf)
        else:
            node[key] = leaf
        return
    empty = [] if isinstance(rest[0], int) else {}
    if isinstance(node, list):
        if key == len(node):
            node.append(empty)
        child = node[key]
    else:
        child = node.setdefault(key, empty)
    _insert(child, rest, leaf)


class ParamModule(nn.Module):
    """Holds a parameter tree as buffers named by their paths."""

    def __init__(self, params: dict):
        super().__init__()
        self._paths = []
        for path, leaf in tree_leaves(params):
            self.register_buffer("/".join(map(str, path)), leaf)
            self._paths.append(path)

    @property
    def params(self) -> dict:
        """The parameter tree (dicts and lists) over the current buffers."""
        root: dict = {}
        for path in self._paths:
            _insert(root, path, self.get_buffer("/".join(map(str, path))))
        return root

    @property
    def device(self) -> torch.device:
        return next(self.buffers()).device


class TransformerLM(ParamModule):
    """A dense LM (``models.transformer``): parameters drawn from ``seed``
    on ``device`` unless ``params`` (a tree, e.g. from
    ``lm_params_from_reference``) is given."""

    def __init__(self, cfg, params: dict | None = None, *, seed: int = 0,
                 device="cuda"):
        super().__init__(params if params is not None else
                         transformer.init_params(cfg, seed=seed,
                                                 device=device))
        self.cfg = cfg

    @torch.inference_mode()
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] -> logits [B, S, V] f32."""
        return transformer.forward(self.cfg, self.params, tokens)[0]

    @torch.inference_mode()
    def forward_hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, S] -> the final normed hidden state [B, S, D]."""
        return transformer.forward_hidden(self.cfg, self.params, tokens)[0]

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor):
        return transformer.prefill(self.cfg, self.params, tokens)

    @torch.inference_mode()
    def init_cache(self, batch: int, max_len: int) -> dict:
        return transformer.init_cache(self.cfg, batch, max_len, self.device)

    @torch.inference_mode()
    def decode_step(self, cache: dict, token: torch.Tensor,
                    pos: torch.Tensor):
        return transformer.decode_step(self.cfg, self.params, cache, token,
                                       pos)


class RecSysModel(ParamModule):
    """A recsys tower (``models.recsys``): parameters drawn from ``seed``
    on ``device`` unless ``params`` is given. Batches are dicts of numpy
    arrays or tensors (``data.recsys_batch``)."""

    def __init__(self, cfg, params: dict | None = None, *, seed: int = 0,
                 device="cuda"):
        super().__init__(params if params is not None else
                         recsys.init_params(cfg, seed=seed, device=device))
        self.cfg = cfg

    def _batch(self, batch: dict) -> dict:
        return recsys.batch_to(batch, self.device)

    @torch.inference_mode()
    def forward(self, batch: dict):
        """-> (ranking logit [B], user representation [B, D])."""
        return recsys.forward(self.cfg, self.params, self._batch(batch))

    @torch.inference_mode()
    def user_repr(self, batch: dict) -> torch.Tensor:
        return recsys.user_repr(self.cfg, self.params, self._batch(batch))

    @torch.inference_mode()
    def retrieval_scores(self, batch: dict, k: int = 100):
        return recsys.retrieval_scores(self.cfg, self.params,
                                       self._batch(batch), k)
