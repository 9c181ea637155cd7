"""Parameter trees: what the initialisers draw, and how trees are walked.

A model's parameters are a tree of dicts and lists with tensor leaves, laid
out as the reference's pytrees are. Each model describes its tree once as a
tree of :class:`Leaf` (shape, dtype, initialiser); ``init_params`` draws
it, and ``models.convert`` checks a carried tree against it.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .._tree import tree_map


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One parameter: its shape, dtype and initialiser.

    ``init`` is ``"ones"``, ``"zeros"``, ``"normal"`` (a standard normal
    times ``scale``) or ``"trunc"`` (a standard normal truncated to
    [-2, 2], times ``scale``: JAX's ``initializers.truncated_normal(scale)``,
    whose std is 0.88 ``scale``).
    """
    shape: tuple
    dtype: torch.dtype
    init: str
    scale: float = 1.0


def normal_generator(generator: torch.Generator | None, seed: int, device
                     ) -> tuple[torch.Generator, torch.device]:
    """The generator to draw with and the device the tree goes to: a
    generator on ``device`` seeded with ``seed`` unless one is given."""
    from ..core.common import resolve_device
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    return generator, dev


def draw(leaf: Leaf, gen: torch.Generator, device) -> torch.Tensor:
    """Draw one leaf on the generator's device, then move it to ``device``."""
    g = gen.device
    if leaf.init == "ones":
        return torch.ones(leaf.shape, dtype=leaf.dtype, device=device)
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, dtype=leaf.dtype, device=device)
    if leaf.init == "normal":
        x = torch.randn(leaf.shape, generator=gen, device=g)
        x.mul_(leaf.scale)
    elif leaf.init == "trunc":
        # inverse CDF of a standard normal over [-2, 2]
        lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
        x = torch.rand(leaf.shape, generator=gen, device=g)
        x.mul_(hi - lo).add_(lo).erfinv_().mul_(math.sqrt(2)).clamp_(-2, 2)
        x.mul_(leaf.scale)
    else:
        raise ValueError(f"unknown initialiser {leaf.init!r}")
    return x.to(dtype=leaf.dtype, device=device)


def draw_tree(spec, gen: torch.Generator, device):
    return tree_map(lambda leaf: draw(leaf, gen, device), spec)
