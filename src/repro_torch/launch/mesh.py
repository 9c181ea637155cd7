"""This host's devices, as the list the sharded index places its shards on,
and as the ``[data][model]`` grid the MoE dispatch splits over.

The reference's ``make_local_mesh`` flattens every JAX device onto one mesh
axis; here a "mesh" is a plain list of torch devices, one shard per entry
(cycled when there are more shards than devices). ``make_grid`` lays the
same devices out as a two-axis grid. The reference's
``make_production_mesh`` (a 16x16 TPU pod) has no single-node counterpart.
"""
from __future__ import annotations

import torch

from ..core.common import resolve_device


def make_local_mesh(device="cuda") -> list[torch.device]:
    """Every visible CUDA device, or ``[cpu]`` when ``device="cpu"``.

    Raises when no GPU is present and the CPU was not asked for.
    """
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_grid(data: int, model: int, device="cuda") -> list[list[torch.device]]:
    """A ``[data][model]`` grid of devices for ``models.dist_ctx.use_mesh``,
    standing for the reference's ``Mesh(..., ("data", "model"))``: this
    host's devices (``make_local_mesh``) in row-major order, cycled when
    the grid has more entries than there are devices (on one card every
    entry is that card)."""
    if data < 1 or model < 1:
        raise ValueError(f"a grid of {data} x {model}")
    devs = make_local_mesh(device)
    return [[devs[(i * model + j) % len(devs)] for j in range(model)]
            for i in range(data)]
