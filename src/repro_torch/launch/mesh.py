"""This host's devices, as the list the sharded index places its shards on.

The reference's ``make_local_mesh`` flattens every JAX device onto one mesh
axis; here a "mesh" is a plain list of torch devices, one shard per entry
(cycled when there are more shards than devices). The reference's
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
