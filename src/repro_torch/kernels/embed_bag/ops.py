"""The ``embed_bag`` wrapper: checks, empty shapes, and dispatch.

A CUDA tensor goes through ``EmbedBagFunction``, which launches the
hand-written kernel (``embed_bag.py``) through the custom op
``repro_torch::embed_bag``, or raises; only a tensor that lies
on the CPU takes the plain version (``ref.py``), which autograd
differentiates. Where the table requires grad, the Function's backward
scatters the table's gradient with ``embed_bag_backward_ref`` (plain
PyTorch, as the reference's gradient is XLA's autodiff of its jnp bag,
outside any Pallas kernel). The op's fake (a shape function for fake and
meta tensors) and its FLOP formula let a dry run trace and count it
without launching it.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from .embed_bag import _DTYPES, embed_bag_cuda
from .._build import takes_kernel
from .ref import MODES, embed_bag_backward_ref, embed_bag_ref


class EmbedBagFunction(torch.autograd.Function):
    """``embed_bag`` on a CUDA table: the kernel forward on the detached
    table, and a gradient for the table when it requires one."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, indices: torch.Tensor,
                mode: str) -> torch.Tensor:
        ctx.save_for_backward(indices)
        ctx.mode, ctx.num_rows, ctx.dtype = mode, table.shape[0], table.dtype
        return torch.ops.repro_torch.embed_bag(table.detach(), indices,
                                               mode)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        (indices,) = ctx.saved_tensors
        grad = None
        if ctx.needs_input_grad[0]:
            grad = embed_bag_backward_ref(grad_out, indices, ctx.num_rows,
                                          ctx.dtype, ctx.mode)
        return grad, None, None


def embed_bag(table: torch.Tensor, indices: torch.Tensor,
              mode: str = "sum") -> torch.Tensor:
    """EmbeddingBag: ``out[b] = reduce_l table[indices[b, l]]`` (-1 = pad).

    ``table[V, D]`` f32 or bf16, ``indices[B, L]`` int; returns
    ``f32[B, D]``. ``mode`` is ``"sum"`` or ``"mean"`` (divides by the
    count of indices >= 0, at least 1). Differentiable in ``table``.
    """
    if mode not in MODES:
        raise ValueError(f"unknown embed_bag mode {mode!r}; expected one "
                         f"of {MODES}")
    if table.dim() != 2 or indices.dim() != 2:
        raise ValueError(f"embed_bag takes table[V, D] and indices[B, L], "
                         f"got {tuple(table.shape)} and "
                         f"{tuple(indices.shape)}")
    if indices.dtype.is_floating_point or indices.dtype == torch.bool:
        raise TypeError(f"embed_bag indices must be integers, got "
                        f"{indices.dtype}")
    if table.device != indices.device:
        raise ValueError(f"embed_bag inputs lie on several devices: "
                         f"{table.device} and {indices.device}")
    if table.device.type == "cpu":
        return embed_bag_ref(table, indices, mode)
    if not takes_kernel(table):
        raise ValueError(f"embed_bag runs on CUDA or CPU tensors, not "
                         f"{table.device}")
    (V, D), (B, L) = table.shape, indices.shape
    if B == 0 or D == 0 or L == 0 or V == 0:     # nothing to launch
        return torch.zeros((B, D), dtype=torch.float32, device=table.device)
    return EmbedBagFunction.apply(table, indices, mode)


#: kernel launches so far (CUDA calls only; reset it to 0 to count a run)
embed_bag.launches = 0


@torch.library.custom_op("repro_torch::embed_bag", mutates_args=())
def _embed_bag_op(table: torch.Tensor, indices: torch.Tensor,
                  mode: str) -> torch.Tensor:
    out = embed_bag_cuda(table, indices, mode)
    embed_bag.launches += 1
    return out


@_embed_bag_op.register_fake
def _(table, indices, mode):
    if table.dtype not in _DTYPES:
        raise TypeError(f"embed_bag kernel takes a float32 or bfloat16 "
                        f"table, got {table.dtype}")
    return table.new_empty((indices.shape[0], table.shape[1]),
                           dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.embed_bag)
def _embed_bag_flops(table, indices, mode, *args, out_shape=None,
                     **kwargs) -> int:
    """The row sums: ``B L D`` additions."""
    return indices[0] * indices[1] * table[1]
