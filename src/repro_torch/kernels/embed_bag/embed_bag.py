"""Load and launch the CUDA ``embed_bag`` kernel (``csrc/embed_bag.cu``).

The source is built at first use by the shared builder (``kernels._build``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import Library, check_launch

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _configure(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.embed_bag_launch.argtypes = [p, p, i, i, i, i, i, i, i, p, p]
    lib.embed_bag_launch.restype = i
    lib.embed_bag_layout.argtypes = [i, i, i]
    lib.embed_bag_layout.restype = i


LIBRARY = Library("embed_bag",
                  Path(__file__).resolve().parent / "csrc" / "embed_bag.cu",
                  _configure)


def embed_bag_cuda(table: torch.Tensor, indices: torch.Tensor,
                   mode: str) -> torch.Tensor:
    """Launch the kernel on the current stream; returns ``f32[B, D]``. The
    caller (``ops``) has checked shapes and the mode; this checks what the
    kernel itself takes."""
    if table.device.type != "cuda" or indices.device.type != "cuda":
        raise ValueError(f"embed_bag kernel takes CUDA tensors, got "
                         f"{table.device} and {indices.device}")
    if table.dtype not in _DTYPES:
        raise TypeError(f"embed_bag kernel takes a float32 or bfloat16 "
                        f"table, got {table.dtype}")
    if torch.is_grad_enabled() and table.requires_grad:
        raise RuntimeError("the embed_bag CUDA kernel has no backward of "
                           "its own; call embed_bag (ops), whose autograd "
                           "Function differentiates the table")
    table = table.contiguous()
    idx = indices.to(torch.int32).contiguous()
    (V, D), (B, L) = table.shape, idx.shape
    if max(V, D, B, L) >= 2 ** 31:
        raise ValueError(f"embed_bag kernel shape out of range: table "
                         f"{V} x {D}, indices {B} x {L}")
    vec = int(vector_loads(table))
    out = torch.empty((B, D), dtype=torch.float32, device=table.device)
    lib = LIBRARY.get()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = lib.embed_bag_launch(table.data_ptr(), idx.data_ptr(), B, L, V,
                                   D, _DTYPES[table.dtype], vec,
                                   int(mode == "mean"), out.data_ptr(),
                                   stream)
    check_launch("embed_bag", err)
    return out


def vector_loads(table: torch.Tensor) -> bool:
    """Whether the kernel may load 16 bytes a lane (4 f32 or 8 bf16 values,
    its widest load): rows a multiple of 16 bytes and a 16-byte aligned
    table. Otherwise it loads one value a lane."""
    return (table.shape[1] * table.element_size()) % 16 == 0 \
        and table.data_ptr() % 16 == 0


def lane_layout(table: torch.Tensor) -> dict:
    """The lane-group layout the kernel takes for ``table``: values a lane
    loads, lanes a group (one row each), rows a load instruction."""
    code = LIBRARY.get().embed_bag_layout(table.shape[1],
                                          _DTYPES[table.dtype],
                                          int(vector_loads(table)))
    vpl, g = divmod(code, 64)
    return {"values_per_lane": vpl, "lanes_per_row": g,
            "rows_per_load": 32 // g}
