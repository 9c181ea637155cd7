"""Load and launch the CUDA ``count_flags`` kernel (``csrc/count_flags.cu``).

The source is built at first use by the shared builder (``kernels._build``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import Library, check_launch


def _configure(lib: ctypes.CDLL) -> None:
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    lib.count_flags_launch.argtypes = [p, ll, ll, ll, p, p]
    lib.count_flags_launch.restype = ctypes.c_int


LIBRARY = Library("count_flags",
                  Path(__file__).resolve().parent / "csrc" / "count_flags.cu",
                  _configure)


def count_flags_cuda(flags: torch.Tensor, cols: int) -> torch.Tensor:
    """Launch the kernel on the current stream; returns a 0-d int64 tensor.
    The caller (``ops``) has checked the shape and layout."""
    out = torch.empty((), dtype=torch.int64, device=flags.device)
    lib = LIBRARY.get()
    with torch.cuda.device(flags.device):
        stream = torch.cuda.current_stream(flags.device).cuda_stream
        err = lib.count_flags_launch(flags.data_ptr(), flags.shape[0],
                                     flags.shape[1], cols, out.data_ptr(),
                                     stream)
    check_launch("count_flags", err)
    return out
