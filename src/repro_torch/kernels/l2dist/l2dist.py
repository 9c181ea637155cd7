"""Load and launch the CUDA ``l2dist`` kernel (``csrc/l2dist.cu``).

The source is built at first use by the shared builder (``kernels._build``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import HEADERS, Library, check_launch, rows16

_FORMS = {"l2": 0, "ip": 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _configure(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.l2dist_launch.argtypes = [p, p, i, i, i, i, i, p, p]
    lib.l2dist_launch.restype = i


LIBRARY = Library("l2dist",
                  Path(__file__).resolve().parent / "csrc" / "l2dist.cu",
                  _configure, HEADERS)


def l2dist_cuda(X: torch.Tensor, Y: torch.Tensor,
                metric: str) -> torch.Tensor:
    """Launch the kernel on the current stream; returns ``f32[Q, N]``. The
    caller (``ops``) has checked shapes and the metric form; this checks
    what the kernel itself takes."""
    if X.device.type != "cuda" or Y.device.type != "cuda":
        raise ValueError(f"l2dist kernel takes CUDA tensors, got {X.device} "
                         f"and {Y.device}")
    if X.dtype != Y.dtype or X.dtype not in _DTYPES:
        raise TypeError(f"l2dist kernel takes two float32 or two bfloat16 "
                        f"inputs, got {X.dtype} and {Y.dtype}")
    nq, N = X.shape[0], Y.shape[0]
    X, Y = rows16(X, Y)
    d = X.shape[1]
    if max(nq, N, 4 * d) >= 2 ** 31 - 128 or (-(-N // 128)) * d >= 2 ** 31:
        raise ValueError(f"l2dist kernel takes fewer than 2^31 rows and "
                         f"columns, got {nq} x {N} x {d}")
    out = torch.empty((nq, N), dtype=torch.float32, device=X.device)
    lib = LIBRARY.get()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.l2dist_launch(X.data_ptr(), Y.data_ptr(), nq, N, d,
                                _DTYPES[X.dtype], _FORMS[metric],
                                out.data_ptr(), stream)
    check_launch("l2dist", err)
    return out
