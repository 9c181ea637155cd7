"""Load and launch the CUDA ``beam_expand`` kernel (``csrc/beam_expand.cu``).

The source is compiled at first use by ``kernels._build``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import Library, check_launch

#: the widest neighbour row (M0) and query (d) the kernel takes
MAX_SLOTS = 128
MAX_DIM = 11_904
#: the launcher's codes of the row and query dtypes it takes
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _configure(lib: ctypes.CDLL) -> None:
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.beam_expand_launch.argtypes = [p, i, p, i, i, p, p, p, p, ll, ll, ll,
                                       ll, p, p, p]
    lib.beam_expand_launch.restype = ctypes.c_int
    lib.beam_expand_max_slots.restype = ctypes.c_int
    lib.beam_expand_max_dim.restype = ctypes.c_int
    limits = (lib.beam_expand_max_slots(), lib.beam_expand_max_dim())
    if limits != (MAX_SLOTS, MAX_DIM):
        raise RuntimeError(f"beam_expand library limits {limits} differ from "
                           f"the wrapper's {(MAX_SLOTS, MAX_DIM)}")


LIBRARY = Library("beam_expand",
                  Path(__file__).resolve().parent / "csrc" / "beam_expand.cu",
                  _configure)


def beam_expand_cuda(form: str, Q: torch.Tensor, vectors: torch.Tensor,
                     nbrs_l: torch.Tensor, cur: torch.Tensor,
                     running: torch.Tensor, visited: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream; returns ``(nd, ni)``. The
    caller (``ops``) has checked dtypes, shapes and layout."""
    if Q.dtype not in (torch.float32, vectors.dtype):
        Q = Q.float()               # two half types meet in f32, as in PyTorch
    B, M0 = cur.shape[0], nbrs_l.shape[1]
    nd = torch.empty((B, M0), dtype=torch.float32, device=Q.device)
    ni = torch.empty((B, M0), dtype=torch.int64, device=Q.device)
    lib = LIBRARY.get()
    with torch.cuda.device(Q.device):
        stream = torch.cuda.current_stream(Q.device).cuda_stream
        err = lib.beam_expand_launch(
            Q.data_ptr(), DTYPES[Q.dtype], vectors.data_ptr(),
            DTYPES[vectors.dtype], form == "ip", nbrs_l.data_ptr(),
            cur.data_ptr(), running.data_ptr(), visited.data_ptr(), B,
            Q.shape[1], M0, visited.shape[1], nd.data_ptr(), ni.data_ptr(),
            stream)
    check_launch("beam_expand", err)
    return nd, ni
