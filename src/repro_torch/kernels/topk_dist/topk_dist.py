"""Load and launch the CUDA ``topk_dist`` kernel (``csrc/topk_dist.cu``).

The source is built at first use by the shared builder (``kernels._build``:
``nvcc`` for ``sm_90a``, a plain C interface loaded with ``ctypes``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import HEADERS, Library, check_launch, rows16

_FORMS = {"l2": 0, "ip": 1}
#: candidates per tile and queries per block (``contract::BN, BQ`` in
#: ``kernels/_csrc/contract.cuh``)
_BN, _BQ = 128, 64
MAX_K = 128


def _configure(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.topk_dist_launch.argtypes = [p, p, p, i, i, i, i, i, i, i,
                                     p, p, p, p, p]
    lib.topk_dist_launch.restype = i
    lib.topk_dist_max_k.argtypes = []
    lib.topk_dist_max_k.restype = i
    if lib.topk_dist_max_k() != MAX_K:
        raise RuntimeError("topk_dist library and wrapper disagree on MAX_K")


LIBRARY = Library("topk_dist",
                  Path(__file__).resolve().parent / "csrc" / "topk_dist.cu",
                  _configure, HEADERS)


def split_plan(nq: int, N: int, device: torch.device) -> tuple[int, int]:
    """``(tiles_per_split, splits)``: a persistent grid of about one block
    per SM (the kernel's shared memory allows one), each block walking a
    contiguous run of candidate tiles."""
    n_tiles = -(-N // _BN)
    q_tiles = -(-nq // _BQ)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = max(1, min(n_tiles, sms // q_tiles))
    tps = -(-n_tiles // splits)
    return tps, -(-n_tiles // tps)


def topk_dist_cuda(Q: torch.Tensor, Y: torch.Tensor, k: int, metric: str,
                   mask: torch.Tensor | None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream. The caller (``ops``) has
    checked the metric form and shapes; this checks what the kernel itself
    takes (a host pointer would fault it)."""
    if Q.device.type != "cuda" or Y.device.type != "cuda":
        raise ValueError(f"topk_dist kernel takes CUDA tensors, got "
                         f"{Q.device} and {Y.device}")
    if Q.dtype != torch.float32 or Y.dtype != torch.float32:
        raise TypeError(f"topk_dist kernel takes float32, got {Q.dtype} "
                        f"and {Y.dtype}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"topk_dist kernel takes 1 <= k <= {MAX_K}, got {k}")
    nq, N = Q.shape[0], Y.shape[0]
    Q, Y = rows16(Q, Y)
    d = Q.shape[1]
    if max(nq, N, 4 * d) >= 2 ** 31 - _BN or (-(-N // _BN)) * d >= 2 ** 31:
        raise ValueError("topk_dist kernel takes fewer than 2^31 rows")
    m = None
    if mask is not None:
        m = mask.reshape(-1)
        m = (m if m.dtype == torch.bool else m != 0).contiguous().view(
            torch.uint8)
    tps, splits = split_plan(nq, N, Q.device)
    out_d = torch.empty((nq, k), dtype=torch.float32, device=Q.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=Q.device)
    if splits == 1:
        part_d, part_i = out_d, out_i
    else:
        part_d = torch.empty((nq, splits, k), dtype=torch.float32,
                             device=Q.device)
        part_i = torch.empty((nq, splits, k), dtype=torch.int32,
                             device=Q.device)
    lib = LIBRARY.get()
    with torch.cuda.device(Q.device):
        stream = torch.cuda.current_stream(Q.device).cuda_stream
        err = lib.topk_dist_launch(
            Q.data_ptr(), Y.data_ptr(), None if m is None else m.data_ptr(),
            nq, N, d, k, _FORMS[metric], tps, splits, part_d.data_ptr(),
            part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), stream)
    check_launch("topk_dist", err)
    return out_d, out_i
