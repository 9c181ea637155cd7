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
_YTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: candidates per tile and queries per block (``contract::BN, BQ`` in
#: ``kernels/_csrc/contract.cuh``)
_BN, _BQ = 128, 64
#: the longest list of the streaming route; a larger k takes the large-k
#: route (distance rows in query chunks, then a radix select per row)
MAX_K = 128
#: scratch of one chunk of the large-k route (rows + the sort's buffers)
LARGE_K_SCRATCH = 256 << 20


def _configure(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.topk_dist_launch.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i,
                                     p, p, p, p, p]
    lib.topk_dist_launch.restype = i
    lib.topk_dist_large_launch.argtypes = [p, p, p, i, i, i, i, i, i, i, i,
                                           i, i, p, p, p, p, p, p]
    lib.topk_dist_large_launch.restype = i
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


def operands(Q: torch.Tensor, Y: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor, int, int]:
    """``(Q, Y, d, dq)`` as the kernel takes them: Q in f32 (a bf16 Q is
    widened, a copy of ``nq x d`` values), Y in its own type, never copied
    unless its rows must be padded to 16 bytes or it is misaligned. Rows
    are zero-padded (zeros change no dot product and no norm): Y's to a
    multiple of 16 bytes (``d``), Q's to ``d`` for an f32 Y and to a
    multiple of 64 columns (``dq``) for a bf16 Y, whose 128-byte slices of
    64 values each pair with two f32 slices of Q."""
    if Y.dtype not in _YTYPES or Q.dtype not in _YTYPES:
        raise TypeError(f"topk_dist kernel takes float32 or bfloat16 "
                        f"inputs, got {Q.dtype} and {Y.dtype}")
    Q = Q.float()
    if Y.dtype == torch.float32:
        Q, Y = rows16(Q, Y)
        return Q, Y, Y.shape[1], Y.shape[1]
    (Y,) = rows16(Y)
    d = Y.shape[1]
    dq = -(-d // 64) * 64
    Q = torch.nn.functional.pad(Q, (0, dq - Q.shape[1])).contiguous()
    return Q, Y, d, dq


def topk_dist_cuda(Q: torch.Tensor, Y: torch.Tensor, k: int, metric: str,
                   mask: torch.Tensor | None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream. The caller (``ops``) has
    checked the metric form and shapes; this checks what the kernel itself
    takes (a host pointer would fault it)."""
    if Q.device.type != "cuda" or Y.device.type != "cuda":
        raise ValueError(f"topk_dist kernel takes CUDA tensors, got "
                         f"{Q.device} and {Y.device}")
    if k < 1:
        raise ValueError(f"topk_dist kernel takes k >= 1, got {k}")
    nq, N = Q.shape[0], Y.shape[0]
    Q, Y, d, dq = operands(Q, Y)
    ytype = _YTYPES[Y.dtype]
    if (max(nq, N, 4 * dq, k) >= 2 ** 31 - _BN
            or (-(-N // _BN)) * dq >= 2 ** 31):
        raise ValueError("topk_dist kernel takes fewer than 2^31 rows")
    m = None
    if mask is not None:
        m = mask.reshape(-1)
        m = (m if m.dtype == torch.bool else m != 0).contiguous().view(
            torch.uint8)
    mp = None if m is None else m.data_ptr()
    out_d = torch.empty((nq, k), dtype=torch.float32, device=Q.device)
    out_i = torch.empty((nq, k), dtype=torch.int32, device=Q.device)
    lib = LIBRARY.get()
    with torch.cuda.device(Q.device):
        stream = torch.cuda.current_stream(Q.device).cuda_stream
        if k <= MAX_K:
            tps, splits = split_plan(nq, N, Q.device)
            if splits == 1:
                part_d, part_i = out_d, out_i
            else:
                part_d = torch.empty((nq, splits, k), dtype=torch.float32,
                                     device=Q.device)
                part_i = torch.empty((nq, splits, k), dtype=torch.int32,
                                     device=Q.device)
            err = lib.topk_dist_launch(
                Q.data_ptr(), Y.data_ptr(), mp, nq, N, d, dq, ytype, k,
                _FORMS[metric], tps, splits, part_d.data_ptr(),
                part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
                stream)
            check_launch("topk_dist", err)
            return out_d, out_i
        # the large-k route, one chunk of queries at a time
        ld = -(-N // 4) * 4
        kk = min(k, N)
        rows = large_k_chunk(nq, ld, kk)
        D = torch.empty((rows, ld), dtype=torch.float32, device=Q.device)
        sk = torch.empty((rows, kk), dtype=torch.int32, device=Q.device)
        si = torch.empty((rows, kk), dtype=torch.int32, device=Q.device)
        for lo in range(0, nq, rows):
            c = min(rows, nq - lo)
            tps, splits = split_plan(c, N, Q.device)
            err = lib.topk_dist_large_launch(
                Q[lo:lo + c].data_ptr(), Y.data_ptr(), mp, c, N, d, dq,
                ytype, k, _FORMS[metric], tps, splits, ld, D.data_ptr(),
                out_d[lo:lo + c].data_ptr(), out_i[lo:lo + c].data_ptr(),
                sk.data_ptr(), si.data_ptr(), stream)
            check_launch("topk_dist", err)
    return out_d, out_i


def large_k_chunk(nq: int, ld: int, kk: int) -> int:
    """Queries per chunk of the large-k route: as many as keep the distance
    rows (``ld`` f32 each) and the sort's two buffers (``kk`` each) within
    :data:`LARGE_K_SCRATCH`, a multiple of the query tile when more than
    one tile fits."""
    rows = max(1, LARGE_K_SCRATCH // (4 * ld + 8 * kk))
    if rows >= _BQ:
        rows -= rows % _BQ
    return min(nq, rows)
