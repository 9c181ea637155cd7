"""Build, load and launch the CUDA ``topk_dist`` kernel (``csrc/topk_dist.cu``).

The source compiles with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, at first use, into ``build/kernels/`` at the repository
root (listed in ``.gitignore``); the library name carries a hash of the
source, so an edited source is rebuilt. Nothing is compiled or loaded when
the module is imported, so it imports on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_SRC = Path(__file__).resolve().parent / "csrc" / "topk_dist.cu"
_BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "kernels"
_ARCH = "arch=compute_90a,code=sm_90a"
_FORMS = {"l2": 0, "ip": 1}
#: candidates per tile and queries per block (must match the source)
_BN, _BQ = 128, 64
MAX_K = 128


class _Library:
    """The loaded shared library and what its build printed."""

    def __init__(self):
        self.lib = None
        self.build_log = ""
        self.build_seconds = 0.0

    def get(self) -> ctypes.CDLL:
        if self.lib is None:
            self.lib = self._load()
        return self.lib

    def _load(self) -> ctypes.CDLL:
        digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
        so = _BUILD_DIR / f"libtopk_dist_{digest}.so"
        if not so.exists():
            self._build(so)
        lib = ctypes.CDLL(str(so))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.topk_dist_launch.argtypes = [p, p, p, i, i, i, i, i, i, i,
                                         p, p, p, p, p]
        lib.topk_dist_launch.restype = i
        lib.topk_dist_max_k.argtypes = []
        lib.topk_dist_max_k.restype = i
        if lib.topk_dist_max_k() != MAX_K:
            raise RuntimeError("topk_dist library and wrapper disagree on "
                               "MAX_K")
        return lib

    def _build(self, so: Path) -> None:
        nvcc = shutil.which("nvcc") or os.path.join(
            os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
        if not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found: the topk_dist CUDA kernel "
                               "cannot be built on this machine")
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-gencode", _ARCH, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
               str(_SRC)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{self.build_log}")
        os.replace(tmp, so)


LIBRARY = _Library()


def split_plan(nq: int, N: int, device: torch.device) -> tuple[int, int]:
    """``(tiles_per_split, splits)``: enough blocks for about four per SM."""
    n_tiles = -(-N // _BN)
    q_tiles = -(-nq // _BQ)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = max(1, min(n_tiles, -(-4 * sms // q_tiles)))
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
    if not (Q.is_contiguous() and Y.is_contiguous()):
        raise ValueError("topk_dist kernel takes contiguous Q and Y")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"topk_dist kernel takes 1 <= k <= {MAX_K}, got {k}")
    nq, d = Q.shape
    N = Y.shape[0]
    if max(nq, N, d) >= 2 ** 31 - _BN:
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
    if err != 0:
        raise RuntimeError(f"topk_dist kernel launch failed: CUDA error "
                           f"{err}")
    return out_d, out_i
