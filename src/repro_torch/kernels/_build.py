"""Build and load the port's CUDA kernels: ``nvcc`` + a plain C interface.

Each kernel's source (``<name>/csrc/<name>.cu``) compiles for ``sm_90a``
into a shared library, at first use, into ``build/kernels/`` at the
repository root (listed in ``.gitignore``), and is loaded with ``ctypes``.
The library name carries a hash of the source and of the headers it
includes (``_csrc/*.cuh``), so an edited source or header is rebuilt.
Nothing is compiled or loaded when a module is imported, so the package
imports on a machine without ``nvcc``. :func:`build_all` runs one
``nvcc`` per source at once and waits for all of them.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
#: headers shared by the kernels' sources (included by relative path)
HEADERS = tuple(sorted((Path(__file__).resolve().parent / "_csrc").glob(
    "*.cuh")))
ARCH = "arch=compute_90a,code=sm_90a"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be "
                           "built on this machine")
    return nvcc


class Library:
    """One kernel's shared library: built at first use, then loaded.

    ``configure(lib)`` declares the C functions' argument types (pointers
    and the stream as ``c_void_p``, or ctypes would cut them to 32 bits)
    and checks any constant the wrapper relies on.
    """

    def __init__(self, name: str, src: Path,
                 configure: Callable[[ctypes.CDLL], None],
                 headers: tuple[Path, ...] = ()):
        self.name = name
        self.src = src
        self.headers = headers
        self.configure = configure
        self.lib = None
        self.build_log = ""
        self.build_seconds = 0.0

    @property
    def so_path(self) -> Path:
        h = hashlib.sha256()
        for f in (self.src, *self.headers):
            h.update(f.read_bytes())
        digest = h.hexdigest()[:16]
        return BUILD_DIR / f"lib{self.name}_{digest}.so"

    def get(self) -> ctypes.CDLL:
        """The loaded library, built first if needed."""
        if self.lib is None:
            so = self.so_path
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}"
                                     ".tmp")
                cmd = [_nvcc(), "-gencode", ARCH, "-std=c++17", "-O3",
                       "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                       "-o", str(tmp), str(self.src)]
                t0 = time.perf_counter()
                r = subprocess.run(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
                self.build_seconds = time.perf_counter() - t0
                self.build_log = r.stdout
                if r.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {self.src.name} "
                                       f"({r.returncode}):\n{r.stdout}")
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            self.configure(lib)
            self.lib = lib
        return self.lib


def build_all(libraries) -> None:
    """Build and load every library, with all ``nvcc`` runs in flight
    together (one thread each, waiting on its ``nvcc``)."""
    with ThreadPoolExecutor(max_workers=len(libraries)) as pool:
        for f in [pool.submit(lib.get) for lib in libraries]:
            f.result()


def rows16(*tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The matrices as the contraction kernels take them: contiguous, rows
    a multiple of 16 bytes long, 16-byte aligned. A matrix that is not is
    copied with its rows zero-padded to the next multiple of 16 bytes
    (zeros change no dot product and no norm); all come back equally wide.
    """
    per = 16 // tensors[0].element_size()
    d = tensors[0].shape[1]
    width = -(-d // per) * per
    out = []
    for t in tensors:
        t = t.contiguous()
        if width != d:
            t = torch.nn.functional.pad(t, (0, width - d))
        elif t.data_ptr() % 16:
            t = t.clone()           # a fresh allocation is aligned
        out.append(t)
    return tuple(out)


def check_launch(name: str, err: int) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


class _Tracing:
    depth = 0


@contextlib.contextmanager
def tracing():
    """Open while a dry run traces a step on ``meta`` tensors
    (``launch.dryrun``): the wrappers then send a ``meta`` tensor to their
    kernels' custom ops, whose shape functions run in place of the
    kernels."""
    _Tracing.depth += 1
    try:
        yield
    finally:
        _Tracing.depth -= 1


def takes_kernel(t: torch.Tensor) -> bool:
    """Whether a wrapper sends ``t`` to its kernel's custom op: a CUDA
    tensor, or a dry run's ``meta`` stand-in (under ``tracing``). A
    ``meta`` tensor outside a dry run takes neither the op nor the plain
    version."""
    return t.device.type == "cuda" or (t.device.type == "meta"
                                       and bool(_Tracing.depth))
