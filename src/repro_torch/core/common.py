"""Shared numeric utilities for the batched HNSW core.

Every function works on an explicit leading batch dimension where the JAX
reference used ``vmap``. Sorting is always stable, so ties keep index order
(the reference's ``jnp.argsort`` is stable too).
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

INF = float("inf")
INVALID = -1
#: the storage dtypes an index keeps as the caller gives them
STORAGE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def pow2_at_least(n: int) -> int:
    """Smallest power of two >= n (host-side; capacities are always pow2)."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def resolve_device(device) -> torch.device:
    """The device an entry point creates its state on.

    ``"cuda"`` (the default everywhere) raises when no GPU is present: the
    port never moves work to the CPU unless the caller asks for it.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch entry points default to device='cuda' "
                           "but no GPU is available; pass device='cpu' to run "
                           "on the CPU")
    return dev


def has_data(t: torch.Tensor) -> bool:
    """Whether ``t`` holds values: not a dry run's ``meta`` stand-in
    (``launch.dryrun``)."""
    return t.device.type != "meta"


def tensor_from_host(a, device="cpu") -> torch.Tensor:
    """A numpy array as a tensor on ``device``, bit for bit, in memory of
    its own: the port updates tensors in place (``adamw_update``), and a
    tensor that shared the caller's buffer would rewrite the caller's array
    (and a JAX array on the CPU that aliases it). A bf16 array reaches
    numpy as ``ml_dtypes.bfloat16`` (a JAX array's) or as 2-byte void
    (``np.load`` of such an array from an npz); ``torch.from_numpy`` takes
    neither, so the bits travel as int16 and are viewed as
    ``torch.bfloat16`` again."""
    a = np.asarray(a)
    if not a.flags.c_contiguous:
        a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                      and a.dtype.itemsize == 2):
        a = a.view(np.int16)
        to = torch.bfloat16
    else:
        to = None
    with warnings.catch_warnings():    # a read-only array is only read
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(a)
    if to is not None:
        t = t.view(to)
    return t.to(resolve_device(device), copy=True)


def host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array; bf16 as 2-byte void, the bits the
    reference's npz files hold for a bf16 array."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def storage_tensor(vectors, device="cpu") -> torch.Tensor:
    """``vectors[n, d]`` as an index stores them: in the caller's dtype when
    it is f32, bf16 or f16, as the reference keeps ``vectors.dtype``;
    float64 and non-float inputs as f32 (JAX, without x64, narrows float64
    to f32)."""
    X = (vectors if isinstance(vectors, torch.Tensor)
         else tensor_from_host(np.asarray(vectors)))
    if X.dtype not in STORAGE_DTYPES:
        X = X.float()
    return X.to(resolve_device(device))


def stable_argsort(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.sort(x, dim=dim, stable=True).indices


def dedup_ids(ids: torch.Tensor, dists: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Invalidate duplicate ids along the last axis of ``ids[..., C]``.

    Keeps the first occurrence in id-sorted order; duplicates become
    ``(-1, INF)``. Invalid (-1) entries stay invalid.
    """
    order = stable_argsort(ids)
    s = torch.gather(ids, -1, order)
    dup_sorted = torch.zeros_like(s, dtype=torch.bool)
    dup_sorted[..., 1:] = (s[..., 1:] == s[..., :-1]) & (s[..., 1:] >= 0)
    dup = torch.zeros_like(dup_sorted).scatter_(-1, order, dup_sorted)
    return (torch.where(dup, INVALID, ids),
            torch.where(dup, INF, dists))


def topk_by_distance(ids: torch.Tensor, dists: torch.Tensor, k: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort candidates ascending by distance (stable), return the first k."""
    order = stable_argsort(dists)[..., :k]
    return torch.gather(ids, -1, order), torch.gather(dists, -1, order)


def scatter_or(dst: torch.Tensor, idx: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """``dst[idx] |= valid`` for a bool vector, dropping invalid indices."""
    out = dst.clone()
    out[idx[valid]] = True
    return out


def nonzero_padded(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=fill)`` for a 1-D mask:
    the first ``size`` True positions in ascending order, padded with
    ``fill``."""
    idx = torch.nonzero(mask).reshape(-1)[:size].to(torch.int64)
    if idx.numel() < size:
        idx = torch.cat([idx, torch.full((size - idx.numel(),), fill,
                                         dtype=torch.int64,
                                         device=mask.device)])
    return idx
