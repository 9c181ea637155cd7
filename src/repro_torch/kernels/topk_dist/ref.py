"""Plain PyTorch version of ``topk_dist``: full distance matrix + top-k.

Mirrors the kernel's metric forms (``"l2"`` / ``"ip"``) and mask semantics:
masked-out candidates score ``+inf``, unfilled result slots return
``(inf, -1)``, and ties go to the lowest id (a stable sort). Chunked over
queries so that the ``[chunk, N]`` matrix fits at a million candidates.
"""
from __future__ import annotations

import torch

#: distance-matrix elements per query chunk (256 MiB of f32)
_CHUNK_ELEMS = 1 << 26


def topk_dist_ref(Q: torch.Tensor, Y: torch.Tensor, k: int, *,
                  metric: str = "l2", mask: torch.Tensor | None = None):
    """``(dists[q, k] f32, ids[q, k] i32)`` of the k nearest unmasked rows."""
    if metric not in ("l2", "ip"):
        raise ValueError(f"unsupported kernel metric form {metric!r}; "
                         "expected 'l2' or 'ip'")
    nq, N = Q.shape[0], Y.shape[0]
    Yf = Y.float()
    ny = torch.sum(Yf * Yf, dim=-1) if metric == "l2" else None
    ok = None if mask is None else (mask.reshape(-1) != 0)
    kk = min(k, N)
    out_d = torch.full((nq, k), float("inf"), dtype=torch.float32,
                       device=Q.device)
    out_i = torch.full((nq, k), -1, dtype=torch.int32, device=Q.device)
    step = max(1, _CHUNK_ELEMS // max(N, 1))
    for lo in range(0, nq, step):
        Qf = Q[lo:lo + step].float()
        qy = Qf @ Yf.T
        if metric == "l2":
            nq_ = torch.sum(Qf * Qf, dim=-1, keepdim=True)
            D = torch.clamp_min(nq_ + ny[None, :] - 2.0 * qy, 0.0)
        else:
            D = 1.0 - qy
        if ok is not None:
            D = torch.where(ok[None, :], D, float("inf"))
        srt = torch.sort(D, dim=1, stable=True)
        d = srt.values[:, :kk]
        i = srt.indices[:, :kk].to(torch.int32)
        out_d[lo:lo + step, :kk] = d
        out_i[lo:lo + step, :kk] = torch.where(torch.isinf(d), -1, i)
    return out_d, out_i
