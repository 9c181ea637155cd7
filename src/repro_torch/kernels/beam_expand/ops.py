"""The ``beam_expand`` wrapper: checks and dispatch.

A CUDA tensor of a space with a ``kernel_form`` launches the hand-written
kernel (``beam_expand.py``) or raises; there is no fallback. A CPU tensor,
or a space with no kernel form (whose distance only its ``point_fn``
knows), takes the plain version (``ref.py``). The kernel is no custom op:
no dry run traces a search.
"""
from __future__ import annotations

import torch

from .beam_expand import DTYPES, MAX_DIM, MAX_SLOTS, beam_expand_cuda
from .ref import beam_expand_ref


def _check(Q, vectors, nbrs_l, cur, running, visited) -> None:
    named = {"Q": Q, "vectors": vectors, "nbrs_l": nbrs_l, "cur": cur,
             "running": running, "visited": visited}
    devices = {t.device for t in named.values()}
    if len(devices) != 1:
        raise ValueError(f"beam_expand inputs lie on several devices: "
                         f"{devices}")
    dev = Q.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"beam_expand runs on CUDA or CPU tensors, not "
                         f"{dev}")
    want = {"Q": (2, None), "vectors": (2, None),
            "nbrs_l": (2, torch.int32), "cur": (1, torch.int64),
            "running": (1, torch.bool), "visited": (2, torch.bool)}
    for name, (rank, dtype) in want.items():
        t = named[name]
        ok = t.is_floating_point() if dtype is None else t.dtype == dtype
        if t.dim() != rank or not ok:
            raise ValueError(
                f"beam_expand: {name} must be {rank}-D "
                f"{dtype or 'floating point'}, got {t.dtype} of shape "
                f"{tuple(t.shape)}")
    B = Q.shape[0]
    if (vectors.shape[1] != Q.shape[1] or nbrs_l.shape[0] != vectors.shape[0]
            or cur.shape[0] != B or running.shape[0] != B
            or visited.shape[0] != B or visited.shape[1] < 1):
        raise ValueError(
            f"beam_expand shapes disagree: Q {tuple(Q.shape)}, vectors "
            f"{tuple(vectors.shape)}, nbrs_l {tuple(nbrs_l.shape)}, cur "
            f"{tuple(cur.shape)}, running {tuple(running.shape)}, visited "
            f"{tuple(visited.shape)}")


def beam_expand(metric, Q: torch.Tensor, vectors: torch.Tensor,
                nbrs_l: torch.Tensor, cur: torch.Tensor,
                running: torch.Tensor, visited: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One expansion step of the lockstep beam search.

    Each running lane ``b`` expands row ``cur[b]`` of ``nbrs_l[N, M0]``
    (int32, ``-1`` padding): a slot is fresh when valid and not yet set in
    ``visited[b]`` (``[B, N + 1]`` bool, judged before this step's writes),
    and every valid slot is then set. Returns ``(nd[B, M0] f32,
    ni[B, M0] i64)``: the ``metric``'s point distance from ``Q[b]`` to the
    slot's row of ``vectors[N, d]`` and the slot's id where fresh,
    ``(inf, -1)`` elsewhere; a lane not running reads and sets nothing.
    ``metric`` is a ``core.metrics.Metric``.
    """
    _check(Q, vectors, nbrs_l, cur, running, visited)
    form = metric.kernel_form
    if Q.device.type == "cpu" or form is None:
        return beam_expand_ref(metric.point_fn, Q, vectors, nbrs_l, cur,
                               running, visited)
    if Q.dtype not in DTYPES or vectors.dtype not in DTYPES:
        raise TypeError(f"beam_expand kernel takes float32, bfloat16 or "
                        f"float16 queries and rows, got {Q.dtype} and "
                        f"{vectors.dtype}")
    if not all(t.is_contiguous() for t in (Q, vectors, nbrs_l, cur, running,
                                           visited)):
        raise ValueError("beam_expand kernel takes contiguous tensors")
    if nbrs_l.shape[1] > MAX_SLOTS or Q.shape[1] > MAX_DIM:
        raise ValueError(f"beam_expand kernel takes M0 <= {MAX_SLOTS} and "
                         f"d <= {MAX_DIM}, got {nbrs_l.shape[1]} and "
                         f"{Q.shape[1]}")
    out = beam_expand_cuda(form, Q, vectors, nbrs_l, cur, running, visited)
    beam_expand.launches += 1
    return out


#: kernel launches so far (CUDA calls only; reset it to 0 to count a run)
beam_expand.launches = 0
