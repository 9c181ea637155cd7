"""Minimal E(3)-equivariant toolkit: real spherical harmonics (l <= 2),
numerically derived Wigner D matrices and real Clebsch-Gordan tensors, as
the reference's ``models/e3.py`` defines them.

Each CG tensor C of an admissible path (l1, l2 -> l3) is the
(one-dimensional) null space of the equivariance constraint

    sum_ij D1[i,i'] D2[j,j'] C[i,j,k] = sum_k' D3[k,k'] C[i',j',k']

stacked over eight random rotations, where each D_l is recovered from the
closed-form harmonics by least squares (Y_l(R u) = D_l(R) Y_l(u)); C is
normalised and its sign fixed by its largest entry. The constants are
numpy, computed once and cached; ``sh_torch`` evaluates the harmonics on
tensors.

Unlike the reference, ``real_cg`` draws its rotations from a generator of
its own (one fixed seed a call), and breaks a tie of largest magnitudes
(within 1e-4) by the first entry in flat order. The reference draws from
one module-level generator, so for the four paths whose largest entries
tie (1x1->1, 1x2->2, 2x1->2, 2x2->1) its sign depends on which calls came
first in the process (ROADMAP §3); the two agree on every other path, and
up to that sign on those four.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

_rng = np.random.default_rng(1234)
_CG_SEED = 1234
_SQRT3 = float(np.sqrt(3.0))


def sh(l: int, u: np.ndarray):
    """Real spherical harmonics basis (unnormalised, component-closed).

    u: [..., 3] UNIT vectors. Returns [..., 2l+1].
    """
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    if l == 0:
        return np.ones_like(x)[..., None]
    if l == 1:
        return np.stack([x, y, z], axis=-1)
    if l == 2:
        # orthonormal on the sphere (common scale): all components have
        # <Y^2> = 4/15, so the numeric Wigner D matrices come out orthogonal
        return np.stack([
            2 * x * y, 2 * y * z, (3 * z * z - 1.0) / np.sqrt(3.0), 2 * z * x,
            x * x - y * y,
        ], axis=-1)
    raise NotImplementedError(f"l={l}")


def sh_torch(l: int, u: torch.Tensor) -> torch.Tensor:
    """``sh`` on a tensor of unit vectors ``u [..., 3]``."""
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    if l == 0:
        return torch.ones_like(x)[..., None]
    if l == 1:
        return torch.stack([x, y, z], dim=-1)
    if l == 2:
        return torch.stack([
            2 * x * y, 2 * y * z, (3 * z * z - 1.0) / _SQRT3, 2 * z * x,
            x * x - y * y,
        ], dim=-1)
    raise NotImplementedError(f"l={l}")


def random_rotation(rng=None) -> np.ndarray:
    rng = rng or _rng
    A = rng.normal(size=(3, 3))
    Q, R = np.linalg.qr(A)
    Q = Q * np.sign(np.diag(R))
    if np.linalg.det(Q) < 0:
        Q[:, 0] = -Q[:, 0]
    return Q


def wigner_d(l: int, R: np.ndarray, rng=None) -> np.ndarray:
    """Numeric Wigner D in our real-SH basis: Y_l(R u) = D_l(R) @ Y_l(u)."""
    rng = rng or _rng
    n = 2 * l + 1
    K = 4 * n
    u = rng.normal(size=(K, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    A = sh(l, u)                       # [K, n]
    B = sh(l, u @ R.T)                 # [K, n]
    # B = A @ D^T  =>  D^T = lstsq(A, B)
    Dt, *_ = np.linalg.lstsq(A, B, rcond=None)
    return Dt.T


@functools.lru_cache(maxsize=None)
def real_cg(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real CG tensor C[(2l1+1), (2l2+1), (2l3+1)] for path l1 x l2 -> l3."""
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        raise ValueError(f"invalid triangle ({l1},{l2},{l3})")
    rng = np.random.default_rng(_CG_SEED)
    n1, n2, n3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    rows = []
    for _ in range(8):
        R = random_rotation(rng)
        D1, D2, D3 = (wigner_d(l, R, rng) for l in (l1, l2, l3))
        # A1[(i',j',k0),(i,j,k)] = D1[i,i'] D2[j,j'] delta(k,k0)
        A1 = np.einsum("ia,jb,kc->abcijk", D1, D2, np.eye(n3))
        # A2[(i',j',k0),(i,j,k)] = delta(i,i') delta(j,j') D3[k0,k]
        A2 = np.einsum("ai,bj,ck->abcijk", np.eye(n1), np.eye(n2), D3)
        rows.append((A1 - A2).reshape(n1 * n2 * n3, n1 * n2 * n3))
    M = np.concatenate(rows, axis=0)
    _, s, vt = np.linalg.svd(M)
    if int(np.sum(s < 1e-6 * max(s[0], 1.0))) < 1:
        raise RuntimeError(f"no equivariant map for ({l1},{l2},{l3})")
    C = vt[-1].reshape(n1, n2, n3)
    C /= np.linalg.norm(C)
    # deterministic sign: the first entry of (nearly) the largest magnitude
    flat = np.abs(C.reshape(-1))
    lead = C.reshape(-1)[np.argmax(flat >= flat.max() * (1 - 1e-4))]
    if lead < 0:
        C = -C
    return C.astype(np.float32)


def paths(l_max: int):
    """All admissible (l_in, l_f, l_out) triangles with every l <= l_max."""
    out = []
    for li in range(l_max + 1):
        for lf in range(l_max + 1):
            for lo in range(l_max + 1):
                if abs(li - lf) <= lo <= li + lf:
                    out.append((li, lf, lo))
    return out
