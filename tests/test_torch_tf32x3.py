"""The arithmetic of the port's contraction kernels, emulated on the CPU.

``topk_dist.cu`` and ``l2dist.cu`` compute q.y for f32 inputs on the tensor
cores as 3xTF32 (``kernels/_csrc/contract.cuh``): each operand x splits into
hi = x rounded to TF32 (to nearest, ties away from zero, as ``cvt.rna``) and
lo = x - hi, itself rounded to TF32; lo*hi + hi*lo + hi*hi replace the one
product, a k-step of 8 columns at a time, and each 32-column slice's sum is
added to the running dot product in f32. The CUDA kernels run only on the
card; this file emulates the same arithmetic in plain torch and holds it to
the JAX reference's oracles, at 1e-4 relative and absolute with ids equal up
to ties at the k-th distance, as the kernels are held on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.l2dist.ref import l2dist_ref as j_l2dist_ref
from repro.kernels.topk_dist.ref import topk_dist_ref as j_topk_ref

from repro_torch.kernels._build import rows16

TOL = 1e-4
SLICE = 32   # f32 columns in one 128-byte slice


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32: + half a TF32 ulp on the magnitude, then drop the
    13 low mantissa bits (what the kernel does with integer ops)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _step_columns(d: int):
    """The kernel's k order: slice c0, k-step s covers the 8 columns
    c0 + 8 t + 2 s + {0, 1}, t < 4 (each lane reads 32 contiguous bytes)."""
    for c0 in range(0, d, SLICE):
        yield [[c0 + 8 * t + 2 * s + u for t in range(4) for u in (0, 1)
                if c0 + 8 * t + 2 * s + u < d] for s in range(4)]


def dot_3xtf32(Q: torch.Tensor, Y: torch.Tensor, products=3):
    """q.y as the kernel sums it (``products=1`` keeps hi*hi alone: plain
    TF32)."""
    qh, ql = _split(Q.float())
    yh, yl = _split(Y.float())
    dot = torch.zeros((Q.shape[0], Y.shape[0]), dtype=torch.float32)
    for steps in _step_columns(Q.shape[1]):
        acc = torch.zeros_like(dot)
        for cols in steps:
            if not cols:
                continue
            if products == 3:
                acc = acc + ql[:, cols] @ yh[:, cols].T
                acc = acc + qh[:, cols] @ yl[:, cols].T
            acc = acc + qh[:, cols] @ yh[:, cols].T
        dot = dot + acc
    return dot


def dist_3xtf32(Q, Y, metric, products=3):
    dot = dot_3xtf32(Q, Y, products)
    if metric == "ip":
        return 1.0 - dot
    qq = torch.sum(Q * Q, dim=-1, keepdim=True)
    yy = torch.sum(Y * Y, dim=-1)[None, :]
    return torch.clamp_min(qq + yy - 2.0 * dot, 0.0)


def topk_3xtf32(Q, Y, k, metric="l2", mask=None):
    """The kernel's selection on the emulated distances: ascending by
    (distance, id), masked rows never enter, unfilled slots (inf, -1)."""
    D = dist_3xtf32(Q, Y, metric)
    if mask is not None:
        D = torch.where(torch.as_tensor(mask)[None, :], D, float("inf"))
    srt = torch.sort(D, dim=1, stable=True)
    kk = min(k, Y.shape[0])
    d = torch.full((Q.shape[0], k), float("inf"))
    i = torch.full((Q.shape[0], k), -1, dtype=torch.int32)
    d[:, :kk] = srt.values[:, :kk]
    i[:, :kk] = torch.where(torch.isinf(srt.values[:, :kk]), -1,
                            srt.indices[:, :kk].to(torch.int32))
    return d.numpy(), i.numpy()


def _same_up_to_ties(dv, iv, dr, ir, tol=TOL):
    np.testing.assert_allclose(dv, dr, rtol=tol, atol=tol)
    for r in range(dv.shape[0]):
        a = dict(zip(iv[r].tolist(), dv[r].tolist()))
        b = dict(zip(ir[r].tolist(), dr[r].tolist()))
        if a.keys() == b.keys():
            continue
        kth = dr[r][np.isfinite(dr[r])].max()
        for i in a.keys() ^ b.keys():
            assert abs(a.get(i, b.get(i)) - kth) <= tol * (1 + abs(kth)), r


def _check_topk(X, Y, k, metric, mask=None):
    dv, iv = topk_3xtf32(torch.from_numpy(X), torch.from_numpy(Y), k,
                         metric, mask)
    dr, ir = j_topk_ref(jnp.asarray(X), jnp.asarray(Y), k, metric=metric,
                        mask=None if mask is None else jnp.asarray(mask))
    _same_up_to_ties(dv, iv, np.asarray(dr), np.asarray(ir))
    return dv, iv


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("q,n,d,k", [(8, 600, 16, 10), (3, 1000, 32, 5),
                                     (16, 100, 8, 100), (1, 2048, 64, 1),
                                     (5, 300, 960, 7), (9, 400, 7, 12)])
def test_topk_emulation_matches_the_oracle(q, n, d, k, metric, masked):
    rng = np.random.default_rng(q * 7 + n)
    X = rng.normal(size=(q, d)).astype(np.float32)
    Y = rng.normal(size=(n, d)).astype(np.float32)
    mask = rng.random(n) > 0.3 if masked else None
    _check_topk(X, Y, k, metric, mask)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("q,n,d", [(8, 16, 8), (100, 300, 48),
                                   (130, 513, 32), (1, 1000, 128),
                                   (257, 64, 7), (16, 200, 960)])
def test_l2dist_emulation_matches_the_oracle(q, n, d, metric):
    rng = np.random.default_rng(q * 1000 + n)
    X = rng.normal(size=(q, d)).astype(np.float32)
    Y = rng.normal(size=(n, d)).astype(np.float32)
    out = dist_3xtf32(torch.from_numpy(X), torch.from_numpy(Y), metric)
    ref = np.asarray(j_l2dist_ref(jnp.asarray(X), jnp.asarray(Y),
                                  metric=metric))
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_duplicate_rows_tie_to_the_lowest_id(metric):
    """Exact ties (identical rows) go to the lowest id, as in the oracle."""
    rng = np.random.default_rng(5)
    base = rng.normal(size=(40, 24)).astype(np.float32)
    Y = np.concatenate([base, base, base[:7]])        # every row repeated
    X = (base[:6] + 0.01 * rng.normal(size=(6, 24))).astype(np.float32)
    dv, iv = _check_topk(X, Y, 9, metric)
    for r in range(dv.shape[0]):
        for a in range(dv.shape[1] - 1):
            assert (dv[r, a], iv[r, a]) < (dv[r, a + 1], iv[r, a + 1])


def test_query_equal_to_a_row_is_at_distance_zero():
    rng = np.random.default_rng(6)
    Y = rng.normal(size=(500, 128)).astype(np.float32)
    X = Y[[3, 77, 499]].copy()
    dv, iv = _check_topk(X, Y, 4, "l2")
    np.testing.assert_array_equal(iv[:, 0], [3, 77, 499])
    assert (dv[:, 0] >= 0).all() and (dv[:, 0] <= TOL).all()


def test_large_norms_where_the_l2_form_cancels():
    """Rows of norm ~1e4 and queries ~3e3 from them: |q|^2 + |y|^2 ~ 2e8
    cancels 20-fold to distances ~1e7, where a few f32 ulps of the terms
    (ulp 16) stay near 1e-5 of the result. (At 200-fold cancellation two
    f32 evaluations differ by more than 1e-4. The "ip" form has no such
    terms; its q.y of ~1e8-sized products is as exact as any f32 sum, and
    two summation orders differ there by ~1 in results as small as ~1e4.)"""
    rng = np.random.default_rng(7)
    Y = (rng.normal(size=(300, 128)) * 1e4 / np.sqrt(128)).astype(np.float32)
    X = (Y[:8] + rng.normal(size=(8, 128)) * 3e3 / np.sqrt(128)).astype(
        np.float32)
    _check_topk(X, Y, 5, "l2")
    out = dist_3xtf32(torch.from_numpy(X), torch.from_numpy(Y), "l2")
    ref = np.asarray(j_l2dist_ref(jnp.asarray(X), jnp.asarray(Y)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL, atol=TOL)


def test_plain_tf32_would_not_hold_the_tolerance():
    """hi*hi alone (plain TF32, ~11 bits) misses 1e-4 where 3xTF32 holds
    it: why the kernels pay for three products."""
    rng = np.random.default_rng(8)
    X = torch.from_numpy(rng.normal(size=(16, 128)).astype(np.float32))
    Y = torch.from_numpy(rng.normal(size=(256, 128)).astype(np.float32))
    ref = np.asarray(j_l2dist_ref(jnp.asarray(X.numpy()),
                                  jnp.asarray(Y.numpy()), metric="ip"))
    three = dist_3xtf32(X, Y, "ip").numpy()
    one = dist_3xtf32(X, Y, "ip", products=1).numpy()
    np.testing.assert_allclose(three, ref, rtol=TOL, atol=TOL)
    assert not np.allclose(one, ref, rtol=TOL, atol=TOL)


def test_tf32_rounding_is_to_nearest_ties_away():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -(1.0 + 2 ** -11), 1.0 + 2 ** -12], dtype=torch.float32)
    np.testing.assert_array_equal(
        _tf32(x).numpy(),
        np.array([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -9, -(1.0 + 2 ** -10),
                  1.0], dtype=np.float32))
    hi, lo = _split(torch.tensor([np.pi], dtype=torch.float32))
    assert abs(float(hi + lo) - np.float32(np.pi)) <= 2 ** -21 * np.pi


@pytest.mark.parametrize("d,dtype,width", [(128, torch.float32, 128),
                                           (7, torch.float32, 8),
                                           (3, torch.float32, 4),
                                           (100, torch.bfloat16, 104),
                                           (960, torch.bfloat16, 960)])
def test_rows16_pads_rows_to_16_bytes(d, dtype, width):
    """The wrappers hand the kernels rows of a multiple of 16 bytes (TMA's
    stride rule); zero columns change no dot product and no norm."""
    rng = np.random.default_rng(d)
    X = torch.from_numpy(rng.normal(size=(5, d)).astype(np.float32)).to(dtype)
    Y = torch.from_numpy(rng.normal(size=(9, d)).astype(np.float32)).to(dtype)
    Xp, Yp = rows16(X, Y)
    assert Xp.shape == (5, width) and Yp.shape == (9, width)
    assert Xp.is_contiguous() and Xp.data_ptr() % 16 == 0
    assert torch.equal(Xp[:, :d], X) and not Xp[:, d:].any()
    assert torch.equal(Xp.float() @ Yp.float().T, X.float() @ Y.float().T)
    if width == d:
        assert Xp.data_ptr() == X.data_ptr()       # no copy when aligned
    Z = torch.zeros(33 * width + 1, dtype=dtype)[1:].view(33, width)
    (Zp,) = rows16(Z)
    assert Zp.data_ptr() % 16 == 0 and torch.equal(Zp, Z)
