"""Port vs reference: the plain ``l2dist`` against the JAX package's Pallas
kernel (interpret mode on the CPU) and its jnp oracle.

Tolerance 1e-4 (relative and absolute) for f32 and bf16 alike: both
packages widen the same bf16 values to f32 before any arithmetic (a
product of two bf16 values is exact in f32), so only the order of the f32
sums differs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import l2dist as j_l2dist
from repro.kernels.l2dist.ref import l2dist_ref as j_l2dist_ref

from repro_torch.kernels import l2dist
from repro_torch.kernels.l2dist import l2dist_ref

TOL = 1e-4
SHAPES = [(8, 16, 8), (100, 300, 48), (130, 513, 32), (1, 1000, 128),
          (257, 64, 7)]


def _inputs(q, n, d, dtype):
    rng = np.random.default_rng(q * 1000 + n)
    X = rng.normal(size=(q, d)).astype(np.float32)
    Y = rng.normal(size=(n, d)).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    return ((jnp.asarray(X, jdt), jnp.asarray(Y, jdt)),
            (torch.from_numpy(X).to(tdt), torch.from_numpy(Y).to(tdt)))


@pytest.mark.parametrize("q,n,d", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_plain_matches_pallas_and_oracle(q, n, d, dtype, metric):
    (jX, jY), (X, Y) = _inputs(q, n, d, dtype)
    out = l2dist(X, Y, metric=metric)
    assert out.dtype == torch.float32 and out.shape == (q, n)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(j_l2dist_ref(jX, jY, metric=metric)),
                               rtol=TOL, atol=TOL)
    pallas = np.asarray(j_l2dist(jX, jY, metric=metric))
    if metric == "l2":       # the Pallas body does not clamp at 0
        pallas = np.maximum(pallas, 0.0)
    np.testing.assert_allclose(out.numpy(), pallas, rtol=TOL, atol=TOL)


def test_l2_is_clamped_at_zero_like_the_oracle():
    """Identical rows give ||x||^2 + ||y||^2 - 2 x.y, which can round below
    0; the plain version clamps as the reference's oracle does."""
    rng = np.random.default_rng(3)
    X = (rng.normal(size=(64, 33)) * 30).astype(np.float32)
    out = l2dist(torch.from_numpy(X), torch.from_numpy(X)).numpy()
    assert (out >= 0).all()
    ref = np.asarray(j_l2dist_ref(jnp.asarray(X), jnp.asarray(X)))
    # the diagonal is 0 up to the rounding of norms of size ~3e4
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL * 1e3)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_gradient_matches_jax_grad_of_the_oracle(metric):
    rng = np.random.default_rng(0)
    Xn = rng.normal(size=(4, 8)).astype(np.float32)
    Yn = rng.normal(size=(6, 8)).astype(np.float32)
    X = torch.from_numpy(Xn).requires_grad_(True)
    Y = torch.from_numpy(Yn).requires_grad_(True)
    l2dist(X, Y, metric=metric, use_ref=True).sum().backward()
    gx, gy = jax.grad(lambda x, y: j_l2dist_ref(x, y, metric=metric).sum(),
                      argnums=(0, 1))(jnp.asarray(Xn), jnp.asarray(Yn))
    np.testing.assert_allclose(X.grad.numpy(), np.asarray(gx), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(Y.grad.numpy(), np.asarray(gy), rtol=1e-5,
                               atol=1e-6)


def test_cpu_calls_never_count_as_launches_and_import_builds_nothing():
    from repro_torch.kernels.l2dist.l2dist import LIBRARY
    assert LIBRARY.lib is None
    before = l2dist.launches
    l2dist(torch.zeros((2, 4)), torch.zeros((3, 4)))
    assert l2dist.launches == before


def test_wrapper_checks():
    with pytest.raises(ValueError, match="metric form"):
        l2dist(torch.zeros((2, 4)), torch.zeros((3, 4)), metric="cosine")
    with pytest.raises(ValueError, match="X\\[Q, d\\]"):
        l2dist(torch.zeros((2, 4)), torch.zeros((3, 5)))
    meta = torch.empty((2, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        l2dist(meta, torch.empty((3, 4), device="meta"))


def test_cuda_launcher_raises_without_a_gpu(monkeypatch):
    from repro_torch.kernels.l2dist.l2dist import LIBRARY, l2dist_cuda
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the kernel tests cover it")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(ValueError, match="CUDA tensors"):
        l2dist_cuda(torch.zeros((2, 4)), torch.zeros((3, 4)), "l2")
    with pytest.raises(RuntimeError, match="nvcc"):
        LIBRARY.get()
