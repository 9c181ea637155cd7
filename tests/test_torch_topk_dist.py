"""The port's ``topk_dist`` (plain version on the CPU) vs the reference's
Pallas kernel in interpret mode and its jnp oracle."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import topk_dist as j_topk
from repro.kernels.topk_dist.ref import topk_dist_ref as j_topk_ref

from repro_torch.kernels.topk_dist import topk_dist, topk_dist_ref
from repro_torch.kernels.topk_dist.topk_dist import LIBRARY, topk_dist_cuda

TOL = 1e-4   # f32 distances; the libraries sum in different orders


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


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("q,n,d,k", [(8, 600, 16, 10), (3, 1000, 32, 5),
                                     (16, 100, 8, 100), (1, 2048, 64, 1)])
def test_plain_matches_reference(q, n, d, k, metric, masked):
    rng = np.random.default_rng(q * 7 + n)
    X = rng.normal(size=(q, d)).astype(np.float32)
    Y = rng.normal(size=(n, d)).astype(np.float32)
    mask = rng.random(n) > 0.3 if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    dv, iv = topk_dist(torch.from_numpy(X), torch.from_numpy(Y), k,
                       metric=metric, mask=tm)
    for fn in (j_topk, j_topk_ref):
        dr, ir = fn(jnp.asarray(X), jnp.asarray(Y), k, metric=metric, mask=jm)
        _same_up_to_ties(dv.numpy(), iv.numpy(), np.asarray(dr),
                         np.asarray(ir))
    assert dv.dtype == torch.float32 and iv.dtype == torch.int32


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_padding_when_fewer_than_k_eligible(metric):
    rng = np.random.default_rng(1)
    X = rng.normal(size=(4, 32)).astype(np.float32)
    Y = rng.normal(size=(500, 32)).astype(np.float32)
    mask = np.zeros(500, bool)
    mask[[5, 99, 250, 251, 499]] = True
    dv, iv = topk_dist(torch.from_numpy(X), torch.from_numpy(Y), 16,
                       metric=metric, mask=torch.from_numpy(mask))
    dr, ir = j_topk(jnp.asarray(X), jnp.asarray(Y), 16, metric=metric,
                    mask=jnp.asarray(mask))
    np.testing.assert_array_equal(iv[:, 5:].numpy(), -1)
    assert torch.isinf(dv[:, 5:]).all()
    np.testing.assert_array_equal(np.asarray(ir)[:, 5:], -1)
    _same_up_to_ties(dv.numpy(), iv.numpy(), np.asarray(dr), np.asarray(ir))


def test_empty_batch_and_empty_candidates():
    Y = torch.zeros((50, 8))
    d, i = topk_dist(torch.zeros((0, 8)), Y, 4)
    jd, ji = j_topk(jnp.zeros((0, 8)), jnp.zeros((50, 8)), 4)
    assert d.shape == tuple(jd.shape) == (0, 4)
    assert i.shape == tuple(ji.shape) == (0, 4)
    d, i = topk_dist(torch.zeros((3, 8)), torch.zeros((0, 8)), 4)
    assert torch.isinf(d).all() and (i == -1).all()


def test_ties_go_to_the_lowest_id():
    Y = torch.ones((10, 4))
    d, i = topk_dist_ref(torch.ones((1, 4)), Y, 3)
    assert i[0].tolist() == [0, 1, 2]


def test_kernel_module_imports_without_nvcc():
    assert LIBRARY.lib is None          # nothing built or loaded at import
    assert isinstance(topk_dist.launches, int)


def test_cpu_calls_never_count_as_launches():
    before = topk_dist.launches
    topk_dist(torch.zeros((2, 4)), torch.zeros((9, 4)), 3)
    assert topk_dist.launches == before


def test_no_quiet_cpu_compute_off_the_cpu():
    """A tensor that is not on the CPU never takes the plain version."""
    meta = torch.empty((2, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        topk_dist(meta, torch.empty((9, 4), device="meta"), 3)


def test_cuda_launcher_raises_without_a_gpu(monkeypatch):
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the kernel tests cover it")
    with pytest.raises(ValueError, match="CUDA tensors"):
        topk_dist_cuda(torch.zeros((2, 4)), torch.zeros((9, 4)), 3, "l2",
                       None)
    with pytest.raises(RuntimeError, match="nvcc"):
        LIBRARY.get()


@pytest.mark.parametrize("bad", [
    dict(metric="cosine"), dict(k=0), dict(mask=torch.ones(5, dtype=bool)),
    dict(Y=torch.zeros((9, 5)))])
def test_wrapper_rejects_bad_inputs(bad):
    args = dict(Q=torch.zeros((2, 4)), Y=torch.zeros((9, 4)), k=3)
    kw = {}
    for key, v in bad.items():
        (args if key in args else kw)[key] = v
    with pytest.raises(ValueError):
        topk_dist(args["Q"], args["Y"], args["k"], **kw)
