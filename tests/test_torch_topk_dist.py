"""The port's ``topk_dist`` (plain version on the CPU) vs the reference's
Pallas kernel in interpret mode and its jnp oracle."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import topk_dist as j_topk
from repro.kernels.topk_dist.ref import topk_dist_ref as j_topk_ref

from repro_torch.kernels.topk_dist import topk_dist, topk_dist_ref
from repro_torch.kernels.topk_dist.topk_dist import (LARGE_K_SCRATCH,
                                                     LIBRARY, MAX_K,
                                                     large_k_chunk, operands,
                                                     topk_dist_cuda)

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


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("k", [10, MAX_K + 1, 1000])
@pytest.mark.parametrize("qdt", ["float32", "bfloat16"])
def test_plain_takes_bf16_and_any_k_as_the_reference(qdt, k, metric):
    """What the exact tier hands the kernel on a bf16 index: a bf16 Y (and
    f32 or bf16 queries), any k, past the eligible rows too (the oracle's
    ``lax.top_k`` takes k <= N). The reference's Pallas kernel
    (interpret mode, at k = 10: it merges k rounds a tile, minutes at k =
    1,000 on the CPU) and its jnp oracle widen both to f32; the plain
    version does the same, so they agree as on f32 inputs."""
    rng = np.random.default_rng(k)
    X = jnp.asarray(rng.normal(size=(5, 24)), getattr(jnp, qdt))
    Y = jnp.asarray(rng.normal(size=(1200, 24)), jnp.bfloat16)
    mask = rng.random(1200) > 0.3
    tX, tY = (torch.from_numpy(np.asarray(a, np.float32).copy()).to(
        getattr(torch, str(a.dtype))) for a in (X, Y))
    dv, iv = topk_dist(tX, tY, k, metric=metric, mask=torch.from_numpy(mask))
    for fn in (j_topk, j_topk_ref) if k <= 10 else (j_topk_ref,):
        dr, ir = fn(X, Y, k, metric=metric, mask=jnp.asarray(mask))
        _same_up_to_ties(dv.numpy(), iv.numpy(), np.asarray(dr),
                         np.asarray(ir))
    eligible = int(mask.sum())
    assert (iv[:, eligible:] == -1).all()
    assert torch.isinf(dv[:, eligible:]).all()


@pytest.mark.parametrize("d", [7, 8, 64, 72, 128])
def test_operands_read_a_bf16_index_as_it_is(d):
    """The launcher's operands: an f32 Y pads its rows and Q's to 16 bytes;
    a bf16 Y is handed over as it is when its rows are a multiple of 16
    bytes and aligned (no f32 copy of the index), and Q is widened to f32
    and zero-padded to a multiple of 64 columns (two f32 slices per bf16
    slice)."""
    Q = torch.randn(3, d)
    for Y in (torch.randn(50, d), torch.randn(50, d).bfloat16()):
        for q in (Q, Q.bfloat16()):
            q2, y2, dd, dq = operands(q, Y)
            assert q2.dtype == torch.float32 and y2.dtype == Y.dtype
            assert dd == y2.shape[1] and dq == q2.shape[1]
            per = 16 // Y.element_size()
            assert dd == -(-d // per) * per and y2.data_ptr() % 16 == 0
            assert dq == (dd if Y.dtype == torch.float32
                          else -(-dd // 64) * 64)
            assert torch.equal(q2[:, :d], q.float())
            assert not q2[:, d:].any() and not y2[:, d:].float().any()
            assert torch.equal(y2[:, :d], Y)
            if dd == d:
                assert y2.data_ptr() == Y.data_ptr()
    with pytest.raises(TypeError, match="float16"):
        operands(Q, torch.randn(5, d).half())
    with pytest.raises(TypeError, match="float64"):
        operands(Q.double(), torch.randn(5, d))


def test_large_k_chunk_bounds_the_scratch():
    for nq, N, kk in [(64, 1 << 20, 300), (1000, 65_536, 1000),
                      (3, 100, 100), (5000, 8192, 8192)]:
        ld = -(-N // 4) * 4
        rows = large_k_chunk(nq, ld, kk)
        assert 1 <= rows <= nq
        assert rows * (4 * ld + 8 * kk) <= LARGE_K_SCRATCH
        assert rows == nq or rows < 64 or rows % 64 == 0
