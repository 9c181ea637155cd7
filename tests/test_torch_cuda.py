"""The port's CUDA kernels against their plain versions, on the card.

Imports neither JAX nor the reference package, so the file also runs on a
machine with a GPU and no JAX:

    python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

Every test here needs a GPU and skips without one.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.embed_bag import embed_bag, embed_bag_ref
from repro_torch.kernels.l2dist import l2dist, l2dist_ref
from repro_torch.kernels.topk_dist import topk_dist, topk_dist_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check(dv, iv, dr, ir, tol=1e-4):
    """Distances within ``tol``; id sets equal except for ties at the k-th
    distance (the kernel and the plain version sum in different orders)."""
    dv, iv, dr, ir = (t.cpu().numpy() for t in (dv, iv, dr, ir))
    np.testing.assert_allclose(dv, dr, rtol=tol, atol=tol)
    for r in range(dv.shape[0]):
        a = dict(zip(iv[r].tolist(), dv[r].tolist()))
        b = dict(zip(ir[r].tolist(), dr[r].tolist()))
        if a.keys() == b.keys():
            continue
        kth = dr[r][np.isfinite(dr[r])].max()
        for i in a.keys() ^ b.keys():
            assert abs(a.get(i, b.get(i)) - kth) <= tol * (1 + abs(kth)), r


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("q,n,d,k", [(8, 600, 16, 10), (3, 1000, 32, 5),
                                     (16, 100, 8, 100), (1, 2048, 64, 1),
                                     (70, 5000, 960, 128), (200, 3000, 7, 17)])
def test_topk_dist_kernel_matches_plain(cuda, metric, q, n, d, k):
    rng = np.random.default_rng(q * 7 + n)
    Q = torch.tensor(rng.normal(size=(q, d)), dtype=torch.float32, device=cuda)
    Y = torch.tensor(rng.normal(size=(n, d)), dtype=torch.float32, device=cuda)
    mask = torch.tensor(rng.random(n) > 0.3, device=cuda)
    for m in (None, mask):
        dv, iv = topk_dist(Q, Y, k, metric=metric, mask=m)
        torch.cuda.synchronize()
        dr, ir = topk_dist_ref(Q, Y, k, metric=metric, mask=m)
        _check(dv, iv, dr, ir)


@pytest.mark.gpu
def test_topk_dist_kernel_pads_and_counts(cuda):
    rng = np.random.default_rng(0)
    Q = torch.tensor(rng.normal(size=(5, 24)), dtype=torch.float32, device=cuda)
    Y = torch.tensor(rng.normal(size=(300, 24)), dtype=torch.float32,
                     device=cuda)
    mask = torch.zeros(300, dtype=torch.bool, device=cuda)
    mask[[3, 77, 250]] = True
    before = topk_dist.launches
    dv, iv = topk_dist(Q, Y, 8, mask=mask)
    assert topk_dist.launches == before + 1
    assert torch.isinf(dv[:, 3:]).all() and (iv[:, 3:] == -1).all()
    assert set(iv[0, :3].tolist()) == {3, 77, 250}
    d0, i0 = topk_dist(Q[:0], Y, 8)
    assert d0.shape == (0, 8) and i0.shape == (0, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q,n,d", [(8, 16, 8), (100, 300, 48), (130, 513, 32),
                                   (1, 1000, 128), (257, 64, 7),
                                   (64, 4099, 960)])
def test_l2dist_kernel_matches_plain(cuda, metric, dtype, q, n, d):
    rng = np.random.default_rng(q * 1000 + n)
    X = torch.tensor(rng.normal(size=(q, d)), dtype=dtype, device=cuda)
    Y = torch.tensor(rng.normal(size=(n, d)), dtype=dtype, device=cuda)
    before = l2dist.launches
    out = l2dist(X, Y, metric=metric)
    torch.cuda.synchronize()
    assert l2dist.launches == before + 1
    ref = l2dist_ref(X, Y, metric=metric)
    # bf16 too: both versions widen the same bf16 values to f32 (their
    # products are exact in f32), so only the order of the f32 sums differs
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    if metric == "l2":
        assert bool((out >= 0).all())


@pytest.mark.gpu
def test_l2dist_kernel_refuses_grad_and_keeps_use_ref(cuda):
    X = torch.randn(4, 8, device=cuda, requires_grad=True)
    Y = torch.randn(6, 8, device=cuda)
    with pytest.raises(RuntimeError, match="backward"):
        l2dist(X, Y)
    l2dist(X, Y, use_ref=True).sum().backward()
    assert X.grad is not None and X.grad.shape == X.shape


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v,d,b,l", [(100, 8, 7, 4), (1000, 32, 37, 12),
                                     (513, 16, 8, 1), (2048, 64, 3, 33),
                                     (300, 7, 9, 70), (4000, 260, 5, 40)])
def test_embed_bag_kernel_matches_plain(cuda, mode, dtype, v, d, b, l):
    rng = np.random.default_rng(v + b)
    tab = torch.tensor(rng.normal(size=(v, d)), dtype=dtype, device=cuda)
    idx = rng.integers(-1, v, size=(b, l)).astype(np.int32)
    idx[0] = -1                                   # an all-padding bag
    idx = torch.tensor(idx, device=cuda)
    before = embed_bag.launches
    out = embed_bag(tab, idx, mode)
    torch.cuda.synchronize()
    assert embed_bag.launches == before + 1
    ref = embed_bag_ref(tab, idx, mode)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    assert bool((out[0] == 0).all())
