"""The port's CUDA kernel against its plain version, on the card.

Imports neither JAX nor the reference package, so the file also runs on a
machine with a GPU and no JAX:

    python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

Every test here needs a GPU and skips without one.
"""
import numpy as np
import pytest
import torch

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
