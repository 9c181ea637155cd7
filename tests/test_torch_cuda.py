"""The port's CUDA kernels against their plain versions, on the card.

Imports neither JAX nor the reference package, so the file also runs on a
machine with a GPU and no JAX:

    python -m pytest -q --noconftest -m gpu tests/test_torch_cuda.py

Every test here needs a GPU and skips without one.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.count_flags import count_flags
from repro_torch.kernels.embed_bag import (EmbedBagFunction, embed_bag,
                                           embed_bag_backward_ref,
                                           embed_bag_ref)
from repro_torch.kernels.embed_bag.embed_bag import (embed_bag_cuda,
                                                     lane_layout, vector_loads)
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


def _ordered(dv, iv):
    """Every row strictly ascending by (distance, id) up to its padding."""
    d, i = dv.cpu().numpy(), iv.cpu().numpy()
    for r in range(d.shape[0]):
        fin = int(np.isfinite(d[r]).sum())
        assert np.isinf(d[r, fin:]).all() and (i[r, fin:] == -1).all(), r
        assert all((d[r, a], i[r, a]) < (d[r, a + 1], i[r, a + 1])
                   for a in range(fin - 1)), r


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("qdt,ydt", [(torch.float32, torch.bfloat16),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.float32)],
                         ids=["f32-bf16", "bf16-bf16", "f32-f32"])
def test_topk_dist_kernel_takes_bf16_and_any_k(cuda, metric, qdt, ydt):
    """The exact tier takes what the reference's kernel takes: a bf16 index
    (read as bf16, with f32 or bf16 queries) and any k, up to past N. The
    plain version widens both to f32, as the reference does; a bf16 value
    widens exactly, so only the order of the f32 sums differs. Duplicate
    rows make exact ties, which go to the lowest id in both routes (k <=
    128 streams; k > 128 forms distance rows and radix-selects)."""
    rng = np.random.default_rng(17)
    base = _rand(rng, 700, 72, device=cuda)
    Y = torch.cat([base, base[:100], base]).to(ydt)     # 1,500 rows, ties
    n = Y.shape[0]
    Q = (base[:70] + 0.5 * _rand(rng, 70, 72, device=cuda)).to(qdt)
    mask = torch.tensor(rng.random(n) > 0.3, device=cuda)
    for k in (1, 10, 128, 129, 1000, n, n + 5):
        for m in (None, mask):
            before = topk_dist.launches
            dv, iv = topk_dist(Q, Y, k, metric=metric, mask=m)
            torch.cuda.synchronize()
            assert topk_dist.launches == before + 1
            dr, ir = topk_dist_ref(Q, Y, k, metric=metric, mask=m)
            assert dv.shape == (70, k) and iv.dtype == torch.int32
            _check(dv, iv, dr, ir)
            _ordered(dv, iv)
            eligible = n if m is None else int(m.sum())
            assert bool((iv[:, min(k, eligible):] == -1).all()), k


@pytest.mark.gpu
@pytest.mark.parametrize("d", [8, 64, 72, 136])
@pytest.mark.parametrize("n", [1, 127, 129, 4099])
def test_topk_dist_kernel_bf16_at_the_edges(cuda, d, n):
    """A bf16 index across the 128-byte slices (64 values: Q padded to two
    f32 slices each) and the 128-row tiles, nq across the 64-query
    blocks, k on both routes."""
    rng = np.random.default_rng(d * 100_000 + n)
    Y = _rand(rng, n, d, device=cuda).to(torch.bfloat16)
    mask = torch.tensor(rng.random(n) > 0.3, device=cuda)
    for nq in (1, 65):
        Q = _rand(rng, nq, d, device=cuda)
        for k, metric, m in ((1, "l2", None), (10, "ip", mask),
                             (128, "l2", mask), (200, "ip", None),
                             (n + 1, "l2", mask)):
            dv, iv = topk_dist(Q, Y, k, metric=metric, mask=m)
            torch.cuda.synchronize()
            dr, ir = topk_dist_ref(Q, Y, k, metric=metric, mask=m)
            _check(dv, iv, dr, ir)
            _ordered(dv, iv)


@pytest.mark.gpu
def test_topk_dist_kernel_makes_no_f32_copy_of_a_bf16_index(cuda):
    """A bf16 index of 2^20 x 128 (256 MiB) is read as it is: a call
    allocates its outputs and a small f32 copy of the queries, never the
    512 MiB of an f32 index; the large-k route stays within its 256 MiB
    chunk of distance rows and sort buffers."""
    rng = np.random.default_rng(18)
    Y = torch.randn(1 << 20, 128, device=cuda).to(torch.bfloat16)
    Q = _rand(rng, 64, 128, device=cuda)
    torch.cuda.synchronize()
    for k, limit in ((10, 16 << 20), (300, (256 + 16) << 20)):
        torch.cuda.reset_peak_memory_stats(cuda)
        base = torch.cuda.memory_allocated(cuda)
        dv, iv = topk_dist(Q, Y, k)
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated(cuda) - base < limit, k
        dr, ir = topk_dist_ref(Q[:4], Y, k)
        _check(dv[:4], iv[:4], dr, ir)


@pytest.mark.gpu
def test_topk_dist_kernel_refuses_other_dtypes(cuda):
    Q = torch.randn(4, 16, device=cuda)
    Y = torch.randn(40, 16, device=cuda)
    for bad in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match=str(bad).split(".")[-1]):
            topk_dist(Q, Y.to(bad), 5)
        with pytest.raises(TypeError, match=str(bad).split(".")[-1]):
            topk_dist(Q.to(bad), Y, 5)


def _rand(rng, *shape, device, scale=1.0):
    return torch.tensor(rng.normal(size=shape) * scale, dtype=torch.float32,
                        device=device)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [3, 7, 100, 128, 960])
@pytest.mark.parametrize("n", [1, 127, 129, 4099])
def test_topk_dist_kernel_at_the_edges(cuda, d, n):
    """The edges of the kernel's tiling: d across the 128-byte slices (and
    rows padded to 16 bytes), N across the 128-row tiles, nq across the
    64-query blocks, k up to 128 (the register-list flush past 32)."""
    rng = np.random.default_rng(d * 10_000 + n)
    Y = _rand(rng, n, d, device=cuda)
    mask = torch.tensor(rng.random(n) > 0.3, device=cuda)
    for nq in (1, 65, 1000):
        Q = _rand(rng, nq, d, device=cuda)
        for k, metric, m in ((1, "l2", None), (10, "ip", mask),
                             (128, "l2", mask), (10, "l2", None)):
            dv, iv = topk_dist(Q, Y, k, metric=metric, mask=m)
            torch.cuda.synchronize()
            dr, ir = topk_dist_ref(Q, Y, k, metric=metric, mask=m)
            _check(dv, iv, dr, ir)
            assert bool((iv[torch.isinf(dv)] == -1).all())


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_topk_dist_kernel_all_masked_and_few_eligible(cuda, metric):
    rng = np.random.default_rng(11)
    Q, Y = _rand(rng, 70, 64, device=cuda), _rand(rng, 3000, 64, device=cuda)
    none = torch.zeros(3000, dtype=torch.bool, device=cuda)
    dv, iv = topk_dist(Q, Y, 10, metric=metric, mask=none)
    assert torch.isinf(dv).all() and (iv == -1).all()
    few = none.clone()
    few[[0, 1500, 2999]] = True
    dv, iv = topk_dist(Q, Y, 10, metric=metric, mask=few)
    dr, ir = topk_dist_ref(Q, Y, 10, metric=metric, mask=few)
    _check(dv, iv, dr, ir)
    assert (iv[:, 3:] == -1).all() and torch.isinf(dv[:, 3:]).all()
    assert set(iv[0, :3].tolist()) == {0, 1500, 2999}


@pytest.mark.gpu
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_topk_dist_kernel_ties_go_to_the_lowest_id(cuda, metric):
    """Duplicate rows give exact ties; the kernel orders by (dist, id)."""
    rng = np.random.default_rng(12)
    base = _rand(rng, 300, 128, device=cuda)
    Y = torch.cat([base, base, base[:77], base])        # rows 4 times over
    Q = base[:64] + 0.3 * _rand(rng, 64, 128, device=cuda)
    dv, iv = topk_dist(Q, Y, 12, metric=metric)
    dr, ir = topk_dist_ref(Q, Y, 12, metric=metric)
    _check(dv, iv, dr, ir)
    d, i = dv.cpu().numpy(), iv.cpu().numpy()
    for r in range(d.shape[0]):
        assert all((d[r, a], i[r, a]) < (d[r, a + 1], i[r, a + 1])
                   for a in range(d.shape[1] - 1))


@pytest.mark.gpu
def test_topk_dist_kernel_query_equal_to_a_row(cuda):
    rng = np.random.default_rng(13)
    Y = _rand(rng, 5000, 128, device=cuda)
    rows = [3, 777, 4999]
    dv, iv = topk_dist(Y[rows].clone(), Y, 4)
    assert iv[:, 0].tolist() == rows
    assert bool((dv[:, 0] >= 0).all()) and bool((dv[:, 0] <= 1e-4).all())
    out = l2dist(Y[rows].clone(), Y)
    assert bool((out >= 0).all())
    assert bool((out[torch.arange(3), torch.tensor(rows)] <= 1e-4).all())


@pytest.mark.gpu
def test_kernels_where_the_l2_form_cancels(cuda):
    """Rows of norm ~1e4, queries ~3e3 from them: |q|^2 + |y|^2 ~ 2e8
    cancels 20-fold to distances ~1e7, where a few f32 ulps of the terms
    (ulp 16) stay near 1e-5 of the result. (At 200-fold, distances ~1e6,
    two f32 evaluations differ by more than 1e-4: the kernel and the plain
    version do on the H100, whatever the accumulation order.)"""
    rng = np.random.default_rng(14)
    Y = _rand(rng, 4099, 128, device=cuda, scale=1e4 / np.sqrt(128))
    Q = Y[:65] + _rand(rng, 65, 128, device=cuda, scale=3e3 / np.sqrt(128))
    dv, iv = topk_dist(Q, Y, 10)
    dr, ir = topk_dist_ref(Q, Y, 10)
    _check(dv, iv, dr, ir)
    np.testing.assert_allclose(l2dist(Q, Y).cpu().numpy(),
                               l2dist_ref(Q, Y).cpu().numpy(),
                               rtol=1e-4, atol=1e-4)


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


@pytest.mark.gpu
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "published"])
def test_wide_deep_forward_on_the_kernel_matches_the_plain_bag(cuda, smoke):
    """wide-deep's bag launches ``embed_bag`` on the card; the same forward
    with the plain bag agrees to 1e-4 (f32 sums in another order)."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import recsys_batch
    from repro_torch.models import recsys
    cfg = (get_smoke_config if smoke else get_config)("wide-deep")
    params = recsys.init_params(cfg, seed=0, device=cuda)
    batch = recsys.batch_to(recsys_batch(cfg, 512, 1), cuda)
    before = embed_bag.launches
    with torch.inference_mode():
        logit, user = recsys.forward(cfg, params, batch)
        assert embed_bag.launches == before + 1
        rl, ru = recsys.forward(cfg, params, batch, bag=embed_bag_ref)
    assert embed_bag.launches == before + 1
    torch.testing.assert_close(logit, rl, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(user, ru, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l", [1, 32, 33, 70])
@pytest.mark.parametrize("d", [7, 8, 16, 32, 64, 128, 260])
def test_embed_bag_kernel_lane_groups(cuda, d, l, dtype):
    """The redesigned kernel at every lane-group layout: D from one value a
    lane (D = 7) through 2-32 lanes a row to several column passes (D =
    260), bags within, at and past one 32-id chunk; an all-padding bag and
    ids at or past V contribute nothing; two runs give the same bits."""
    v, b = 3000, 37
    rng = np.random.default_rng(d * 100 + l)
    tab = torch.tensor(rng.normal(size=(v, d)), dtype=dtype, device=cuda)
    idx = rng.integers(-1, v + 50, size=(b, l)).astype(np.int32)
    idx[0] = -1
    idx[1] = v + 7
    idx = torch.tensor(idx, device=cuda)
    lay = lane_layout(tab)
    per = 16 // tab.element_size()
    assert lay["values_per_lane"] == (per if d % per == 0 else 1)
    assert lay["lanes_per_row"] * lay["rows_per_load"] == 32
    for mode in ("sum", "mean"):
        out = embed_bag(tab, idx, mode)
        again = embed_bag(tab, idx, mode)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        ref = embed_bag_ref(tab, idx, mode)
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)
        assert bool((out[:2] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 32, 128])
def test_embed_bag_kernel_unaligned_table_view(cuda, d, dtype):
    """A contiguous table view that starts one value into its storage is
    not 16-byte aligned: the launcher takes one value a lane, and the
    answer is the same function."""
    v = 500
    rng = np.random.default_rng(d)
    flat = torch.tensor(rng.normal(size=v * d + 1), dtype=dtype, device=cuda)
    tab = flat[1:].view(v, d)
    assert tab.is_contiguous() and not vector_loads(tab)
    assert vector_loads(flat[:-1].view(v, d))
    idx = torch.tensor(rng.integers(-1, v, size=(64, 32)).astype(np.int32),
                       device=cuda)
    for mode in ("sum", "mean"):
        out = embed_bag(tab, idx, mode)
        ref = embed_bag_ref(tab, idx, mode)
        np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(
            out.cpu().numpy(),
            embed_bag(flat[:-1].view(v, d).clone().copy_(tab), idx,
                      mode).cpu().numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embed_bag_function_matches_autograd_through_the_plain_bag(
        cuda, mode, dtype, monkeypatch):
    """A CUDA table that requires grad goes through ``EmbedBagFunction``:
    the kernel forward (never the plain one) and the scatter-add backward.
    Forward and table gradient against autograd through ``embed_bag_ref``
    on the same CUDA tensors: 1e-4 in f32. A bf16 gradient is one bf16
    rounding of the f32 sums (2^-8 relative) from the f32 gradient, and the
    plain bag's autograd on the bf16 table accumulates in bf16, so it is
    held to n bf16 roundings (n = the most times one row is gathered)."""
    from repro_torch.kernels.embed_bag import ops
    v, d, b, l = 3000, 32, 257, 40
    rng = np.random.default_rng(b + (dtype == torch.bfloat16))
    tab = torch.tensor(rng.normal(size=(v, d)), dtype=dtype, device=cuda)
    idx = rng.integers(-1, v + 20, size=(b, l)).astype(np.int32)
    idx[0] = -1                                   # an all-padding bag
    idx[1] = 5                                    # one id l times
    idx[2, :10] = idx[3, :10] = 7                 # shared across bags
    idx = torch.tensor(idx, device=cuda)
    gout = torch.tensor(rng.normal(size=(b, d)), dtype=torch.float32,
                        device=cuda)

    def refuse(*a, **k):
        raise AssertionError("the plain forward was reached")
    t1 = tab.clone().requires_grad_()
    monkeypatch.setattr(ops, "embed_bag_ref", refuse)
    before = embed_bag.launches
    out = embed_bag(t1, idx, mode)
    assert embed_bag.launches == before + 1
    assert type(out.grad_fn).__name__ == "EmbedBagFunctionBackward"
    (out * gout).sum().backward()
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert embed_bag.launches == before + 1       # the backward launches none
    t2 = tab.clone().requires_grad_()
    ref = embed_bag_ref(t2, idx, mode)
    (ref * gout).sum().backward()
    torch.testing.assert_close(out.detach(), ref.detach(), rtol=1e-4,
                               atol=1e-4)
    assert t1.grad.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(t1.grad, t2.grad, rtol=1e-4, atol=1e-4)
    else:
        t32 = tab.float().requires_grad_()
        (embed_bag_ref(t32, idx, mode) * gout).sum().backward()
        torch.testing.assert_close(t1.grad.float(), t32.grad,
                                   rtol=2.0 ** -8, atol=1e-6)
        mag = embed_bag_backward_ref(gout.abs(), idx, v, torch.float32, mode)
        valid = idx[(idx >= 0) & (idx < v)].long()
        n = int(torch.bincount(valid, minlength=v).max())
        assert bool(((t2.grad.float() - t1.grad.float()).abs()
                     <= n * 2.0 ** -8 * mag + 1e-30).all())
    # rows no bag gathered get nothing; a direct kernel call still refuses
    hit = torch.zeros(v, dtype=torch.bool, device=cuda)
    hit[idx[(idx >= 0) & (idx < v)].long()] = True
    assert bool((t1.grad[~hit] == 0).all())
    with pytest.raises(RuntimeError, match="backward"):
        embed_bag_cuda(t1, idx, mode)
    assert EmbedBagFunction.apply(tab, idx, mode).shape == (b, d)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-moe-16b"])
@pytest.mark.parametrize("T", [1, 7, 64, 512])
def test_moe_dispatch_on_the_card_matches_the_per_expert_loop(cuda, arch, T):
    """``moe_ffn`` (the gather dispatch and batched expert products) on the
    card against ``moe_ffn_ref`` (a plain loop over the experts) at the
    smoke configs: f32 weights at 1e-5, bf16 at 2e-2; the dropped
    assignments counted alike; a 1 x 4 grid of the card (the sharded form)
    within bf16 rounding of the one-block call."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_grid
    from repro_torch.models import dist_ctx, transformer
    cfg = get_smoke_config(arch)
    params = transformer.init_params(cfg, seed=T, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(T)
    x = torch.randn(T, cfg.d_model, generator=gen, device=cuda)
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        lp = {k: (v[0] if k == "router" else v[0].to(dtype))
              for k, v in params["layers"].items()}
        xt = x.to(dtype)
        y, aux = transformer.moe_ffn(cfg, lp, xt)
        y2, aux2, dropped = transformer.moe_ffn_ref(cfg, lp, xt)
        assert y.device.type == "cuda" and y.dtype == dtype
        torch.testing.assert_close(y.float(), y2.float(), rtol=tol, atol=tol)
        torch.testing.assert_close(aux, aux2)
        keep = transformer._moe_route(cfg, lp["router"], xt,
                                      transformer.capacity(cfg, T))[2]
        assert dropped == int((~keep).sum())
        with dist_ctx.use_mesh(make_grid(1, 4)):
            y4, _ = transformer.moe_ffn(cfg, lp, xt)
        torch.testing.assert_close(y4.float(), y.float(), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("name,dt", [("topk_dist", torch.float32),
                                     ("topk_dist_large_k", torch.float32),
                                     ("topk_dist", torch.bfloat16),
                                     ("l2dist", torch.float32),
                                     ("l2dist", torch.bfloat16),
                                     ("embed_bag", torch.float32)])
def test_custom_op_matches_plain_and_its_fake(cuda, name, dt):
    """Each kernel's custom op (``torch.ops.repro_torch.<name>``) on the
    card equals its plain version, and its fake (on ``meta`` stand-ins in
    a dry run) gives the real outputs' shapes and dtypes."""
    from repro_torch.kernels._build import tracing
    g = torch.Generator(device=cuda).manual_seed(0)
    ops = torch.ops.repro_torch
    if name == "embed_bag":
        table = torch.randn(600, 16, device=cuda, generator=g)
        ids = torch.randint(-1, 600, (40, 12), device=cuda, generator=g)
        args, plain = (table, ids, "mean"), embed_bag_ref(table, ids, "mean")
        op = ops.embed_bag
    else:
        Q = torch.randn(8, 32, device=cuda, generator=g)
        Y = torch.randn(1000, 32, device=cuda, generator=g).to(dt)
        if name == "l2dist":
            args = (Q.to(dt), Y, "l2")
            plain, op = l2dist_ref(*args[:2], metric="l2"), ops.l2dist
        else:
            k = 200 if name.endswith("large_k") else 10
            args, op = (Q, Y, k, "l2", None), ops.topk_dist
            plain = topk_dist_ref(Q, Y, k, metric="l2")
    real = op(*args)
    if name.startswith("topk_dist"):
        _check(*real, *plain)
    else:
        torch.testing.assert_close(real, plain, rtol=1e-4, atol=1e-4)
    outs = real if isinstance(real, tuple) else (real,)
    with tracing():
        meta = op(*[torch.empty(a.shape, dtype=a.dtype, device="meta")
                    if isinstance(a, torch.Tensor) else a for a in args])
    meta = meta if isinstance(meta, tuple) else (meta,)
    assert [(t.shape, t.dtype) for t in meta] == [(t.shape, t.dtype)
                                                  for t in outs]


@pytest.mark.gpu
def test_real_wide_deep_step_counts_what_its_trace_counts(cuda):
    """One real train step of wide-deep (smoke config, 256 rows, the bag
    on ``embed_bag``) under the dry run's counting mode: its FLOPs equal
    the trace's on ``meta`` stand-ins."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import recsys_batch
    from repro_torch.launch import dryrun
    from repro_torch.models import get_api, recsys
    from repro_torch.train import adamw_init
    cfg = get_smoke_config("wide_deep")
    api = get_api(cfg)
    bundle = api.make_step(ShapeSpec("train_batch", "train", batch=256))
    params = api.init_params(seed=0, device=cuda)
    batch = recsys.batch_to(recsys_batch(cfg, 256, seed=0), cuda)
    args = [params, adamw_init(params), batch]
    shapes = dryrun.shapes_of(args)
    real = dryrun.count_step(bundle.fn, args)
    trace = dryrun.trace_step(bundle.fn, shapes)
    assert trace["cost"]["flops"] == real["cost"]["flops"]
    assert trace["cost"]["flops_by_family"] == \
        real["cost"]["flops_by_family"]
    assert real["cost"]["flops_by_family"]["embed_bag"] == \
        256 * cfg.bag_len * cfg.embed_dim


@pytest.mark.gpu
@pytest.mark.parametrize("rows,width,cols,offset", [
    (1, 1, 1, 0), (1, 5, 0, 0), (3, 17, 16, 0), (5, 33, 20, 3),
    (1000, 1025, 1024, 0), (4096, 4097, 4096, 7), (257, 64, 61, 9)])
def test_count_flags_matches_a_plain_count(cuda, rows, width, cols, offset):
    """Any shape, any excluded columns, and flags that start off a 16-byte
    boundary (``offset``), against the plain version; one launch."""
    g = torch.Generator(device=cuda).manual_seed(rows * width + offset)
    flat = torch.rand(rows * width + offset, device=cuda, generator=g) < 0.3
    flags = flat[offset:].view(rows, width)
    before = count_flags.launches
    got = count_flags(flags, cols)
    assert count_flags.launches == before + 1
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == int(flags[:, :cols].sum())


@pytest.mark.gpu
def test_count_flags_at_the_search_cells_shape(cuda):
    """The lockstep search's visited flags in the search cells: 32,768
    lanes x 262,145 (8.6 GB, column 262,144 the uncounted sink, set in
    every third lane), against a plain count taken 1,024 lanes at a time."""
    B, N = 32_768, 262_144
    g = torch.Generator(device=cuda).manual_seed(5)
    v = torch.empty((B, N + 1), dtype=torch.bool, device=cuda)
    for i in range(0, B, 1024):
        v[i:i + 1024] = torch.rand((1024, N + 1), device=cuda,
                                   generator=g) < 0.01
    v[::3, N] = True
    want = sum(int(v[i:i + 1024, :N].sum()) for i in range(0, B, 1024))
    got = int(count_flags(v, N))
    del v
    torch.cuda.empty_cache()
    assert got == want


def _expand_inputs(B, N, M0, d, xdt, qdt, dev, seed=0, share=0.3,
                   offset=0):
    """One random expansion step: rows (``offset`` elements past an
    aligned start), queries, neighbour rows with ~10% padding and a
    repeated id in every row, the lanes' expanded rows, ~90% of the lanes
    running, and flags ``share`` set (made 1,024 lanes at a time)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randn(N * d + offset, device=dev, generator=g).to(xdt)
    vectors = flat[offset:].view(N, d)
    Q = torch.randn(B, d, device=dev, generator=g).to(qdt)
    nbrs = torch.randint(0, N, (N, M0), device=dev, generator=g,
                         dtype=torch.int32)
    nbrs[torch.rand(N, M0, device=dev, generator=g) < 0.1] = -1
    if M0 > 3:
        nbrs[:, 3] = nbrs[:, 2]
    cur = torch.randint(0, N, (B,), device=dev, generator=g)
    running = torch.rand(B, device=dev, generator=g) < 0.9
    visited = torch.empty((B, N + 1), dtype=torch.bool, device=dev)
    for i in range(0, B, 1024):
        visited[i:i + 1024] = torch.rand((min(1024, B - i), N + 1),
                                         device=dev, generator=g) < share
    return Q, vectors, nbrs, cur, running, visited


def _expand_against_plain(space, inputs, N):
    """The kernel against ``ref.py`` on the same inputs: ids and flags
    exact, distances within 1e-5 of the size of their terms (the sum runs
    in another order): relative for l2, whose terms are all positive, and
    relative to the sum of ``|x q|`` for ip, whose ``1 - x.q`` cancels."""
    from repro_torch.core.metrics import get_metric
    from repro_torch.kernels.beam_expand import beam_expand, beam_expand_ref
    Q, vectors, nbrs, cur, running, visited = inputs
    metric = get_metric(space)
    v_ref = visited.clone()
    nd_r, ni_r = beam_expand_ref(metric.point_fn, Q, vectors, nbrs, cur,
                                 running, v_ref)
    before = beam_expand.launches
    nd, ni = beam_expand(metric, Q, vectors, nbrs, cur, running, visited)
    assert beam_expand.launches == before + 1
    assert torch.equal(ni, ni_r)
    assert torch.equal(visited[:, :N], v_ref[:, :N])
    fresh = ni_r >= 0
    assert bool(torch.isinf(nd[~fresh]).all())
    rows = vectors[ni_r.clamp_min(0)].float()
    size = (nd_r if space == "l2" else
            1 + (rows * Q.float()[:, None]).abs().sum(-1))
    gap = (nd - nd_r).abs()
    assert bool((gap[fresh] <= 1e-5 * size[fresh]).all()), \
        float((gap[fresh] / size[fresh]).max())
    return int(fresh.sum())


@pytest.mark.gpu
@pytest.mark.parametrize("space,xdt,qdt", [
    ("l2", torch.float32, torch.float32), ("ip", torch.float32, torch.float32),
    ("l2", torch.bfloat16, torch.bfloat16),
    ("l2", torch.bfloat16, torch.float32),
    ("ip", torch.bfloat16, torch.bfloat16),
    ("l2", torch.float16, torch.float16), ("ip", torch.float16, torch.float16),
    ("l2", torch.float16, torch.bfloat16)],
    ids=["l2-f32", "ip-f32", "l2-bf16", "l2-bf16-rows-f32-queries",
         "ip-bf16", "l2-f16", "ip-f16", "l2-f16-rows-bf16-queries"])
@pytest.mark.parametrize("d,M0,offset", [
    (3, 8, 0), (7, 32, 1), (100, 32, 0), (128, 32, 0), (128, 32, 2),
    (960, 16, 0), (64, 128, 0), (8, 33, 0), (2048, 32, 1)])
def test_beam_expand_kernel_matches_plain(cuda, space, xdt, qdt, d, M0,
                                          offset):
    """Every load width (16, 8, 4 and 2 bytes: ``offset`` moves the rows off
    a 16-byte start), groups of 1 to 32 threads, rows longer than a warp's
    loads, up to 128 slots, lanes not running, repeated and padded slots."""
    N, B = 3000, 70
    inputs = _expand_inputs(B, N, M0, d, xdt, qdt, cuda, seed=d + M0,
                            offset=offset)
    assert _expand_against_plain(space, inputs, N) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("space,d,dt", [("l2", 128, torch.float32),
                                        ("ip", 100, torch.float32),
                                        ("l2", 128, torch.bfloat16)])
def test_beam_expand_at_the_search_cells_shape(cuda, space, d, dt):
    """32,768 lanes x 262,145 flags (8.6 GB), M0 32: sift's d 128 l2 and
    glove's d 100 ip in f32, and d 128 l2 in bf16."""
    B, N = 32_768, 262_144
    inputs = _expand_inputs(B, N, 32, d, dt, dt, cuda, share=0.01)
    try:
        assert _expand_against_plain(space, inputs, N) > B
    finally:
        del inputs
        torch.cuda.empty_cache()


@pytest.mark.gpu
def test_beam_expand_kernel_refuses_what_it_cannot_take(cuda):
    from repro_torch.core.metrics import get_metric
    from repro_torch.kernels.beam_expand import beam_expand
    Q, vectors, nbrs, cur, running, visited = _expand_inputs(
        4, 100, 8, 16, torch.float32, torch.float32, cuda)
    l2 = get_metric("l2")
    with pytest.raises(ValueError, match="contiguous"):
        beam_expand(l2, Q.t().contiguous().t(), vectors, nbrs, cur, running,
                    visited)
    with pytest.raises(ValueError, match="contiguous"):
        beam_expand(l2, Q, vectors, nbrs, cur, running,
                    visited.t().contiguous().t())
    with pytest.raises(TypeError, match="float32, bfloat16 or float16"):
        beam_expand(l2, Q.double(), vectors.double(), nbrs, cur, running,
                    visited)
    with pytest.raises(ValueError, match="several devices"):
        beam_expand(l2, Q.cpu(), vectors, nbrs, cur, running, visited)


@pytest.fixture(scope="module")
def graph_16k():
    """A 2^14-row l2 graph built on the card (M0 32, as the cells)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from repro_torch.core.batch_update import build_batch
    from repro_torch.core.index import HNSWParams
    params = HNSWParams(M=16, M0=32, num_layers=4, ef_construction=64,
                        ef_search=64, space="l2")
    rng = np.random.default_rng(3)
    centres = rng.normal(size=(32, 128))
    X = (centres[rng.integers(0, 32, 1 << 14)]
         + 0.3 * rng.normal(size=(1 << 14, 128))).astype(np.float32)
    index = build_batch(params, X, device="cuda")
    Q = (centres[rng.integers(0, 32, 2048)]
         + 0.3 * rng.normal(size=(2048, 128))).astype(np.float32)
    return params, index, torch.from_numpy(Q).cuda()


@pytest.mark.gpu
def test_beam_expand_launches_once_a_search_step(cuda, graph_16k):
    """Every step of a ``search_layer`` call on CUDA is one launch: the
    launches equal the steps its span counts, in ``batch_knn`` too."""
    from repro_torch.core import search, spans
    from repro_torch.kernels.beam_expand import beam_expand
    from repro_torch.serving.metrics import MetricsRegistry
    params, index, Q = graph_16k
    reg = MetricsRegistry()
    with spans.use(reg):
        before = beam_expand.launches
        ep = index.entry.long().expand(Q.shape[0]).clone()
        search.search_layer(params, index, Q, ep, 0, 64)
        steps = reg.spans("search.layer")[-1].attrs["steps"]
        assert steps > 0 and beam_expand.launches == before + steps
        before = beam_expand.launches
        search.batch_knn(params, index, Q, 10)
    steps = sum(s.attrs["steps"] for s in reg.spans("search.layer")[1:])
    assert beam_expand.launches == before + steps


@pytest.mark.gpu
def test_batch_knn_through_the_kernel_gives_the_plain_labels(
        cuda, graph_16k, monkeypatch):
    """``batch_knn`` through the kernel against the same search with the
    expansion in plain PyTorch (the l2 space registered without a kernel
    form): the same top-10 labels wherever the 10th and 11th distances
    differ by more than 1e-6 relative."""
    import dataclasses

    from repro_torch.core import metrics, search
    from repro_torch.kernels.beam_expand import beam_expand
    params, index, Q = graph_16k
    monkeypatch.setitem(metrics._METRICS, "l2-plain", dataclasses.replace(
        metrics.get_metric("l2"), name="l2-plain", kernel_form=None))
    plain_params = dataclasses.replace(params, space="l2-plain")
    before = beam_expand.launches
    lp, _, dp = search.batch_knn(plain_params, index, Q, 11)
    assert beam_expand.launches == before
    lk, _, dk = search.batch_knn(params, index, Q, 11)
    assert beam_expand.launches > before
    apart = (dp[:, 10] - dp[:, 9]) > 1e-6 * dp[:, 9].abs()
    assert int(apart.sum()) > 0.9 * Q.shape[0]
    torch.testing.assert_close(dk[apart, :10], dp[apart, :10], rtol=1e-5,
                               atol=1e-5)
    a = lk[apart, :10].sort(dim=1).values
    b = lp[apart, :10].sort(dim=1).values
    assert torch.equal(a, b)
