"""``kernels.beam_expand`` on the CPU: the wrapper's plain path against the
lockstep search's expansion step as it was written inline in
``core/search.py``, on random graphs, and the wrapper's checks.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""
import pytest
import torch

from repro_torch.core.common import INF, INVALID
from repro_torch.core.metrics import (Metric, dist_point, get_metric,
                                      sqdist_pairwise)
from repro_torch.kernels.beam_expand import beam_expand

N, M0, D = 64, 16, 24


def _step_inline(space, Q, vectors, nbrs_l, cur, running, visited):
    """The expansion as ``core/search.py::_search_layer`` ran it inline."""
    N = visited.shape[1] - 1
    nb = nbrs_l[cur].long()                               # [B, M0]
    valid = (nb >= 0) & running[:, None]
    nc = nb.clamp_min(0)
    fresh = valid & ~visited.gather(1, nc)
    visited.scatter_(1, torch.where(valid, nc, N), True)

    nd = torch.where(fresh, dist_point(space, Q, vectors[nc]), INF)
    return nd, torch.where(fresh, nc, INVALID)


def _graph(case, dtype, seed=0):
    """A random step: neighbour rows, queries, the lanes' expanded rows,
    which lanes run, and flags ~30% set (column N, the sink, too)."""
    g = torch.Generator().manual_seed(seed)
    B = 1 if case == "one_lane" else 9
    vectors = torch.randn(N, D, generator=g).to(dtype)
    Q = torch.randn(B, D, generator=g).to(dtype)
    nbrs = torch.randint(0, N, (N, M0), generator=g, dtype=torch.int32)
    if case == "duplicates":
        nbrs[:, 1] = nbrs[:, 0]
        nbrs[:, 5:8] = nbrs[:, 4:5]
    if case == "padding":                 # upper-layer rows: M valid, -1 after
        nbrs[:, M0 // 2:] = -1
        nbrs[::3] = -1                    # and rows with no neighbour at all
    cur = torch.randint(0, N, (B,), generator=g)
    running = torch.ones(B, dtype=torch.bool)
    if case == "idle_lanes":
        running[::2] = False
    visited = torch.rand(B, N + 1, generator=g) < 0.3
    return Q, vectors, nbrs, cur, running, visited


@pytest.mark.parametrize("case", ["duplicates", "padding", "idle_lanes",
                                  "one_lane"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("space", ["l2", "ip"])
def test_plain_path_equals_the_inline_step(space, dtype, case):
    Q, vectors, nbrs, cur, running, visited = _graph(case, dtype)
    v_before = visited.clone()
    v_want = visited.clone()
    nd_want, ni_want = _step_inline(space, Q, vectors, nbrs, cur, running,
                                    v_want)
    before = beam_expand.launches
    nd, ni = beam_expand(get_metric(space), Q, vectors, nbrs, cur, running,
                         visited)
    assert beam_expand.launches == before        # the CPU launches nothing
    assert nd.dtype == torch.float32 and ni.dtype == torch.int64
    assert torch.equal(nd, nd_want) and torch.equal(ni, ni_want)
    assert torch.equal(visited[:, :N], v_want[:, :N])
    # what the kernel must keep: a slot is fresh on the flags as they stood,
    # every valid slot of a running lane ends set, an idle lane gets nothing
    nb = nbrs[cur].long()
    for b in range(Q.shape[0]):
        if not running[b]:
            assert bool(torch.isinf(nd[b]).all()) and bool((ni[b] < 0).all())
            assert torch.equal(visited[b, :N], v_before[b, :N])
            continue
        for s, j in enumerate(nb[b].tolist()):
            fresh = j >= 0 and not bool(v_before[b, j])
            assert int(ni[b, s]) == (j if fresh else INVALID)
            assert bool(torch.isfinite(nd[b, s])) == fresh
            assert j < 0 or bool(visited[b, j])


def test_duplicate_ids_are_fresh_twice():
    Q, vectors, nbrs, cur, running, visited = _graph("duplicates",
                                                     torch.float32)
    visited.zero_()
    nd, ni = beam_expand(get_metric("l2"), Q, vectors, nbrs, cur, running,
                         visited)
    assert torch.equal(ni[:, 0], ni[:, 1]) and bool((ni[:, 0] >= 0).all())
    assert torch.equal(nd[:, 0], nd[:, 1])


def test_a_space_without_kernel_form_takes_its_point_fn():
    """A registered space with no kernel form keeps the plain expression
    (its distance is known only to its ``point_fn``)."""
    Q, vectors, nbrs, cur, running, visited = _graph("padding",
                                                     torch.float32)
    v_want = visited.clone()
    nd_want, ni_want = _step_inline("l2", Q, vectors, nbrs, cur, running,
                                    v_want)
    l1 = Metric("l1-local", lambda q, X: (X - q.unsqueeze(-2)).abs().sum(-1),
                sqdist_pairwise)
    assert l1.kernel_form is None
    nd, ni = beam_expand(l1, Q, vectors, nbrs, cur, running, visited)
    assert torch.equal(ni, ni_want) and torch.equal(visited, v_want)
    fresh = ni >= 0
    l1_d = (vectors[ni.clamp_min(0)] - Q[:, None]).abs().sum(-1)
    assert torch.equal(nd[fresh], l1_d[fresh])
    assert bool(torch.isinf(nd[~fresh]).all())
    assert torch.equal(torch.isinf(nd), torch.isinf(nd_want))


def _inputs():
    return _graph("padding", torch.float32)


@pytest.mark.parametrize("which,bad", [
    (0, lambda t: t.int()),                       # integer queries
    (1, lambda t: t[0]),                          # rows of rank 1
    (2, lambda t: t.long()),                      # int64 neighbour rows
    (3, lambda t: t.int()),                       # int32 cur
    (4, lambda t: t.to(torch.uint8)),             # uint8 running
    (5, lambda t: t.to(torch.uint8)),             # uint8 flags
    (5, lambda t: t[:, :, None]),                 # flags of rank 3
])
def test_wrong_dtype_or_rank_raises(which, bad):
    args = list(_inputs())
    args[which] = bad(args[which])
    with pytest.raises(ValueError, match="beam_expand: .* must be"):
        beam_expand(get_metric("l2"), *args)


def test_shapes_that_disagree_raise():
    Q, vectors, nbrs, cur, running, visited = _inputs()
    with pytest.raises(ValueError, match="shapes disagree"):
        beam_expand(get_metric("l2"), Q[:, :-1], vectors, nbrs, cur,
                    running, visited)
    with pytest.raises(ValueError, match="shapes disagree"):
        beam_expand(get_metric("l2"), Q, vectors, nbrs, cur[:-1], running,
                    visited)


def test_a_device_neither_cpu_nor_cuda_raises():
    meta = [t.to("meta") for t in _inputs()]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        beam_expand(get_metric("l2"), *meta)
    mixed = list(_inputs())
    mixed[5] = mixed[5].to("meta")
    with pytest.raises(ValueError, match="several devices"):
        beam_expand(get_metric("l2"), *mixed)
