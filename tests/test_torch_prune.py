"""Port vs reference: the alpha-RNG neighbour selection on random pools."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.metrics import dist_point as j_point
from repro.core.prune import alpha_rng_select as j_alpha_rng_select
from repro.core.prune import select_neighbors as j_select

import repro_torch.core as T
from repro_torch.core.prune import alpha_rng_select, select_neighbors


def _pools(seed, A=12, C=40, d=8, space="l2"):
    """Random candidate pools with invalid slots and duplicate ids."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 60, size=(A, C)).astype(np.int32)
    ids[rng.random((A, C)) < 0.15] = -1
    table = rng.normal(size=(60, d)).astype(np.float32)
    q = rng.normal(size=(A, d)).astype(np.float32)
    vecs = table[np.clip(ids, 0, None)]
    dq = np.stack([np.asarray(j_point(space, jnp.asarray(q[a]),
                                      jnp.asarray(vecs[a]))) for a in range(A)])
    dq = np.where(ids >= 0, dq, np.inf).astype(np.float32)
    return q, ids, vecs, dq


@pytest.mark.parametrize("alpha", [1.0, 1.1])
@pytest.mark.parametrize("m_out", [4, 16])
@pytest.mark.parametrize("space", ["l2", "ip"])
def test_select_neighbors_same_ids(alpha, m_out, space):
    q, ids, vecs, dq = _pools(int(alpha * 10) + m_out, space=space)
    sel = jax.vmap(lambda a, b, c, e: j_select(a, b, c, e, m_out, alpha,
                                               space))
    r_ids, r_d = sel(jnp.asarray(q), jnp.asarray(ids), jnp.asarray(vecs),
                     jnp.asarray(dq))
    p_ids, p_d = select_neighbors(torch.from_numpy(q), torch.from_numpy(ids),
                                  torch.from_numpy(vecs), torch.from_numpy(dq),
                                  m_out, alpha, space)
    np.testing.assert_array_equal(p_ids.numpy(), np.asarray(r_ids))
    np.testing.assert_allclose(p_d.numpy(), np.asarray(r_d), rtol=0, atol=0)


@pytest.mark.parametrize("alpha", [1.0, 1.1])
def test_alpha_rng_select_same_ids(alpha):
    q, ids, vecs, dq = _pools(3, A=6, C=25)
    sel = jax.vmap(lambda b, e, c: j_alpha_rng_select(b, e, c, 8, alpha))
    r_ids, _ = sel(jnp.asarray(ids), jnp.asarray(dq), jnp.asarray(vecs))
    p_ids, _ = alpha_rng_select(torch.from_numpy(ids), torch.from_numpy(dq),
                                torch.from_numpy(vecs), 8, alpha)
    np.testing.assert_array_equal(p_ids.numpy(), np.asarray(r_ids))


def test_dedup_and_topk_helpers():
    ids = torch.tensor([[3, 1, 3, -1, 1, 2]])
    d = torch.tensor([[0.5, 0.1, 0.2, 9.0, 0.3, 0.4]])
    i2, d2 = T.common.dedup_ids(ids, d)
    assert i2.tolist() == [[3, 1, -1, -1, -1, 2]]
    assert torch.isinf(d2[0, 2]) and torch.isinf(d2[0, 4])
    ti, td = T.common.topk_by_distance(i2, d2, 3)
    assert ti.tolist() == [[1, 2, 3]]
    assert T.common.pow2_at_least(5) == 8 and T.common.pow2_at_least(0) == 1
    m = T.common.scatter_or(torch.zeros(5, dtype=torch.bool),
                            torch.tensor([1, 3, 9]),
                            torch.tensor([True, False, False]))
    assert m.tolist() == [False, True, False, False, False]
