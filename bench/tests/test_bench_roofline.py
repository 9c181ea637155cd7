"""The roofline count of a masked ``topk_dist`` call depends only on the
shapes and on how many rows the mask allows."""
from __future__ import annotations

import numpy as np
import pytest

from bench.reference.roofline import (HBM_BYTES_PER_S, TF32X3_FLOPS,
                                      masked_topk_work)


def test_count_of_the_filtered_cell():
    w = masked_topk_work(32768, 262144, 4096, 100, 10)
    assert w.flops == 2 * 32768 * 4096 * 100
    assert w.bytes == 4096 * 100 * 4 + 32768 * 100 * 4 + 262144 \
        + 32768 * 10 * 8
    assert w.bound_by == "flops"
    assert w.least_s == pytest.approx(w.flops / TF32X3_FLOPS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_count_depends_on_the_allowed_count_not_on_which_rows(seed):
    rng = np.random.default_rng(seed)
    N = 4096
    masks = [np.zeros(N, bool) for _ in range(3)]
    for m in masks:
        m[rng.choice(N, 256, replace=False)] = True
    works = {masked_topk_work(64, N, int(m.sum()), 128, 10) for m in masks}
    assert len(works) == 1


def test_more_allowed_rows_need_more_work():
    a = masked_topk_work(64, 1 << 16, 1024, 128, 10)
    b = masked_topk_work(64, 1 << 16, 2048, 128, 10)
    assert b.flops == 2 * a.flops and b.bytes > a.bytes
    small = masked_topk_work(1, 1 << 20, 1 << 20, 128, 10)
    assert small.bound_by == "bytes"
    assert small.least_s == pytest.approx(small.bytes / HBM_BYTES_PER_S)
