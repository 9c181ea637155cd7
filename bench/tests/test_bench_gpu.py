"""On the card: each cell's control (the reference in TF32, in the
program's place) and the planted fault come out not correct, while the
program passes, at a size a test run can hold (2^14 rows at the
configurations' own widths, batches of 4,096). Run with
``python -m pytest -m gpu bench/tests`` on a machine with a card."""
from __future__ import annotations

import json

import pytest

from bench import harness
from conftest import copy_bench

CELLS = ["sift128-churn", "glove100-search", "sift128-search",
         "glove100-filtered"]


def _small(root):
    for p in (root / "bench" / "configs").glob("*.json"):
        cfg = json.loads(p.read_text())
        cfg["rows"] = 1 << 14
        p.write_text(json.dumps(cfg))
    for p in (root / "bench" / "traffic").glob("*.json"):
        tr = json.loads(p.read_text())
        if tr["loop"] == "closed":
            tr.update(batch=4096, pool_batches=2)
        else:
            tr.update(query_rate=2000, query_pool=8192)
        p.write_text(json.dumps(tr))


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_fault_fail_where_the_program_passes(cell, cuda_device,
                                                         tmp_path):
    root = copy_bench(tmp_path)
    _small(root)
    line = harness.run_cell(root, cell, 2**32 + 99, 3.0, False, cuda_device,
                            control=True, log=lambda m: None)
    assert line["correct"], line["checks"]
    lim = {n: c["limit"] for n, c in line["checks"].items()}
    for name, readings in line["control"].items():
        over = [n for n in lim if n in readings and readings[n] > lim[n]]
        assert over, (name, readings, lim)
