"""The backup cell, ``sift128-churn-backup``: the plain reference of
dualSearch's merge held to hand-worked cases, the cell run at the tiny
size with rebuilds in its window, and ``correct`` coming out false with
the served merge broken underneath (half of each batch left out, one
answer altered, the live test removed). The card's case holds the control
and the planted fault to the cell's limits."""
from __future__ import annotations

import json

import pytest
import torch

from bench import harness
from bench.common import load_file
from bench.reference.dual import dual_merge, eligible
from conftest import ROOT, copy_bench
from test_bench_run import _answers_fault, _in_window

CELL = "sift128-churn-backup"
METRICS = ("backup_rebuild_ms_per_s.churn_backup",
           "dual_serve_us_per_query.churn_backup",
           "backup_hit_pct.churn_backup",
           "backup_dead_dropped_per_1k.churn_backup")

INF = float("inf")
MERGE_CASES = {
    # main's hits, backup's hits, live labels, expected labels (k = 3)
    "dead_backup_hit": (([1, 2, 3], [1.0, 4.0, 6.0]), ([9, 8, -1],
                        [0.5, 5.0, INF]), {1, 2, 3, 8}, [1, 2, 8]),
    "label_in_both": (([1, 2, 3], [1.0, 4.0, 6.0]), ([2, 7, -1],
                      [0.5, 2.0, INF]), {1, 2, 3, 7}, [1, 7, 2]),
    "slot_reused_under_new_label": (([50, 2, 3], [0.25, 4.0, 6.0]),
                                    ([5, 6, -1], [0.5, 1.5, INF]),
                                    {50, 2, 3, 6}, [50, 6, 2]),
    "fewer_than_k_eligible": (([1, -1, -1], [1.0, INF, INF]),
                              ([1, 4, -1], [1.0, 2.0, INF]), {1},
                              [1, -1, -1]),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_reference_merge_by_hand(case):
    (ml, md), (bl, bd), live, want = MERGE_CASES[case]
    args = [torch.tensor([x]) for x in (ml, md, bl, bd)]
    labels, dists = dual_merge(*args, live, 3)
    assert labels[0].tolist() == want
    assert min(3, *eligible(args[0], args[2], live)) == \
        sum(x >= 0 for x in want)
    assert torch.isinf(dists[0][labels[0] < 0]).all()
    assert torch.isfinite(dists[0][labels[0] >= 0]).all()


@pytest.fixture
def one_thread():
    """The tiny runs on one CPU thread: their rebuilds and dead backup hits
    need pumps inside the window, which several test workers each running
    every core's worth of threads slow past it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell(root=ROOT):
    man = json.loads((root / "BENCHMARK.json").read_text())
    return next(w for w in man["workloads"] if w["name"] == CELL)


def test_the_mix_applies_the_configurations_backup():
    """The deployment states its backup; the loop applies it from the
    mix's ``engine``, so the two have to agree."""
    w = _cell()
    cfg = json.loads((ROOT / "bench" / "configs"
                      / f"{w['config']}.json").read_text())
    eng = json.loads((ROOT / "bench" / "traffic"
                      / f"{w['traffic']}.json").read_text())["engine"]
    assert (eng["tau"], eng["backup_capacity"]) == \
        (cfg["backup"]["tau"], cfg["backup"]["capacity"])
    assert eng["tau"] > 0


def _rebuilding(root, tau=128):
    """The cell's mix at the tiny size with a small tau and backup. At 128
    the first rebuild falls in set-up's warm-up (two drains of 64
    replaces), then one every other pump, so that every window holds
    rebuilds; a larger tau leaves the backup holding more labels deleted
    since its rebuild (tau above the replaces of one drain)."""
    mix = _cell(root)["traffic"]
    p = root / "bench" / "traffic" / f"{mix}.json"
    tr = json.loads(p.read_text())
    tr["engine"].update(tau=tau, backup_capacity=256)
    p.write_text(json.dumps(tr))
    return root


def _run(root, trace=False, seconds=3.0):
    return harness.run_cell(root, CELL, 2**33 + 29, seconds, trace, "cpu",
                            log=lambda m: None)


def test_the_cell_runs_correct_with_rebuilds(tiny_root, one_thread):
    line = _run(_rebuilding(tiny_root), trace=True)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    got = line["metrics"]
    assert set(METRICS) <= set(got), sorted(got)
    assert got["backup_rebuild_ms_per_s.churn_backup"]["value"] > 0
    assert 0 < got["backup_hit_pct.churn_backup"]["value"] <= 100


def _unfiltered(monkeypatch):
    """dualSearch without the live test: every backup hit merged."""
    import repro_torch.core.backup as backup

    def all_live(main, bk, labels, ids):
        return torch.ones_like(labels, dtype=torch.bool)
    return lambda: monkeypatch.setattr(backup, "_live_hits", all_live)


@pytest.mark.parametrize("fault", ["half_left_out", "answer_altered",
                                   "live_test_removed"])
def test_a_broken_dual_search_is_not_correct(tiny_root, monkeypatch, fault,
                                            one_thread):
    import repro_torch.serving.batcher as batcher
    root = _rebuilding(tiny_root, tau=1024)
    loop_cls = load_file(root, "loops", "open").Loop
    if fault == "live_test_removed":
        install = _unfiltered(monkeypatch)
    else:
        install = _answers_fault(monkeypatch, batcher, "batch_dual_search",
                                 "half" if fault == "half_left_out"
                                 else "alter")
    _in_window(monkeypatch, loop_cls, install)
    line = _run(root, seconds=10.0)
    assert line["correct"] is False, line["checks"]
    if fault == "live_test_removed":
        assert line["checks"]["ineligible"]["value"] > 0, line["checks"]


@pytest.mark.gpu
def test_control_and_fault_fail_where_the_program_passes(cuda_device,
                                                         tmp_path):
    """On the card at 2^14 rows (the widths of ``sift128-backup``), as
    ``test_bench_gpu.py`` holds the other cells."""
    root = copy_bench(tmp_path)
    b = root / "bench"
    p = b / "configs" / f"{_cell()['config']}.json"
    cfg = json.loads(p.read_text())
    cfg["rows"] = 1 << 14
    p.write_text(json.dumps(cfg))
    for p in (b / "traffic").glob("churn_backup*.json"):
        tr = json.loads(p.read_text())
        tr.update(query_rate=2000, query_pool=8192)
        p.write_text(json.dumps(tr))
    line = harness.run_cell(root, CELL, 2**32 + 101, 3.0, False, cuda_device,
                            control=True, log=lambda m: None)
    assert line["correct"], line["checks"]
    lim = {n: c["limit"] for n, c in line["checks"].items()}
    for name, readings in line["control"].items():
        over = [n for n in lim if n in readings and readings[n] > lim[n]]
        assert over, (name, readings, lim)
