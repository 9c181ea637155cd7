"""A whole run at the tiny size on the CPU: the result line's keys, the
modules it loads, and ``correct`` coming out false with the timed path
broken underneath (the card's checks are skipped here, nothing else)."""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest

from bench import harness
from bench.common import load_file
from conftest import ROOT

CELLS = ["sift128-churn", "glove100-search", "sift128-search",
         "glove100-filtered"]


def _run(root, cell, trace=False, seconds=0.6):
    return harness.run_cell(root, cell, 2**33 + 17, seconds, trace, "cpu",
                            log=lambda m: None)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(tiny_root, cell, trace):
    line = _run(tiny_root, cell, trace)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    if trace:
        keys.append("breakdown")
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(line["device"])
    assert list(line) == keys + ["checks"]
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    json.dumps(line)
    if not trace:
        assert "setup_s" in line["metrics"]
        assert "recall_at_10" in line["metrics"]


SCRIPT = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
from bench import harness
line = harness.run_cell({tiny!r}, {cell!r}, 5, 0.5, False, "cpu",
                        log=lambda m: None)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


@pytest.mark.parametrize("cell", ["sift128-churn", "glove100-filtered"])
def test_a_run_loads_no_jax_and_no_reference_package(tiny_root, cell):
    code = SCRIPT.format(root=str(ROOT), src=str(ROOT / "src"),
                         tiny=str(tiny_root), cell=cell)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    tops = set(eval(r.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops
    assert not tops & set(harness.FORBIDDEN), tops & set(harness.FORBIDDEN)


def test_without_a_card_the_run_prints_no_result(tiny_root):
    r = subprocess.run([sys.executable, str(ROOT / "bench" / "run.py"),
                        "--workload", "sift128-search", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tiny_root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


# -- faults planted in the timed path ---------------------------------------

def _in_window(monkeypatch, loop_cls, install):
    """Break the program only while the window runs."""
    real = loop_cls.window

    def window(self, seconds):
        install()
        return real(self, seconds)
    monkeypatch.setattr(loop_cls, "window", window)


def _unchanged_search(monkeypatch):
    import repro_torch.core.search as S
    real = S.search_layer

    def unchanged(params, index, Q, ep, layer, ef, max_steps=None,
                  allow=None):
        return real(params, index, Q, ep, layer, ef, max_steps=0,
                    allow=allow)
    return lambda: monkeypatch.setattr(S, "search_layer", unchanged)


def _answers_fault(monkeypatch, target, attr, kind):
    """Half of each batch left out, or one answer altered, where the
    answers are produced."""
    real = getattr(target, attr)

    def broken(*args, **kwargs):
        out = real(*args, **kwargs)
        labels, dists = out[0], out[-1]
        if isinstance(labels, np.ndarray):
            labels, dists = labels.copy(), dists.copy()
        else:
            labels, dists = labels.clone(), dists.clone()
        h = labels.shape[0] // 2
        if kind == "half":
            labels[h:] = -1
            dists[h:] = float("inf")
        else:
            labels[0, 0] = (labels[0, 0] + 1) % 4096
        return (labels, dists) if len(out) == 2 else (labels, out[1], dists)
    return lambda: monkeypatch.setattr(target, attr, broken)


def _unchanged_drain(monkeypatch):
    """The wave executor returns the index it was given, untouched."""
    import repro_torch.serving.update_queue as U
    return lambda: monkeypatch.setattr(
        U, "apply_plan", lambda params, index, *a, **k: index)


@pytest.mark.parametrize("cell", ["glove100-search", "sift128-search",
                                  "glove100-filtered", "sift128-churn"])
@pytest.mark.parametrize("fault", ["unchanged_step", "half_left_out",
                                   "answer_altered"])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, cell,
                                            fault):
    from repro_torch.api import VectorIndex
    import repro_torch.serving.batcher as batcher
    churn = cell == "sift128-churn"
    loop_cls = load_file(tiny_root, "loops", "open" if churn else "closed").Loop
    target, attr = ((batcher, "batch_knn") if churn
                    else (VectorIndex, "knn_query"))
    if fault == "unchanged_step":
        if cell == "glove100-filtered":
            pytest.skip("the exact tier takes no steps: one kernel call")
        install = (_unchanged_drain(monkeypatch) if churn
                   else _unchanged_search(monkeypatch))
    else:
        install = _answers_fault(monkeypatch, target, attr,
                                 "half" if fault == "half_left_out"
                                 else "alter")
    _in_window(monkeypatch, loop_cls, install)
    line = _run(tiny_root, cell)
    assert line["correct"] is False, line["checks"]
