"""The readers of the program's own spans, fed a fabricated registry and
window: each returns the number its docstring defines, and ``None`` when
its spans are missing, when the ring dropped a span in its window, or when
the program records no spans at all (as before they were added)."""
from __future__ import annotations

import math
from types import SimpleNamespace

import pytest
import torch

from bench.common import load_file
from bench.harness import Obs
from bench.reference.roofline import HBM_BYTES_PER_S
from conftest import ROOT

UNTRACED = {"t0": 100.0, "t1": 110.0, "window_s": 10.0, "updates": 50.0}
TRACED = {"t0": 200.0, "t1": 210.0, "window_s": 10.0}
CFG = {"M0": 32, "d": 128, "dtype": "float32"}


class FakeSpan:
    def __init__(self, name, t0, t1, parent=None, **attrs):
        self.name, self.t0, self.t1 = name, t0, t1
        self.parent, self.attrs = parent, attrs

    @property
    def seconds(self):
        return self.t1 - self.t0

    def under(self, name):
        p = self.parent
        while p is not None:
            if p.name == name:
                return True
            p = p.parent
        return False


class FakeRegistry:
    """What the readers use of ``MetricsRegistry``."""

    def __init__(self, rows=(), dropped=0, last_dropped_t0=-math.inf):
        self.rows = list(rows)
        self.spans_dropped = dropped
        self.last_dropped_t0 = last_dropped_t0

    def spans(self, name, t0=None, t1=None, under=None):
        return [s for s in self.rows if s.name == name
                and (t0 is None or s.t0 >= t0) and (t1 is None or s.t0 < t1)
                and (under is None or s.under(under))]


def _obs(reg, loop="closed", trace=None):
    owner = SimpleNamespace(metrics=reg)
    prog = SimpleNamespace(cfg=CFG, **{"vi" if loop == "closed"
                                       else "engine": owner})
    return Obs(setup_s=50.0, window=dict(UNTRACED), spans=None, trace=trace,
               counters={}, traced=dict(TRACED), program=prog)


def _read(name, obs):
    mod = load_file(ROOT, "metrics", name)
    assert getattr(mod, "PROGRAM", False)
    return mod.read(obs)


def _search_rows(t0, rows_visited=None):
    """Two knn batches starting at ``t0``: layer-0 beams of 100 and 140
    steps over 8 lanes, and a layer-1 span the readers must skip."""
    out = []
    for i, steps in enumerate((100, 140)):
        q = FakeSpan("index.knn_query", t0 + i, t0 + i + 0.5, q=8)
        out.append(q)
        extra = {} if rows_visited is None else {
            "rows_visited": torch.tensor(rows_visited[i])}
        out.append(FakeSpan("search.layer", t0 + i + 0.1, t0 + i + 0.4, q,
                            layer=0, lanes=8, ef=64, steps=steps, **extra))
        out.append(FakeSpan("search.layer", t0 + i + 0.05, t0 + i + 0.06, q,
                            layer=1, lanes=8, ef=64, steps=999, **extra))
    return out


def _wave_rows(t0, root_name):
    """Two drains (or builds) with the three timed phases of each wave."""
    out = []
    for i in range(2):
        root = FakeSpan(root_name, t0 + i, t0 + i + 0.9)
        wave = FakeSpan("wave", t0 + i + 0.1, t0 + i + 0.8, root, W=512,
                        tier="beam")
        out += [root, wave,
                FakeSpan("wave.repair", t0 + i + 0.1, t0 + i + 0.2, wave),
                FakeSpan("wave.candidates", t0 + i + 0.2, t0 + i + 0.5,
                         wave),
                FakeSpan("wave.commit", t0 + i + 0.5, t0 + i + 0.75, wave)]
    # the same phase outside the root: not counted
    out.append(FakeSpan("wave.candidates", t0 + 3, t0 + 8))
    return out


# -- each reader's number ----------------------------------------------------

def test_search_steps_per_batch():
    reg = FakeRegistry(_search_rows(101.0))
    assert _read("search_steps_per_batch.search", _obs(reg)) == 120.0


def test_search_fresh_pct():
    reg = FakeRegistry(_search_rows(201.0, rows_visited=(3000, 4000)))
    want = 100.0 * 7000 / ((100 + 140) * 8 * 32)
    assert _read("search_fresh_pct.search", _obs(reg)) == pytest.approx(want)


def test_search_roofline_pct():
    reg = FakeRegistry(_search_rows(201.0, rows_visited=(3000, 4000)))
    trace = {"per_span": {"knn_query": [(0.25, 9000), (0.35, 9100)]}}
    nbytes = 7000 * 128 * 4 + 16 * 128 * 4
    want = 100.0 * nbytes / HBM_BYTES_PER_S / 0.6
    got = _read("search_roofline_pct.search", _obs(reg, trace=trace))
    assert got == pytest.approx(want) and 0 < got < 100


@pytest.mark.parametrize("phase,want", [("candidates", 0.6),
                                        ("commit", 0.5)])
def test_build_phase_seconds(phase, want):
    reg = FakeRegistry(_wave_rows(10.0, "index.add_items"))
    assert _read(f"build_{phase}_s.search", _obs(reg)) == pytest.approx(want)


@pytest.mark.parametrize("phase,want", [("candidates", 600.0 / 50),
                                        ("repair", 200.0 / 50),
                                        ("commit", 500.0 / 50)])
def test_drain_phase_ms_per_update(phase, want):
    reg = FakeRegistry(_wave_rows(101.0, "scheduler.drain"))
    got = _read(f"drain_{phase}_ms_per_update.churn", _obs(reg, "open"))
    assert got == pytest.approx(want)


def test_serve_us_per_step():
    rows = []
    for i, steps in enumerate((50, 70)):
        b = FakeSpan("batcher.batch", 101.0 + i, 101.5 + i, rows=1024)
        rows += [b, FakeSpan("search.layer", 101.1 + i, 101.4 + i, b,
                             layer=0, lanes=1024, ef=64, steps=steps)]
    reg = FakeRegistry(rows)
    got = _read("serve_us_per_step.churn", _obs(reg, "open"))
    assert got == pytest.approx(1e6 * 0.6 / 120)


def test_filter_mask_ms_per_batch():
    rows = [FakeSpan("index.filter_mask", 101.0, 101.004),
            FakeSpan("index.filter_mask", 102.0, 102.006),
            FakeSpan("index.filter_mask", 50.0, 51.0)]      # set-up
    got = _read("filter_mask_ms_per_batch.filtered", _obs(FakeRegistry(rows)))
    assert got == pytest.approx(5.0)


# -- and None where there is nothing sound to read -----------------------------

CASES = [
    ("search_steps_per_batch.search", "closed",
     lambda: _search_rows(101.0), 101.5),
    ("search_fresh_pct.search", "closed",
     lambda: _search_rows(201.0, (3000, 4000)), 201.5),
    ("search_roofline_pct.search", "closed",
     lambda: _search_rows(201.0, (3000, 4000)), 201.5),
    ("build_candidates_s.search", "closed",
     lambda: _wave_rows(10.0, "index.add_items"), 10.5),
    ("build_commit_s.search", "closed",
     lambda: _wave_rows(10.0, "index.add_items"), 10.5),
    ("drain_candidates_ms_per_update.churn", "open",
     lambda: _wave_rows(101.0, "scheduler.drain"), 101.5),
    ("drain_repair_ms_per_update.churn", "open",
     lambda: _wave_rows(101.0, "scheduler.drain"), 101.5),
    ("drain_commit_ms_per_update.churn", "open",
     lambda: _wave_rows(101.0, "scheduler.drain"), 101.5),
    ("serve_us_per_step.churn", "open",
     lambda: [FakeSpan("search.layer", 101.1, 101.4,
                       FakeSpan("batcher.batch", 101.0, 101.5), layer=0,
                       lanes=4, ef=64, steps=10)], 101.5),
    ("filter_mask_ms_per_batch.filtered", "closed",
     lambda: [FakeSpan("index.filter_mask", 101.0, 101.004)], 101.5),
]
TRACE = {"per_span": {"knn_query": [(0.25, 9000), (0.35, 9100)]}}


@pytest.mark.parametrize("name,loop,rows,in_window", CASES,
                         ids=[c[0] for c in CASES])
def test_reads_the_fabricated_window(name, loop, rows, in_window):
    assert _read(name, _obs(FakeRegistry(rows()), loop, TRACE)) is not None


@pytest.mark.parametrize("name,loop,rows,in_window", CASES,
                         ids=[c[0] for c in CASES])
def test_none_without_spans(name, loop, rows, in_window):
    assert _read(name, _obs(FakeRegistry(), loop, TRACE)) is None


@pytest.mark.parametrize("name,loop,rows,in_window", CASES,
                         ids=[c[0] for c in CASES])
def test_none_when_the_ring_dropped_a_span_in_the_window(name, loop, rows,
                                                         in_window):
    reg = FakeRegistry(rows(), dropped=1, last_dropped_t0=in_window)
    assert _read(name, _obs(reg, loop, TRACE)) is None
    # a drop before the window leaves a window reader's spans whole
    if in_window > UNTRACED["t0"]:
        reg = FakeRegistry(rows(), dropped=1, last_dropped_t0=5.0)
        assert _read(name, _obs(reg, loop, TRACE)) is not None


@pytest.mark.parametrize("name,loop,rows,in_window", CASES,
                         ids=[c[0] for c in CASES])
def test_none_from_a_program_without_spans(name, loop, rows, in_window):
    class OldRegistry:          # counters, gauges, histograms and no spans
        spans_dropped = 0
    obs = _obs(OldRegistry(), loop, TRACE)
    assert _read(name, obs) is None
    obs.program = SimpleNamespace(cfg=CFG, vi=SimpleNamespace())
    assert _read(name, obs) is None


def test_search_readers_need_the_profiled_counts():
    """Untraced spans carry no ``rows_visited``: no share is read."""
    reg = FakeRegistry(_search_rows(201.0))
    for name in ("search_fresh_pct.search", "search_roofline_pct.search"):
        assert _read(name, _obs(reg, trace=TRACE)) is None
    reg = FakeRegistry(_search_rows(201.0, (3000, 4000)))
    assert _read("search_roofline_pct.search", _obs(reg)) is None
