"""The program's spans: the registry's ring, nesting and self time, the
spans each layer records (and their counts), the profiler's ranges of the
same names, and the histogram's buckets."""
from __future__ import annotations

import importlib.util
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.core.search as S
from repro_torch import api
from repro_torch.core import spans
from repro_torch.core.batch_update import apply_update_batch_wave
from repro_torch.core.planner import PlannerConfig
from repro_torch.core.update import OP_DELETE, OP_REPLACE
from repro_torch.kernels.count_flags import count_flags
from repro_torch.serving.metrics import Histogram, MetricsRegistry

ROOT = Path(__file__).resolve().parents[1]


def _bench_nesting() -> tuple[str, ...]:
    """``bench/tracing.py``'s span names (loaded by path: no package)."""
    spec = importlib.util.spec_from_file_location(
        "bench_tracing_for_spans_test", ROOT / "bench" / "tracing.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    try:
        spec.loader.exec_module(mod)
    finally:
        del sys.modules[spec.name]
    return mod.NESTING


def _rows(n, d=8, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _index(n=600, d=8, **kw):
    """A small index whose planner still takes the graph tier."""
    vi = api.VectorIndex(space="l2", dim=d, capacity=1024, M=4, M0=8,
                         ef_construction=16, ef_search=16, device="cpu",
                         planner=PlannerConfig(small_live=64), **kw)
    vi.add_items(_rows(n, d))
    return vi


def _churned_pump(vi, n_updates=48, n_queries=20):
    eng = vi.serve(k=5, max_batch=32, max_ops_per_drain=128,
                   maintenance=api.MaintenancePolicy())
    X = _rows(n_updates + n_queries, vi.dim, seed=3)
    for q in X[:n_queries]:
        eng.search(q)
    for j in range(n_updates):
        eng.delete(j)
        eng.update(X[n_queries + j], 10_000 + j)
    eng.pump()
    return eng


# -- the registry -------------------------------------------------------------

def test_ring_keeps_its_cap_and_counts_what_it_drops():
    reg = MetricsRegistry(span_capacity=4)
    for i in range(7):
        with reg.span("a", i=i):
            pass
    kept = reg.spans("a")
    assert [s.attrs["i"] for s in kept] == [3, 4, 5, 6]
    assert reg.spans_dropped == 3
    assert reg.last_dropped_t0 <= kept[0].t0
    assert reg.last_dropped_t0 > -float("inf")


def test_capacity_zero_records_nothing():
    reg = MetricsRegistry(span_capacity=0)
    with spans.use(reg):
        with spans.span("a", x=1) as sp:
            sp.set(y=2)
            with spans.span("b"):
                pass
    assert reg.spans("a") == [] and reg.spans("b") == []
    assert reg.spans_dropped == 0 and reg.span_table() == {}
    assert "spans" not in reg.report()


def test_no_current_registry_is_a_no_op():
    assert spans._CURRENT.get() is None
    with spans.span("search.layer", layer=0) as sp:
        sp.set(steps=3)
        assert not sp.profiled


def test_parents_roots_and_self_time():
    reg = MetricsRegistry()
    with spans.use(reg):
        for _ in range(2):
            with spans.span("outer"):
                with spans.span("mid"):
                    time.sleep(0.002)
                    with spans.span("inner"):
                        time.sleep(0.003)
                with spans.span("mid"):
                    pass
                time.sleep(0.002)
    outer = reg.spans("outer")
    mids = reg.spans("mid")
    inner = reg.spans("inner")
    assert len(outer) == 2 and len(mids) == 4 and len(inner) == 2
    for o in outer:
        assert o.parent is None and o.root is o
    for m in mids:
        assert m.parent.name == "outer" and m.root is m.parent
    for i in inner:
        assert i.parent.name == "mid" and i.root.name == "outer"
        assert i.under("outer") and i.under("mid") and not i.under("inner")
        assert i.parent.t0 <= i.t0 <= i.t1 <= i.parent.t1
    assert inner[0].root is not inner[1].root
    o = outer[0]
    kids = [m for m in mids if m.parent is o]
    assert o.self_seconds == pytest.approx(
        o.seconds - sum(m.seconds for m in kids), abs=1e-9)
    assert o.self_seconds >= 0.002
    assert kids[0].self_seconds == pytest.approx(
        kids[0].seconds - inner[0].seconds, abs=1e-9)
    assert len(reg.spans("inner", under="outer")) == 2
    assert reg.spans("mid", under="inner") == []
    t = reg.span_table()
    assert t["outer"]["count"] == 2
    assert t["outer"]["total_ms"] == pytest.approx(
        1e3 * sum(s.seconds for s in outer))
    assert t["inner"]["self_ms"] == pytest.approx(t["inner"]["total_ms"])
    rep = reg.report()
    assert "spans (ms; 0 dropped):" in rep
    assert all(n in rep for n in ("outer", "mid", "inner"))


def test_spans_filter_by_start_time():
    reg = MetricsRegistry()
    with reg.span("a"):
        pass
    cut = time.perf_counter()
    with reg.span("a"):
        pass
    assert len(reg.spans("a", cut)) == 1
    assert len(reg.spans("a", None, cut)) == 1
    assert len(reg.spans("a", cut, cut)) == 0


# -- the program's spans --------------------------------------------------------

def _names(reg):
    return set(reg.span_table())


def test_program_span_names_stay_out_of_the_benchmarks_nesting():
    vi = _index()
    Q = _rows(16, seed=2)
    vi.knn_query(Q, k=5)
    vi.knn_query(Q, k=5, filter=np.arange(0, 600, 3))
    vi.add_items(_rows(8, seed=4), labels=np.arange(5000, 5008))
    eng = _churned_pump(vi)
    names = _names(vi.metrics) | _names(eng.metrics)
    assert eng.metrics is not vi.metrics
    want = {"index.add_items", "index.knn_query", "index.filter_mask",
            "search.descend", "search.layer", "wave.compile", "wave",
            "wave.slots", "wave.candidates", "wave.commit", "wave.deletes",
            "wave.repair", "engine.pump", "batcher.flush", "batcher.batch",
            "scheduler.drain", "engine.maintain", "engine.publish",
            "maintain.consult"}
    assert want <= names, want - names
    assert not names & set(_bench_nesting())


def test_knn_query_span_carries_the_planner_decision():
    vi = _index()
    Q = _rows(16, seed=2)
    vi.knn_query(Q, k=5)
    vi.knn_query(Q, k=5, filter=np.arange(0, 600, 3))
    vi.knn_query(Q, k=5, mode="exact")
    a, b, c = vi.metrics.spans("index.knn_query")
    assert a.attrs == dict(k=5, q=16, ef=16, tier="graph",
                           reason=a.attrs["reason"], allowed=-1)
    assert b.attrs["allowed"] == 200 and b.attrs["ef"] == 64
    assert c.attrs["tier"] == "exact" and "mode" in c.attrs["reason"]
    mask = vi.metrics.spans("index.filter_mask")
    assert len(mask) == 1 and mask[0].parent is b
    assert [s.attrs["layer"] for s in vi.metrics.spans(
        "search.layer", under="index.knn_query")] == [0, 0]


def test_search_layer_counts_its_steps_and_visited_rows(monkeypatch):
    vi = _index()
    params, index = vi.params, vi.index
    Q = torch.from_numpy(_rows(12, seed=7))
    ep = index.entry.long().expand(12).clone()
    loops, visited = [], []
    real_sort, real_zeros = S.stable_argsort, torch.zeros

    def counting_sort(x):
        loops.append(1)
        return real_sort(x)

    def keep_visited(*shape, **kw):
        t = real_zeros(*shape, **kw)
        if kw.get("dtype") is torch.bool and tuple(t.shape) == (
                12, index.capacity + 1):
            visited.append(t)
        return t

    monkeypatch.setattr(S, "stable_argsort", counting_sort)
    monkeypatch.setattr(torch, "zeros", keep_visited)
    reg = MetricsRegistry()
    with spans.use(reg):
        for cap in (None, 3):
            loops.clear()
            with profile(activities=[ProfilerActivity.CPU]):
                S.search_layer(params, index, Q, ep, 0, 16, max_steps=cap)
            sp = reg.spans("search.layer")[-1]
            assert sp.profiled and sp.attrs["lanes"] == 12
            assert sp.attrs["steps"] == len(loops)
            assert sp.attrs["steps"] == (3 if cap else len(loops))
            v = visited[-1]
            assert int(sp.attrs["rows_visited"]) == int(
                v[:, :index.capacity].sum())
            assert sp.attrs["rows_visited"].dim() == 0
        S.search_layer(params, index, Q, ep, 0, 16)   # no profiler
    assert "rows_visited" not in reg.spans("search.layer")[-1].attrs
    assert 0 < reg.spans("search.layer")[0].attrs["steps"] <= \
        params.steps_for(16)


@pytest.mark.parametrize("B,N", [(128, 1024), (12, 1024), (3, 8)])
def test_visited_count_equals_a_plain_count(B, N):
    v = torch.rand(B, N + 1, generator=torch.Generator().manual_seed(B)) < .3
    want = int(v[:, :N].sum())
    got = count_flags(v, N)
    assert got.dtype == torch.int64 and got.dim() == 0 and int(got) == want


def test_count_flags_checks_its_input():
    with pytest.raises(ValueError, match="2-D bool"):
        count_flags(torch.zeros(3, 4, dtype=torch.uint8), 2)
    with pytest.raises(ValueError, match="2-D bool"):
        count_flags(torch.zeros(4, dtype=torch.bool), 2)
    with pytest.raises(ValueError, match="cols"):
        count_flags(torch.zeros(3, 4, dtype=torch.bool), 5)
    assert int(count_flags(torch.ones(3, 4, dtype=torch.bool), 0)) == 0


def test_engines_served_from_one_index_keep_their_own_stats():
    vi = _index()
    a = _churned_pump(vi)
    b = vi.serve(k=5, max_batch=32)
    assert a.metrics is not b.metrics
    before = a.stats()
    for q in _rows(7, seed=11):
        b.search(q)
    b.pump()
    assert a.stats() == before
    assert b.stats()["counters"]["queries_served"] == 7
    assert b.stats()["counters"]["pumps"] == 1
    assert before["counters"]["pumps"] == 1
    assert not b.metrics.spans("index.add_items")
    assert vi.metrics.spans("index.add_items")


def test_a_drain_of_replaces_records_the_wave_phases():
    vi = _index()
    eng = _churned_pump(vi)
    drain, = eng.metrics.spans("scheduler.drain")
    assert drain.attrs["ops"] == 96 and drain.attrs["waves"] >= 2
    assert drain.parent.name == "engine.pump"
    for name in ("wave.repair", "wave.candidates", "wave.commit",
                 "wave.slots", "wave.deletes", "wave.compile"):
        assert eng.metrics.spans(name, under="scheduler.drain"), name
    wave = eng.metrics.spans("wave", under="scheduler.drain")
    assert all(w.attrs["tier"] in ("scan", "beam") and w.attrs["W"] >= 1
               for w in wave)
    pump, = eng.metrics.spans("engine.pump")
    kids = {s.name for s in eng.metrics.spans("batcher.flush")
            + eng.metrics.spans("engine.maintain")
            + eng.metrics.spans("engine.publish") if s.parent is pump}
    assert kids == {"batcher.flush", "engine.maintain", "engine.publish"}
    batch, = eng.metrics.spans("batcher.batch")
    assert batch.attrs == dict(rows=20, bucket=32, tier="graph")
    assert eng.metrics.spans("maintain.consult", under="engine.maintain")


def test_beam_tier_search_spans_nest_inside_the_candidates():
    vi = _index()
    reg = MetricsRegistry()
    n = 16
    ops = np.r_[np.full(n, OP_DELETE), np.full(n, OP_REPLACE)].astype(
        np.int32)
    labels = np.r_[np.arange(n), np.arange(7000, 7000 + n)].astype(np.int32)
    X = np.r_[np.zeros((n, 8), np.float32), _rows(n, seed=9)]
    with spans.use(reg):
        apply_update_batch_wave(vi.params, vi.index, ops, labels, X,
                                scan_max_elems=0, generator=vi.generator)
    wave, = reg.spans("wave")
    assert wave.attrs == dict(W=16, tier="beam")
    cands, = reg.spans("wave.candidates")
    assert reg.spans("search.descend", under="wave.candidates")
    layers = reg.spans("search.layer", under="wave.candidates")
    assert layers and all(s.attrs["ef"] == 16 for s in layers)
    assert reg.spans("search.layer", under="wave.repair") == []
    assert cands.self_seconds < cands.seconds


def test_maintenance_passes_record_their_phases():
    vi = _index(maintenance=None)
    vi.mark_deleted(np.arange(40))
    vi.consolidate()
    vi.repair_unreachable()
    names = _names(vi.metrics)
    assert {"maintain.consolidate", "maintain.repair"} <= names
    assert "maintain.consult" in _names(vi.metrics) or vi.health()
    vi.health()
    assert vi.metrics.spans("maintain.consult")


def _profiled_calls(vi, Q):
    """The registry's spans and the profiler's ranges of the same calls:
    ``(spans, {span: (name, start ns, end ns)}, duration misses)``. The
    pump's spans are in its engine's own registry."""
    reg = vi.metrics
    before = set(reg._ring)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        vi.knn_query(Q, k=5)
        vi.knn_query(Q, k=5, filter=np.arange(0, 600, 3))
        vi.add_items(_rows(8, seed=4), labels=np.arange(5000, 5008))
        eng = _churned_pump(vi, n_updates=24)
    mine = sorted((s for s in [*reg._ring, *eng.metrics._ring]
                   if s not in before), key=lambda s: s.t0)
    assert mine and all(s.profiled for s in mine)
    names = {s.name for s in mine}
    by_name: dict[str, list] = {}
    for e in sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.name() in names), key=lambda e: e[1]):
        by_name.setdefault(e[0], []).append(e)
    got, misses = {}, []
    for n in names:
        spans_n = [s for s in mine if s.name == n]
        assert len(by_name[n]) == len(spans_n), n
        for s, e in zip(spans_n, by_name[n]):
            got[s] = e
            ms_reg, ms_prof = 1e3 * s.seconds, (e[2] - e[1]) * 1e-6
            if abs(ms_reg - ms_prof) > max(0.1 * ms_reg, 0.5):
                misses.append((n, ms_reg, ms_prof))
    return mine, got, misses


def test_profiler_ranges_match_the_registry():
    """Same names, same nesting, and durations within 10% or 0.5 ms. A
    process descheduled between a range's edge and the span's clock read
    misses by the pause, so the calls are profiled again, at most twice,
    until every duration agrees."""
    Q = _rows(16, seed=2)
    for _ in range(3):
        vi = _index()
        vi.knn_query(Q, k=5)                 # warm
        mine, got, misses = _profiled_calls(vi, Q)
        for s in mine:
            if s.parent is not None and s.parent in got:
                c, p = got[s], got[s.parent]
                assert p[1] <= c[1] and c[2] <= p[2], (s.name, s.parent.name)
        if not misses:
            break
    assert not misses, misses


# -- the histogram ------------------------------------------------------------

def test_histogram_percentiles_cover_every_sample():
    rng = np.random.default_rng(11)
    x = rng.lognormal(mean=2.0, sigma=1.0, size=100_000)
    h = Histogram()
    for v in x:
        h.observe(v)
    assert h.count == 100_000
    assert h.sum == pytest.approx(float(np.sum(x)), rel=1e-12)
    for p in (50, 99):
        want = float(np.percentile(x, p))
        assert abs(h.percentile(p) - want) <= (Histogram.GROWTH - 1) * want
    s = h.summary()
    assert set(s) == {"count", "mean", "p50", "p99"}
    assert s["mean"] == pytest.approx(float(np.mean(x)))


def test_histogram_keeps_the_samples_a_ring_would_drop():
    h = Histogram()
    for _ in range(5000):
        h.observe(1000.0)
    for _ in range(5000):
        h.observe(1.0)
    # a ring of the last 4,096 samples would read 1.0 for both
    assert h.percentile(99) == pytest.approx(1000.0, rel=Histogram.GROWTH - 1)
    assert h.percentile(40) == pytest.approx(1.0, rel=Histogram.GROWTH - 1)


def test_histogram_zero_negative_and_empty():
    h = Histogram()
    assert h.summary() == {"count": 0, "mean": 0.0, "p50": 0.0, "p99": 0.0}
    for v in (0, 0, 0, -5.0, 2.0):
        h.observe(v)
    assert h.percentile(1) == -5.0
    assert h.percentile(50) == 0.0
    assert h.percentile(100) == 2.0
    assert abs(h.percentile(30) - 0.0) == 0.0
