"""Lightweight serving metrics: counters, gauges, histograms and spans.

No external deps, no background threads — observation is a dict update,
so the hot serving loop pays O(1) per sample. Histograms count samples in
fixed log-spaced buckets (each 2% wide), so p50/p99 cover every sample
observed; ``count``/``sum`` are exact.

Spans time the program's layers (``registry.span(name, **attrs)``): a
name, host start and end on ``time.perf_counter()`` (the clock of the
benchmark's windows), the enclosing span, the root span of the call that
caused it (one knn batch, one pump), and attributes, among them the counts
taken at that boundary. Finished spans go into a bounded ring
(``span_capacity``, default 65,536; 0 records nothing) with a count of the
spans it dropped. While a ``torch.profiler`` session records, each span is
also a ``record_function`` range of the same name, so the profiler's trace
places it on the device's clock.

``MetricsRegistry`` is the single object the engine threads through its
components; ``to_dict()``/``dumps()`` give a JSON view and ``report()`` a
human one-pager.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import math
import time

import torch
import torch.autograd.profiler as _profiler

from ..core.spans import NO_SPAN

#: spans the ring keeps by default
SPAN_CAPACITY = 65_536


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Histogram:
    """Exact count/sum + fixed log-spaced buckets for percentiles.

    A positive sample lands in bucket ``floor(log(x) / log(GROWTH))`` (a
    negative one in its mirror, zero in a bucket of its own), so a
    percentile is the midpoint of its bucket, within 1% of the sample.
    """

    GROWTH = 1.02
    _LOG = math.log(GROWTH)
    __slots__ = ("count", "sum", "_buckets", "_min", "_max")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self._buckets: dict[tuple[int, int], int] = {}
        self._min = math.inf
        self._max = -math.inf

    def _key(self, x: float) -> tuple[int, int]:
        if x == 0.0:
            return (0, 0)
        k = math.floor(math.log(abs(x)) / self._LOG)
        return (1, k) if x > 0 else (-1, -k)

    def _mid(self, key: tuple[int, int]) -> float:
        sign, k = key
        if sign == 0:
            return 0.0
        return sign * self.GROWTH ** (sign * k + 0.5)

    def observe(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.sum += x
        self._min = min(self._min, x)
        self._max = max(self._max, x)
        key = self._key(x)
        self._buckets[key] = self._buckets.get(key, 0) + 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over every sample observed (the midpoint
        of the bucket that holds it, clipped to the samples' range)."""
        if not self.count:
            return 0.0
        rank = min(self.count, max(1, math.ceil(p / 100.0 * self.count)))
        seen = 0
        for key in sorted(self._buckets):
            seen += self._buckets[key]
            if seen >= rank:
                return min(self._max, max(self._min, self._mid(key)))
        return self._max

    def summary(self) -> dict:
        return {"count": self.count, "mean": self.mean,
                "p50": self.percentile(50), "p99": self.percentile(99)}


class Span:
    """One finished (or open) span; ``parent`` and ``root`` are spans."""

    __slots__ = ("id", "name", "t0", "t1", "parent", "root", "attrs",
                 "profiled", "child_s")

    def __init__(self, id_: int, name: str, parent: "Span | None",
                 attrs: dict, profiled: bool):
        self.id = id_
        self.name = name
        self.parent = parent
        self.root = self if parent is None else parent.root
        self.attrs = attrs
        self.profiled = profiled
        self.t0 = self.t1 = 0.0
        self.child_s = 0.0              # seconds its child spans cover

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    @property
    def self_seconds(self) -> float:
        return self.seconds - self.child_s

    def under(self, name: str) -> bool:
        """Whether an ancestor of this span is named ``name``."""
        p = self.parent
        while p is not None:
            if p.name == name:
                return True
            p = p.parent
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {1e3 * self.seconds:.3f} ms, "
                f"{self.attrs})")


class MetricsRegistry:
    """Create-on-first-use registry shared by every serving component."""

    def __init__(self, span_capacity: int = SPAN_CAPACITY):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, float] = {}
        self._histograms: dict[str, Histogram] = {}
        self.span_capacity = int(span_capacity)
        self._ring: collections.deque[Span] = collections.deque(
            maxlen=max(self.span_capacity, 1))
        self._open: list[Span] = []
        self._ids = itertools.count()
        self.spans_dropped = 0
        self.last_dropped_t0 = -math.inf   # latest start of a dropped span

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter())

    def histogram(self, name: str) -> Histogram:
        return self._histograms.setdefault(name, Histogram())

    def set_gauge(self, name: str, value: float) -> None:
        self._gauges[name] = float(value)

    def gauge(self, name: str, default: float = 0.0) -> float:
        return self._gauges.get(name, default)

    # -- spans --------------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Time the body as a span of ``name``; yields the :class:`Span`
        (``set(**attrs)`` adds attributes before it ends)."""
        if self.span_capacity <= 0:
            yield NO_SPAN
            return
        parent = self._open[-1] if self._open else None
        profiled = _profiler._is_profiler_enabled
        s = Span(next(self._ids), name, parent, attrs, profiled)
        rf = torch.profiler.record_function(name) if profiled else None
        if rf is not None:
            rf.__enter__()
        self._open.append(s)
        s.t0 = time.perf_counter()
        try:
            yield s
        finally:
            s.t1 = time.perf_counter()
            self._open.pop()
            if rf is not None:
                rf.__exit__(None, None, None)
            if parent is not None:
                parent.child_s += s.t1 - s.t0
            if len(self._ring) == self.span_capacity:
                self.spans_dropped += 1
                self.last_dropped_t0 = max(self.last_dropped_t0,
                                           self._ring[0].t0)
            self._ring.append(s)

    def spans(self, name: str, t0: float | None = None,
              t1: float | None = None, under: str | None = None
              ) -> list[Span]:
        """Finished spans of ``name`` that started in ``[t0, t1)``; with
        ``under``, only those with an ancestor of that name."""
        return [s for s in self._ring if s.name == name
                and (t0 is None or s.t0 >= t0)
                and (t1 is None or s.t0 < t1)
                and (under is None or s.under(under))]

    def span_table(self) -> dict[str, dict]:
        """Per span name in the ring: count, total and self milliseconds."""
        out: dict[str, dict] = {}
        for s in self._ring:
            row = out.setdefault(s.name, {"count": 0, "total_ms": 0.0,
                                          "self_ms": 0.0})
            row["count"] += 1
            row["total_ms"] += 1e3 * s.seconds
            row["self_ms"] += 1e3 * s.self_seconds
        return dict(sorted(out.items()))

    # -- views --------------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "gauges": dict(sorted(self._gauges.items())),
            "histograms": {k: h.summary()
                           for k, h in sorted(self._histograms.items())},
        }

    def dumps(self, indent: int | None = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def report(self) -> str:
        lines = ["serving metrics:"]
        for k, c in sorted(self._counters.items()):
            lines.append(f"  {k:<28} {c.value}")
        for k, v in sorted(self._gauges.items()):
            lines.append(f"  {k:<28} {v:.4g}")
        for k, h in sorted(self._histograms.items()):
            s = h.summary()
            lines.append(f"  {k:<28} n={s['count']} mean={s['mean']:.3g} "
                         f"p50={s['p50']:.3g} p99={s['p99']:.3g}")
        table = self.span_table()
        if table:
            lines.append(f"spans (ms; {self.spans_dropped} dropped):")
        for k, r in table.items():
            lines.append(f"  {k:<28} n={r['count']} "
                         f"total={r['total_ms']:.4g} self={r['self_ms']:.4g}")
        return "\n".join(lines)
