"""Lightweight serving metrics: counters, gauges, bounded histograms.

No external deps, no background threads — observation is a list append, so
the hot serving loop pays O(1) per sample. Histograms keep a bounded ring of
recent samples (default 4096) for p50/p99 over a serving window;
``count``/``sum`` stay exact over the full lifetime.

``MetricsRegistry`` is the single object the engine threads through its
components; ``to_dict()``/``dumps()`` give a JSON view and ``report()`` a
human one-pager.
"""
from __future__ import annotations

import json
import math


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Histogram:
    """Exact count/sum + bounded sample ring for percentile estimates."""

    __slots__ = ("count", "sum", "_ring", "_cap", "_pos")

    def __init__(self, cap: int = 4096):
        self.count = 0
        self.sum = 0.0
        self._ring: list[float] = []
        self._cap = cap
        self._pos = 0

    def observe(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.sum += x
        if len(self._ring) < self._cap:
            self._ring.append(x)
        else:
            self._ring[self._pos] = x
            self._pos = (self._pos + 1) % self._cap

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the retained sample window."""
        if not self._ring:
            return 0.0
        s = sorted(self._ring)
        rank = min(len(s) - 1, max(0, math.ceil(p / 100.0 * len(s)) - 1))
        return s[rank]

    def summary(self) -> dict:
        return {"count": self.count, "mean": self.mean,
                "p50": self.percentile(50), "p99": self.percentile(99)}


class MetricsRegistry:
    """Create-on-first-use registry shared by every serving component."""

    def __init__(self):
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, float] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter())

    def histogram(self, name: str) -> Histogram:
        return self._histograms.setdefault(name, Histogram())

    def set_gauge(self, name: str, value: float) -> None:
        self._gauges[name] = float(value)

    def gauge(self, name: str, default: float = 0.0) -> float:
        return self._gauges.get(name, default)

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
        return "\n".join(lines)
