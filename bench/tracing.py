"""The benchmark's spans, and the reduction of the profiler's trace.

Spans are the benchmark's own, recorded from ``bench/`` around its calls
into the program (``pump``, and inside it ``serve``, ``drain`` and
``maintain``; ``knn_query``, ``filter_batch``): a name, host start and end, and attributes. In a traced
run each span is also a ``record_function`` range, so the trace can say
which device work and which idle time fall inside it.

``reduce_trace`` turns ``torch.profiler``'s events into what the readers
and the result line need: the device's busy seconds over the traced window
(the union of its kernel, copy and set intervals), the device operations
that took most time, the idle gaps by what the host was doing, and for
each span the device seconds and kernel launches inside it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict

import numpy as np

#: the traced window's own range
WINDOW = "window"
#: where an idle gap is charged when several spans hold its midpoint: the
#: innermost first
NESTING = ("drain", "maintain", "serve", "pump", "filter_batch", "knn_query",
           WINDOW)
TOP = 10


@dataclasses.dataclass
class Span:
    name: str
    t0: float
    t1: float
    attrs: dict

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Spans:
    """An in-memory span recorder; ``record_function`` ranges when traced."""

    def __init__(self, traced: bool = False):
        self.traced = traced
        self.rows: list[Span] = []

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        if self.traced:
            import torch
            rf = torch.profiler.record_function(name)
        else:
            rf = contextlib.nullcontext()
        with rf:
            t0 = time.perf_counter()
            try:
                yield attrs
            finally:
                self.rows.append(Span(name, t0, time.perf_counter(), attrs))

    def named(self, name: str, t0: float | None = None,
              t1: float | None = None) -> list[Span]:
        """Spans of ``name`` that started in ``[t0, t1)`` (host clock)."""
        return [s for s in self.rows if s.name == name
                and (t0 is None or s.t0 >= t0)
                and (t1 is None or s.t0 < t1)]

    def wrap(self, obj, attr: str, name: str) -> None:
        """Record a span around every call of ``obj.attr`` (an instance
        attribute shadows the method; the program is not changed)."""
        fn = getattr(obj, attr)

        def traced(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)
        setattr(obj, attr, traced)


def _union_seconds(iv: np.ndarray) -> tuple[float, np.ndarray]:
    """Total length of the union of ``[start, end)`` rows, and the union's
    intervals (sorted)."""
    if len(iv) == 0:
        return 0.0, np.empty((0, 2))
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    idx = np.nonzero(new)[0]
    stops = ends[np.r_[idx[1:] - 1, len(iv) - 1]]
    merged = np.stack([starts, stops], 1)
    return float((stops - starts).sum()), merged


def reduce_events(device: list[tuple[int, int, str]],
                  annotations: list[tuple[str, int, int]]) -> dict:
    """The reduction itself, on plain tuples (nanoseconds on one clock).

    ``device``: ``(start, end, name)`` of every kernel, copy and set;
    ``annotations``: ``(name, start, end)`` of the spans and the window.
    """
    win = [a for a in annotations if a[0] == WINDOW]
    if not win:
        raise ValueError("the trace holds no window range")
    w0, w1 = win[0][1], win[0][2]
    dv = np.array([(s, e) for s, e, _ in device], np.float64).reshape(-1, 2)
    names = [n for _, _, n in device]
    inside = (dv[:, 1] > w0) & (dv[:, 0] < w1)
    clipped = np.clip(dv[inside], w0, w1)
    busy_ns, merged = _union_seconds(clipped)

    by_name: dict[str, float] = defaultdict(float)
    for (s, e), n, ok in zip(dv, names, inside):
        if ok:
            by_name[n] += (min(e, w1) - max(s, w0)) * 1e-9
    device_ops = sorted(([n[:160], v] for n, v in by_name.items()),
                        key=lambda r: -r[1])[:TOP]

    # idle gaps inside the window, charged to the innermost span holding
    # each gap's midpoint
    edges = np.concatenate([[w0], merged.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    mid = gaps.mean(1)
    owner = np.full(len(gaps), WINDOW, object)
    free = np.ones(len(gaps), bool)
    for name in NESTING[:-1]:
        iv = np.array([(s, e) for n, s, e in annotations if n == name],
                      np.float64).reshape(-1, 2)
        if not len(iv) or not free.any():
            continue
        iv = iv[np.argsort(iv[:, 0])]
        j = np.searchsorted(iv[:, 0], mid, side="right") - 1
        hit = free & (j >= 0) & (mid < iv[np.clip(j, 0, None), 1])
        owner[hit] = name
        free &= ~hit
    idle: dict[str, float] = defaultdict(float)
    for o, (s, e) in zip(owner, gaps):
        idle[o] += (e - s) * 1e-9
    idle_gaps = sorted(([n, v] for n, v in idle.items()),
                       key=lambda r: -r[1])[:TOP]

    # device seconds and kernel launches started inside each span
    starts = dv[:, 0]
    order = np.argsort(starts, kind="stable")
    st_sorted = starts[order]
    dur_sorted = (dv[:, 1] - dv[:, 0])[order]
    is_kernel = np.array([not (n.startswith("Memcpy") or
                               n.startswith("Memset")) for n in names],
                         bool)[order]
    csum = np.concatenate([[0.0], np.cumsum(dur_sorted)])
    ksum = np.concatenate([[0], np.cumsum(is_kernel)])
    per_span: dict[str, list[tuple[float, int]]] = defaultdict(list)
    for n, s, e in annotations:
        if n == WINDOW:
            continue
        a, b = np.searchsorted(st_sorted, [s, e])
        per_span[n].append((float(csum[b] - csum[a]) * 1e-9,
                            int(ksum[b] - ksum[a])))
    kernel_s = {n: v for n, v in by_name.items()}
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy_ns * 1e-9,
            "device_ops": device_ops, "idle_gaps": idle_gaps,
            "per_span": dict(per_span), "kernel_s": kernel_s}


def reduce_trace(prof) -> dict:
    """Reduce a stopped ``torch.profiler.profile``'s events. A span is
    known by its name on either side: on the host it is a range, and the
    device's copy of it (``gpu_user_annotation``) is no device work."""
    from torch.autograd import DeviceType
    device, annotations = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        user = name in NESTING or bool(
            getattr(e, "is_user_annotation", lambda: False)())
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not user:
                device.append((start, end, name))
        elif name in NESTING:
            annotations.append((name, start, end))
    return reduce_events(device, annotations)
