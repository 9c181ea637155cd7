"""What the per-layer readers of the program's own spans share.

The program records spans in its ``MetricsRegistry`` (``serving/metrics.py``):
the closed loop's index holds it as ``vi.metrics`` (the build's spans and
the queries'), the open loop's engine as ``engine.metrics`` (a registry of
its own: its pumps' spans). A program without spans (one from before they
were added) has no registry with ``spans()``, and every reader then returns
``None``; so does a reader whose window lost a span to the registry's
bounded ring.
"""
from __future__ import annotations


def registry(obs):
    """The program's span registry, or ``None``."""
    prog = obs.program
    for owner in (getattr(prog, "engine", None), getattr(prog, "vi", None)):
        reg = getattr(owner, "metrics", None)
        if callable(getattr(reg, "spans", None)):
            return reg
    return None


def spans(obs, name: str, window: dict | None, under: str | None = None):
    """Spans of ``name`` that started inside ``window`` (its ``t0``/``t1``;
    ``None``: everything before the untraced window, i.e. set-up), or
    ``None`` if there are none, or the ring dropped any span in it."""
    reg = registry(obs)
    if reg is None:
        return None
    if window is None:
        t0, t1 = None, obs.window["t0"]
    else:
        t0, t1 = window["t0"], window["t1"]
    if reg.spans_dropped and (t0 is None or reg.last_dropped_t0 >= t0):
        return None
    found = reg.spans(name, t0, t1, under=under)
    return found or None


def attr(s, key: str):
    """A span's attribute as a Python number (device counts are 0-d
    tensors until read), or ``None``."""
    v = s.attrs.get(key)
    return None if v is None else float(v)
