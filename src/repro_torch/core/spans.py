"""The registry that records spans for the current call, as a context variable.

The recorder is the serving layer's ``MetricsRegistry``; ``core/`` does not
import ``serving/``, so the facade and the engine make their registry
current around each of their calls (:func:`use`) and the core's layers open
spans through :func:`span` and add to its counters through :func:`count`.
With no current registry (a direct call into the core), a span is a no-op
that costs one context-variable read.

The registry's ``span(name, **attrs)`` yields a span with ``set(**attrs)``
(attributes known only at its end) and ``profiled`` (True while a
``torch.profiler`` session records, when the span is also a
``record_function`` range; device-side counts are taken only then).
"""
from __future__ import annotations

import contextlib
import contextvars

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_span_registry", default=None)


class _NoSpan:
    """What a span yields when nothing records: attributes are dropped."""

    __slots__ = ()
    profiled = False

    def set(self, **attrs) -> None:
        pass


NO_SPAN = _NoSpan()
_OFF = contextlib.nullcontext(NO_SPAN)


def span(name: str, **attrs):
    """A span of ``name`` in the current registry (a no-op without one)."""
    reg = _CURRENT.get()
    if reg is None:
        return _OFF
    return reg.span(name, **attrs)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` of the current registry (nothing
    without one). A counter is made at its first count above 0."""
    reg = _CURRENT.get()
    if reg is not None and n:
        reg.counter(name).inc(n)


@contextlib.contextmanager
def use(registry):
    """Make ``registry`` current for the body."""
    token = _CURRENT.set(registry)
    try:
        yield
    finally:
        _CURRENT.reset(token)

