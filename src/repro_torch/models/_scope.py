"""Op families for the dry run's FLOP count (``launch.dryrun``).

``family(name)`` marks the products a block of the forward computes (the
attention einsums) so that a counting mode can book them apart from the
weight products. The forward's products are booked by the scope that is
open; the backward's by the autograd node that runs them, whose sequence
number falls in the range of nodes the scope made. With no counting mode
open, ``family`` does nothing but check one counter.
"""
from __future__ import annotations

import bisect
import contextlib

import torch


class _State:
    counting = 0            # counting modes open
    family: str | None = None
    starts: list = []       # first sequence number of each closed scope
    ranges: list = []       # (first, end, family), sorted by first


@contextlib.contextmanager
def family(name: str):
    if not _State.counting:
        yield
        return
    prev, _State.family = _State.family, name
    first = torch._C._autograd._get_sequence_nr()
    try:
        yield
    finally:
        _State.family = prev
        end = torch._C._autograd._get_sequence_nr()
        if end > first:
            i = bisect.bisect_right(_State.starts, first)
            _State.starts.insert(i, first)
            _State.ranges.insert(i, (first, end, name))


def current() -> str | None:
    """The family of the op about to run: the open scope's, else that of
    the backward node running it, else None."""
    if _State.family is not None:
        return _State.family
    node = torch._C._current_autograd_node()
    if node is None:
        return None
    nr = node._sequence_nr()
    i = bisect.bisect_right(_State.starts, nr) - 1
    if i >= 0:
        first, end, name = _State.ranges[i]
        if first <= nr < end:
            return name
    return None


def open_count() -> None:
    """A counting mode opens."""
    _State.counting += 1


def close_count() -> None:
    """A counting mode closes; the scopes' ranges go with the last one."""
    _State.counting -= 1
    if not _State.counting:
        _State.family = None
        _State.starts, _State.ranges = [], []
