"""Host data pipeline: stateless seeded streams + background prefetch.

Fault-tolerance posture: batches are a pure function of (stream seed, step),
so any worker can regenerate any shard after restart/reshard — the checkpoint
only stores the step counter. Prefetch runs on a daemon thread with a bounded
queue (straggler decoupling between host data prep and device step).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator


class SyntheticStream:
    """Deterministic ``step -> batch`` stream with resume support."""

    def __init__(self, make_batch: Callable[[int], dict], start_step: int = 0):
        self._make = make_batch
        self.step = start_step

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = self._make(self.step)
        self.step += 1
        return b

    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, st: dict) -> None:
        self.step = int(st["step"])


class PrefetchPipeline:
    """Bounded-queue background prefetcher over any iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
