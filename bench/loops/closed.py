"""The closed loop: a bulk job's batches through ``VectorIndex.knn_query``,
the next sent when the last is answered.

Mix parameters: ``k``; ``batch`` queries a batch; ``pool_batches``, the
batches of the query table, sent in turn; ``categories``: with a number
above 0 every label gets one of that many equal categories, and each batch
is restricted to one (``filter=``), the categories taken in an order drawn
from the seed. Everything comes from the run's seed (``reference.data``).
"""
from __future__ import annotations

import time

import numpy as np

from bench.common import make_index, sync
from bench.reference import data as D
from bench.reference.exact import Answers


class Loop:
    """Batches through ``VectorIndex.knn_query``, one after another."""

    span_name = "knn_query"

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 spans, root=None):
        self.cfg, self.tr, self.device, self.spans = cfg, traffic, device, spans
        self.seed = seed
        self.k = traffic["k"]
        self.B = traffic["batch"]
        self.nb = traffic["pool_batches"]
        rows, d = cfg["rows"], cfg["d"]
        self.X = D.draw(rows, d, seed, D.DATA)
        self.Q = D.draw(self.nb * self.B, d, seed, D.QUERIES)
        cats = traffic.get("categories", 0)
        self.cats = cats
        if cats:
            if rows % cats:
                raise ValueError(f"{rows} rows do not split into {cats} "
                                 "equal categories")
            perm = np.random.default_rng(
                D.stream_seed(seed, D.CATEGORIES)).permutation(rows)
            self.members = np.sort(perm.reshape(cats, rows // cats), axis=1)
            self.order = np.random.default_rng(
                D.stream_seed(seed, D.CATEGORY_ORDER)).permutation(cats)
            self.span_name = "filter_batch"
        self.parts: list[Answers] = []
        self.vi = None

    def setup(self) -> None:
        self.vi = make_index(self.cfg, self.seed, self.device)
        self.vi.add_items(self.X)
        self.batch(0)                       # warm up the window's shapes
        sync(self.device)

    def batch(self, i: int) -> Answers:
        blk = i % self.nb
        Q = self.Q[blk * self.B:(blk + 1) * self.B]
        g = int(self.order[i % self.cats]) if self.cats else 0
        flt = self.members[g] if self.cats else None
        with self.spans.span(self.span_name, q=self.B, n_rows=self.cfg["rows"],
                             allowed=0 if flt is None else len(flt),
                             d=self.cfg["d"], k=self.k):
            labels, dists = self.vi.knn_query(Q, k=self.k, filter=flt)
        return Answers(np.arange(blk * self.B, (blk + 1) * self.B),
                       np.full(self.B, g, np.int64), labels, dists)

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        i = 0
        while True:
            self.parts.append(self.batch(i))
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
        return {"t0": t0, "t1": t1, "window_s": t1 - t0,
                "queries": i * self.B, "batches": i}

    def probe(self, n_batches: int = 1) -> Answers:
        """Answers of a few more batches at the current state (the fault
        and control readings, after the window)."""
        return Answers.concat([self.batch(i) for i in range(n_batches)])

    def program_readings(self) -> dict:
        return {}

    def free(self) -> None:
        self.vi = None

    def reference_inputs(self):
        """``(X rows by label, query pool, group masks, answers)``."""
        rows = self.cfg["rows"]
        if self.cats:
            groups = np.zeros((self.cats, rows), bool)
            for g in range(self.cats):
                groups[g, self.members[g]] = True
        else:
            groups = np.ones((1, rows), bool)
        return self.X, self.Q, groups, Answers.concat(self.parts)


