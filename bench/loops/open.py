"""The open loop: a served index under churn, through ``ServingEngine``.

Single queries arrive by ``ServingEngine.search`` with Poisson arrivals at
``query_rate`` per second, behind a standing backlog of at least
``standing_ops`` update ops from ``bench.updates.UpdateStream`` (the mix's
``updates`` names its label and row draws). The loop submits what is due,
tops the backlog up and calls ``pump()``. ``engine`` holds
``VectorIndex.serve``'s settings. Everything comes from the run's seed.

Arrivals run on the loop's own clock, which advances only inside a window:
a second window (the traced one) goes on where the first stopped.
"""
from __future__ import annotations

import time

import numpy as np

from bench.common import make_index, sync
from bench.reference import data as D
from bench.reference.exact import Answers, live_mask
from bench.updates import UpdateStream


class Loop:
    """Open-loop single queries through ``ServingEngine`` under churn."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 spans, root):
        self.cfg, self.tr, self.device, self.spans = cfg, traffic, device, spans
        self.seed = seed
        self.k = traffic["k"]
        rows, d = cfg["rows"], cfg["d"]
        self.X = D.draw(rows, d, seed, D.DATA)
        self.P = traffic["query_pool"]
        self.Q = D.draw(self.P, d, seed, D.QUERIES)
        self.rate = traffic["query_rate"]
        self.arrival_rng = np.random.default_rng(
            D.stream_seed(seed, D.ARRIVALS))
        self.arrivals = np.empty(0)
        self.stream = UpdateStream(seed, rows, d, traffic["updates"], root)
        self.engine = None
        self.applied = 0                    # ops published so far
        self.epoch_ops: dict[int, int] = {}
        self.tickets: list[tuple[int, float, float, object]] = []
        self.next_query = 0
        self.clock = 0.0                    # seconds of windows run so far

    def _due(self, upto: float) -> None:
        """Extend the arrival times past ``upto`` seconds (in chunks, so the
        times do not depend on when they are asked for)."""
        while not len(self.arrivals) or self.arrivals[-1] <= upto:
            gaps = self.arrival_rng.exponential(1.0 / self.rate, 4096)
            last = self.arrivals[-1] if len(self.arrivals) else 0.0
            self.arrivals = np.concatenate([self.arrivals,
                                            last + np.cumsum(gaps)])

    def setup(self) -> None:
        from repro_torch import api
        vi = make_index(self.cfg, self.seed, self.device)
        vi.add_items(self.X)
        e = self.tr["engine"]
        m = dict(e["maintenance"])
        m["unreachable"] = int(m.pop("unreachable_per_row")
                               * self.cfg["rows"])
        self.engine = vi.serve(
            k=self.k, max_batch=e["max_batch"],
            max_ops_per_drain=e["max_ops_per_drain"], tau=e["tau"],
            backup_capacity=e["backup_capacity"],
            maintenance=api.MaintenancePolicy(**m))
        del vi
        self.spans.wrap(self.engine.batcher, "flush", "serve")
        self.spans.wrap(self.engine.scheduler, "drain", "drain")
        self.spans.wrap(self.engine, "_maybe_maintain", "maintain")
        self.epoch_ops[self.engine.epoch] = 0
        warm = self.Q[:e["max_batch"]]
        for _ in range(self.tr["warmup_pumps"]):
            for q in warm:
                self.engine.search(q)
            self.top_up()
            self.pump()
        sync(self.device)

    def top_up(self) -> None:
        while self.engine.update_backlog < self.tr["standing_ops"]:
            old, new, x = self.stream.next()
            self.engine.delete(old)
            self.engine.update(x, new)

    def pump(self, **kwargs):
        with self.spans.span("pump"):
            st = self.engine.pump(**kwargs)
        self.applied += st.updates_applied
        self.epoch_ops[st.epoch] = self.applied
        return st

    def _submit(self, t0: float, upto: float) -> None:
        self._due(upto)
        while self.arrivals[self.next_query] <= upto:
            i = self.next_query
            sub = time.perf_counter() - t0
            tk = self.engine.search(self.Q[i % self.P])
            self.tickets.append((i, float(self.arrivals[i]), sub, tk))
            self.next_query += 1

    def restart(self, rate: float) -> None:
        """A new window at another query rate (the knee sweep): fresh
        arrivals, the index and the update stream as they stand."""
        self.rate = rate
        self.arrivals = np.empty(0)
        self.next_query = 0
        self.tickets = []
        self.clock = 0.0

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        c0 = t0 - self.clock         # the arrivals' clock reads 0 at c0
        first = len(self.tickets)
        applied0, pumps = self.applied, 0
        backlog = []                 # (pump start, queries it serves)
        while True:
            now = time.perf_counter() - c0
            before = self.next_query
            self._submit(c0, now)
            backlog.append((now, self.next_query - before))
            self.top_up()
            self.pump()
            pumps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        t1 = time.perf_counter()
        applied = self.applied - applied0
        # every query due in the window is answered, late if need be
        end = self.clock = t1 - c0
        self._due(end)
        while self.arrivals[self.next_query] < end:
            i = self.next_query
            tk = self.engine.search(self.Q[i % self.P])
            self.tickets.append((i, float(self.arrivals[i]),
                                 time.perf_counter() - c0, tk))
            self.next_query += 1
        late = time.perf_counter() + 60.0
        while self.engine.query_backlog and time.perf_counter() < late:
            self.pump(max_updates=0)
        mine = self.tickets[first:]
        lat = np.array([(sub - due + tk.latency_s) * 1e3
                        for _, due, sub, tk in mine if tk.done])
        return {"t0": t0, "t1": t1, "window_s": t1 - t0,
                "queries": len(mine), "answered": len(lat),
                "updates": applied / 2.0, "ops": applied, "pumps": pumps,
                "backlog": backlog,
                "latency_ms": lat,
                "submit_lag_ms": np.array([(sub - due) * 1e3 for _, due,
                                           sub, _ in mine])}

    def probe(self, n: int = 1024) -> Answers:
        """Answers of ``n`` more queries, served with no update drained."""
        base = self.next_query
        tks = [self.engine.search(self.Q[(base + j) % self.P])
               for j in range(n)]
        while self.engine.query_backlog:
            self.pump(max_updates=0)
        ep = self._groups()[1]
        return Answers(np.array([(base + j) % self.P for j in range(n)]),
                       np.array([ep[t.epoch] for t in tks], np.int64),
                       np.stack([t.labels for t in tks]),
                       np.stack([t.dists for t in tks]))

    def program_readings(self) -> dict:
        """What the published index holds against the replay of every
        update the benchmark submitted and saw published."""
        ix = self.engine.snapshot().index
        live = ((ix.levels >= 0) & ~ix.deleted).cpu().numpy()
        have = set(ix.labels.cpu().numpy()[live].tolist())
        birth, death = self.stream.birth_death()
        want = set(np.nonzero(live_mask(birth, death, self.applied))[0]
                   .tolist())
        return {"unanswered": sum(1 for *_, tk in self.tickets
                                  if not tk.done),
                "live_set_diff": len(have ^ want)}

    def free(self) -> None:
        self.engine = None

    def _groups(self):
        """Epochs the answers were served at, each as one group."""
        epochs = sorted(self.epoch_ops)
        return epochs, {e: i for i, e in enumerate(epochs)}

    def reference_inputs(self):
        X = np.concatenate([self.X, self.stream.rows()])
        birth, death = self.stream.birth_death()
        epochs, gi = self._groups()
        groups = np.stack([live_mask(birth, death, self.epoch_ops[e])
                           for e in epochs])
        done = [(i, tk) for i, _, _, tk in self.tickets if tk.done]
        ans = Answers(np.array([i % self.P for i, _ in done], np.int64),
                      np.array([gi[tk.epoch] for _, tk in done], np.int64),
                      np.stack([tk.labels for _, tk in done]),
                      np.stack([tk.dists for _, tk in done]))
        return X, self.Q, groups, ans
