"""ANN serving driver: the paper's system end-to-end, on ``repro_torch.api``.

Creates a :class:`~repro_torch.api.VectorIndex` over a synthetic corpus (any
registered metric space via ``--space``), then hands it to a
:class:`~repro_torch.serving.ServingEngine` with ``.serve()``: single
queries coalesce in the micro-batcher and are tier-routed by the query
planner (``--mode auto|graph|exact``), a stream of delete/replace ops
drains through the wave executor, tau-triggered backup rebuilds keep
unreachable points servable (dualSearch), ``--maintenance`` turns on the
health-driven policy (delete consolidation + unreachable repair between
ticks), and every query batch runs against a stable epoch snapshot.
Reports QPS, update lag, recall@k vs exact brute force, and unreachable
counts per epoch; ``--metrics-json`` dumps the registry. Runs on the GPU
unless ``--device cpu``:

  python -m repro_torch.launch.serve --n 5000 --dim 64 \\
      --strategy mn_ru_gamma --rounds 10 --updates-per-round 100
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import api
from ..core.maintenance import index_health
from ..data import clustered_vectors, exact_knn


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the index lives (default cuda; cpu runs "
                         "the kernels' plain versions)")
    ap.add_argument("--n", type=int, default=5000)
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--queries", type=int, default=200)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--ef", type=int, default=64)
    ap.add_argument("--M", type=int, default=8)
    ap.add_argument("--space", default="l2", choices=api.list_metrics())
    ap.add_argument("--strategy", "--variant", dest="strategy",
                    default="mn_ru_gamma", choices=api.list_strategies())
    ap.add_argument("--mode", default="auto", choices=api.MODES,
                    help="query execution tier: auto = planner-routed per "
                         "bucket, graph = HNSW beam search, exact = the "
                         "topk_dist scan tier")
    ap.add_argument("--execution", default="wave",
                    choices=("wave", "sequential"),
                    help="update-tape executor: wave = conflict-free "
                         "batched waves, sequential = one op at a time "
                         "(parity baseline)")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--updates-per-round", type=int, default=100)
    ap.add_argument("--backup", action="store_true",
                    help="enable tau-triggered backup index + dualSearch")
    ap.add_argument("--maintenance", action="store_true",
                    help="enable the health-driven maintenance policy: "
                         "delete consolidation + unreachable-point repair "
                         "between pump() ticks")
    ap.add_argument("--maint-deleted-frac", type=float, default=0.25,
                    help="consolidate when the mark-deleted fraction of "
                         "allocated slots reaches this")
    ap.add_argument("--maint-min-deleted", type=int, default=32,
                    help="...and at least this many slots are mark-deleted")
    ap.add_argument("--maint-unreachable", type=int, default=0,
                    help="repair when the Definition-1 unreachable count "
                         "exceeds this")
    ap.add_argument("--maint-every", type=int, default=1,
                    help="consult the health report every N pump() ticks "
                         "(the engine's maintain_every)")
    ap.add_argument("--tau", type=int, default=400)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--max-ops-per-drain", type=int, default=128)
    ap.add_argument("--metrics-json", default="",
                    help="path to dump the metrics registry as JSON")
    args = ap.parse_args(argv)

    def sync():
        if torch.device(args.device).type == "cuda":
            torch.cuda.synchronize()

    rng = np.random.default_rng(0)
    X = clustered_vectors(args.n, args.dim, seed=0)
    Q = clustered_vectors(args.queries, args.dim, seed=1)

    vindex = api.create(space=args.space, dim=args.dim, capacity=args.n,
                        M=args.M, ef_construction=args.ef,
                        strategy=args.strategy, ef_search=args.ef,
                        device=args.device)
    print(f"building {vindex!r} over {args.n} x {args.dim} ...", flush=True)
    t0 = time.time()
    vindex.add_items(X)
    sync()
    print(f"  built in {time.time() - t0:.1f}s")

    policy = None
    if args.maintenance:
        policy = api.MaintenancePolicy(
            deleted_frac=args.maint_deleted_frac,
            min_deleted=args.maint_min_deleted,
            unreachable=args.maint_unreachable)
    engine = vindex.serve(
        k=args.k, max_batch=args.max_batch,
        max_ops_per_drain=args.max_ops_per_drain,
        tau=args.tau if args.backup else 0,
        backup_capacity=max(args.n // 8, 64) if args.backup else 0,
        track_unreachable=True, mode=args.mode, maintenance=policy,
        maintain_every=args.maint_every, execution=args.execution)

    next_label = args.n
    live = dict(enumerate(range(args.n)))  # label -> row id in X_all
    X_all = [X]

    for rnd in range(args.rounds):
        # --- update stream: enqueue deletes + replacements ------------------
        del_labels = rng.choice(sorted(live), size=args.updates_per_round,
                                replace=False).astype(np.int32)
        newX = clustered_vectors(args.updates_per_round, args.dim,
                                 seed=100 + rnd)
        new_labels = np.arange(next_label,
                               next_label + args.updates_per_round,
                               dtype=np.int32)
        next_label += args.updates_per_round
        for dl in del_labels:
            engine.delete(int(dl))
        for x, nl in zip(newX, new_labels):
            engine.update(x, int(nl))

        # --- queries coalesce in the micro-batcher --------------------------
        tickets = [engine.search(q) for q in Q]
        pre_live = dict(live)              # live set at the snapshot epoch

        # --- one maintenance cycle: serve, drain, rebuild, publish ----------
        t0 = time.time()
        engine.pump()                      # queries see the PRE-round epoch
        lag = engine.update_backlog        # ops still queued after one cycle
        while engine.update_backlog:       # drain the round's ops fully
            engine.pump()
        sync()
        dt = time.time() - t0

        for dl in del_labels:
            del live[int(dl)]
        base = sum(x.shape[0] for x in X_all)
        for i, nl in enumerate(new_labels):
            live[int(nl)] = base + i
        X_all.append(newX)

        # --- recall vs exact over the snapshot-epoch live set ---------------
        lab_np = np.stack([t.result()[0] for t in tickets])
        Xcat = np.concatenate(X_all)
        pre_labels = np.fromiter(pre_live.keys(), dtype=np.int64)
        pre_rows = Xcat[[pre_live[int(l)] for l in pre_labels]]
        gt = pre_labels[exact_knn(pre_rows, Q, args.k, args.space)]
        recall = np.mean([len(set(lab_np[i]) & set(gt[i])) / args.k
                          for i in range(len(Q))])
        u = engine.metrics
        q_lat = u.histogram("batch_latency_ms").summary()
        print(f"round {rnd:3d}: epoch {engine.epoch}"
              f" | cycle {dt * 1e3:7.1f} ms"
              f" | qps {len(Q) / max(dt, 1e-9):8.1f}"
              f" | lag {lag}"
              f" | waves {int(u.gauge('waves_per_pump'))}"
              f" | recall@{args.k} {recall:.4f}"
              f" | batch p99 {q_lat['p99']:.1f} ms"
              f" | unreachable indeg="
              f"{int(u.gauge('unreachable_indegree'))}"
              f" bfs={int(u.gauge('unreachable_bfs'))}",
              flush=True)

    # --- final recall against the fully-churned live set --------------------
    tickets = [engine.search(q) for q in Q]
    engine.pump()
    lab_np = np.stack([t.result()[0] for t in tickets])
    Xcat = np.concatenate(X_all)
    live_labels = np.fromiter(live.keys(), dtype=np.int64)
    live_rows = Xcat[[live[int(l)] for l in live_labels]]
    gt = live_labels[exact_knn(live_rows, Q, args.k, args.space)]
    recall = np.mean([len(set(lab_np[i]) & set(gt[i])) / args.k
                      for i in range(len(Q))])
    print(f"final recall@{args.k} over live set: {recall:.4f}")
    print(f"final health: {index_health(engine.snapshot().index)!r}")
    print(engine.metrics.report())
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            f.write(engine.metrics.dumps())
        print(f"metrics -> {args.metrics_json}")
    return recall


if __name__ == "__main__":
    main()
