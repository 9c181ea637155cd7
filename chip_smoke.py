#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--n 1048576] [--out results.json]

Phases, each of which exits nonzero on failure:

  1. the card's name and power limit, the torch version, and the build of
     the ``topk_dist`` CUDA kernel from ``src/repro_torch/kernels``;
  2. the kernel against its plain PyTorch version on the card (l2 and ip,
     the reference's test shapes, a ~30% mask, fewer than k eligible rows,
     an empty batch, and the exact tier's main-path shape 64 x N x 128),
     with times, the bound and a library yardstick;
  3. the main path at the paper's SIFT1M shape: wave build, 5 rounds of 1%
     MN-RU-gamma churn, queries (graph and exact tier) with recall against
     the kernel's exact ground truth, unreachable counts, then a backup
     index and dualSearch; structural checks on the index;
  4. the paper's strategy comparison at N = 65,536: 3 rounds of 5% churn
     under each of the five strategies.

The line before the last is the kernel report (JSON); the last line is
``{"ok": true, "device": {...}}``. Imports neither JAX nor the reference.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-4                     # kernel vs plain version, relative and absolute
PEAK_F32_FLOPS = 67e12         # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12           # H100 SXM HBM3
K = 10


def log(*a):
    print(*a, flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def same_up_to_ties(dv, iv, dr, ir, tol=TOL):
    """Distances within ``tol``; id sets equal except for ties at the k-th
    distance (the kernel and the plain version sum in different orders)."""
    import numpy as np
    dv, iv, dr, ir = (t.cpu().numpy() for t in (dv, iv, dr, ir))
    if not np.allclose(dv, dr, rtol=tol, atol=tol, equal_nan=False):
        return False
    for r in range(dv.shape[0]):
        a = dict(zip(iv[r].tolist(), dv[r].tolist()))
        b = dict(zip(ir[r].tolist(), dr[r].tolist()))
        if a.keys() == b.keys():
            continue
        fin = dr[r][np.isfinite(dr[r])]
        kth = fin.max() if fin.size else np.inf
        if any(abs(a.get(i, b.get(i)) - kth) > tol * (1 + abs(kth))
               for i in a.keys() ^ b.keys()):
            return False
    return True


def cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# ---------------------------------------------------------------------------
# phase 2: the kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_phase(N_main):
    import numpy as np
    import torch
    from repro_torch.kernels.topk_dist import topk_dist, topk_dist_ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    max_err = 0.0

    def compare(Q, Y, k, metric, mask=None, what=""):
        nonlocal max_err
        dv, iv = topk_dist(Q, Y, k, metric=metric, mask=mask)
        torch.cuda.synchronize()
        dr, ir = topk_dist_ref(Q, Y, k, metric=metric, mask=mask)
        check(same_up_to_ties(dv, iv, dr, ir), f"topk_dist {what} {metric}")
        fin = torch.isfinite(dr)
        check(bool((torch.isfinite(dv) == fin).all())
              and bool((iv[~fin] == -1).all()), f"padding {what} {metric}")
        if fin.any():
            max_err = max(max_err, float((dv[fin] - dr[fin]).abs().max()))
        return dv, iv

    def rand(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=dev)

    for metric in ("l2", "ip"):
        for q, n, d, k in [(8, 600, 16, 10), (3, 1000, 32, 5),
                           (16, 100, 8, 100), (1, 2048, 64, 1)]:
            compare(rand(q, d), rand(n, d), k, metric, what=f"{q}x{n}x{d}")
        mask = torch.tensor(rng.random(100_000) > 0.3, device=dev)
        compare(rand(64, 128), rand(100_000, 128), K, metric, mask,
                "30% masked")
        few = torch.zeros(500, dtype=torch.bool, device=dev)
        few[[5, 99, 250, 251, 499]] = True
        dv, iv = compare(rand(4, 32), rand(500, 32), 16, metric, few,
                         "5 eligible")
        check(bool((iv[:, 5:] == -1).all()) and bool(torch.isinf(
            dv[:, 5:]).all()), "(inf, -1) padding")
        d0, i0 = topk_dist(rand(0, 32), rand(500, 32), 8, metric=metric)
        check(d0.shape == (0, 8) and i0.shape == (0, 8), "empty batch")
    log("kernel phase: small shapes agree with the plain version")

    # the exact tier's main-path shape: a serving batch of 64 over N rows
    Q, Y = rand(64, 128), rand(N_main, 128)
    mask = torch.tensor(rng.random(N_main) > 0.01, device=dev)
    for metric in ("l2", "ip"):
        compare(Q, Y, K, metric, mask, f"64x{N_main}x128")
    ms = cuda_ms(lambda: topk_dist(Q, Y, K, mask=mask), 20)
    plain_ms = cuda_ms(lambda: topk_dist_ref(Q, Y, K, mask=mask), 3)

    def library():
        D = torch.cdist(Q, Y, compute_mode="use_mm_for_euclid_dist")
        return torch.topk(D.masked_fill_(~mask, float("inf")), K, dim=1,
                          largest=False)
    library_ms = cuda_ms(library, 5)
    nq, d = Q.shape
    bytes_ = 4 * (nq * d + N_main * d) + N_main + nq * K * 8
    ops = 2 * nq * N_main * d + 2 * (nq + N_main) * d + 3 * nq * N_main
    t_bytes, t_ops = bytes_ / PEAK_BYTES * 1e3, ops / PEAK_F32_FLOPS * 1e3
    log(f"topk_dist 64x{N_main}x128 k={K} l2: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library (cdist+topk) {library_ms:.4f} ms, "
        f"bound {max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f}, "
        f"operations {t_ops:.4f}), max abs err {max_err:.3g}")
    return {"name": "topk_dist", "route": "cuda",
            "source": "src/repro_torch/kernels/topk_dist/csrc/topk_dist.cu",
            "replaces": "src/repro/kernels/topk_dist/topk_dist.py:99",
            "launches": 0, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": library_ms}


# ---------------------------------------------------------------------------
# phase 3: the main path at full size
# ---------------------------------------------------------------------------

class Live:
    """Host-side bookkeeping of which labels are live and their vectors."""

    #: kernel launches of the ground truth (the smoke's, not the port's)
    truth_launches = 0

    def __init__(self, X):
        import numpy as np
        self.X = [X]
        self.live = np.ones(len(X), bool)

    def add(self, X):
        import numpy as np
        self.X.append(X)
        self.live = np.concatenate([self.live, np.ones(len(X), bool)])

    def labels(self):
        import numpy as np
        return np.nonzero(self.live)[0]

    def truth(self, Q, k):
        """Exact k-NN labels over the live set, on the kernel."""
        import numpy as np
        import torch
        from repro_torch.kernels.topk_dist import topk_dist
        lab = self.labels()
        Xl = torch.from_numpy(np.concatenate(self.X)[lab]).to(Q.device)
        before = topk_dist.launches
        _, ids = topk_dist(Q, Xl, k)
        Live.truth_launches += topk_dist.launches - before
        return lab[ids.cpu().numpy()]


def recall(found, truth):
    import numpy as np
    return float(np.mean([len(set(f.tolist()) & set(t.tolist())) / len(t)
                          for f, t in zip(found, truth)]))


def structural_check(index, live, returned_labels):
    """Every live label in exactly one slot, ``count`` right, neighbour ids
    in range and allocated, no mark-deleted label ever returned."""
    import numpy as np
    alloc = index.levels >= 0
    live_slots = alloc & ~index.deleted
    lab = index.labels[live_slots].cpu().numpy()
    check(len(np.unique(lab)) == len(lab), "a live label sits in two slots")
    check(np.array_equal(np.sort(lab), live.labels()),
          "live labels differ from the bookkeeping")
    check(int(index.count) == int(alloc.sum()), "count != allocated slots")
    nb = index.neighbors
    N = index.capacity
    check(bool(((nb >= -1) & (nb < N)).all()), "neighbour id out of range")
    tgt = nb[nb >= 0].long()
    check(bool(alloc[tgt].all()), "neighbour points at a free slot")
    ret = np.unique(returned_labels[returned_labels >= 0])
    check(bool(live.live[ret].all()), "a deleted label was returned")


def main_path(N, seed=0, dev="cuda"):
    import numpy as np
    import torch
    import repro_torch.core as T
    from repro_torch.data import clustered_vectors
    from repro_torch.kernels.topk_dist import topk_dist_ref

    params = T.HNSWParams(M=16, M0=32, num_layers=4, ef_construction=64,
                          ef_search=64, space="l2")
    churn = int(round(0.01 * N))
    out = {"N": N, "churn_per_round": churn, "rounds": []}
    gen = torch.Generator().manual_seed(seed)
    X = clustered_vectors(N, 128, seed=0)
    live = Live(X)
    Q = torch.from_numpy(clustered_vectors(1000, 128, seed=0,
                                           noise_seed=1)).to(dev)

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    index = T.build(params, X, execution="wave", generator=gen, device=dev)
    sync()
    out["build_s"] = time.perf_counter() - t0
    check(int(index.count) == N, "build count")
    log(f"main path: wave build of {N} points in {out['build_s']:.1f} s, "
        f"count {int(index.count)}, max_layer {int(index.max_layer)}")

    def measure(tag):
        sync()
        t = time.perf_counter()
        labels, _, _ = T.batch_knn(params, index, Q, K)
        sync()
        q_s = time.perf_counter() - t
        labels = labels.cpu().numpy()
        truth = live.truth(Q, K)
        g_rec = recall(labels, truth)
        el, ei, ed = T.exact_scan(params, index, Q[:64], K)
        eligible = (index.levels >= 0) & ~index.deleted
        rd, ri = topk_dist_ref(Q[:64], index.vectors, K, mask=eligible)
        # recall 1.0 against the plain version, ties at the k-th distance
        # counted as hits (the two sum in different orders)
        check(same_up_to_ties(ed, ei, rd, ri), f"exact_scan {tag}")
        e_rec = 1.0
        e_raw = recall(ei.cpu().numpy(), ri.cpu().numpy())
        check(recall(el.cpu().numpy(), truth[:64]) >= 0.99,
              f"exact_scan vs ground truth {tag}")
        u_def1, u_bfs = T.count_unreachable(index)
        structural_check(index, live, labels)
        rec = {"tag": tag, "graph_recall": g_rec, "exact_recall": e_rec,
               "exact_recall_untied": e_raw, "unreachable_def1": u_def1,
               "unreachable_bfs": u_bfs, "query_s": q_s}
        log(f"  {tag}: graph recall@{K} {g_rec:.4f}, exact_scan recall "
            f"{e_rec:.1f}, unreachable def1 {u_def1} bfs {u_bfs}, "
            f"1000 queries {q_s:.2f} s")
        return rec

    out["after_build"] = measure("after build")
    rng = np.random.default_rng(seed + 7)
    next_label = N
    for r in range(5):
        dels = rng.choice(live.labels(), churn, replace=False)
        newX = clustered_vectors(churn, 128, seed=0, noise_seed=100 + r)
        new_labels = np.arange(next_label, next_label + churn)
        ops = np.concatenate([np.full(churn, T.OP_DELETE),
                              np.full(churn, T.OP_REPLACE)]).astype(np.int32)
        labels = np.concatenate([dels, new_labels]).astype(np.int32)
        Xt = np.concatenate([np.zeros_like(newX), newX])
        sync()
        t = time.perf_counter()
        T.apply_update_batch(params, index, ops, labels, Xt, "mn_ru_gamma",
                             execution="wave", generator=gen)
        sync()
        churn_s = time.perf_counter() - t
        live.live[dels] = False
        live.add(newX)
        next_label += churn
        rec = measure(f"round {r + 1}")
        rec["churn_s"] = churn_s
        log(f"  round {r + 1}: {churn} deletes + {churn} replaces in "
            f"{churn_s:.2f} s")
        out["rounds"].append(rec)

    t = time.perf_counter()
    backup = T.rebuild_backup(params, index, 8192, seed=1, generator=gen)
    sync()
    out["backup_s"] = time.perf_counter() - t
    out["backup_points"] = int(backup.count)
    truth = live.truth(Q, K)
    dl, _ = T.batch_dual_search(params, index, params, backup, Q, K)
    gl, _, _ = T.batch_knn(params, index, Q, K)
    out["recall_dual"] = recall(dl.cpu().numpy(), truth)
    out["recall_main_only"] = recall(gl.cpu().numpy(), truth)
    structural_check(index, live, dl.cpu().numpy())
    log(f"  backup: {out['backup_points']} unreachable points backed up in "
        f"{out['backup_s']:.1f} s; recall@{K} with dualSearch "
        f"{out['recall_dual']:.4f}, main only {out['recall_main_only']:.4f}")
    first, last = out["after_build"]["graph_recall"], \
        out["rounds"][-1]["graph_recall"]
    check(last >= 0.9 * first, f"recall after churn {last:.4f} < 0.9 x "
                               f"{first:.4f}")
    return out


# ---------------------------------------------------------------------------
# phase 4: the paper's strategy comparison at reduced size
# ---------------------------------------------------------------------------

def strategy_phase(N=65_536, rounds=3, share=0.05, seed=0, dev="cuda"):
    import numpy as np
    import torch
    import repro_torch.core as T
    from repro_torch.data import clustered_vectors

    params = T.HNSWParams(M=16, M0=32, num_layers=4, ef_construction=64,
                          ef_search=64)
    X = clustered_vectors(N, 128, seed=0)
    Q = torch.from_numpy(clustered_vectors(200, 128, seed=0,
                                           noise_seed=1)).to(dev)
    t = time.perf_counter()
    base = T.build(params, X, execution="wave",
                   generator=torch.Generator().manual_seed(seed), device=dev)
    log(f"strategies: build of {N} points in {time.perf_counter() - t:.1f} s")
    churn = int(round(share * N))
    out = {}
    for variant in T.BUILTIN_STRATEGIES:
        index, live = base.clone(), Live(X)
        gen = torch.Generator().manual_seed(seed + 1)
        rng = np.random.default_rng(seed + 3)
        rows = []
        for r in range(rounds):
            dels = rng.choice(live.labels(), churn, replace=False)
            newX = clustered_vectors(churn, 128, seed=0, noise_seed=200 + r)
            new_labels = np.arange(N + r * churn, N + (r + 1) * churn)
            ops = np.concatenate([np.full(churn, T.OP_DELETE),
                                  np.full(churn, T.OP_REPLACE)]).astype(
                np.int32)
            labels = np.concatenate([dels, new_labels]).astype(np.int32)
            t = time.perf_counter()
            T.apply_update_batch(params, index, ops, labels,
                                 np.concatenate([np.zeros_like(newX), newX]),
                                 variant, execution="wave", generator=gen)
            if dev == "cuda":
                torch.cuda.synchronize()
            churn_s = time.perf_counter() - t
            live.live[dels] = False
            live.add(newX)
            found, _, _ = T.batch_knn(params, index, Q, K)
            rec = recall(found.cpu().numpy(), live.truth(Q, K))
            u_def1, u_bfs = T.count_unreachable(index)
            rows.append({"round": r + 1, "recall": rec, "def1": u_def1,
                         "bfs": u_bfs, "churn_s": churn_s})
            log(f"  {variant} round {r + 1}: unreachable def1 {u_def1} bfs "
                f"{u_bfs}, recall@{K} {rec:.4f}, churn {churn_s:.2f} s")
        out[variant] = rows
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20,
                    help="main-path index size (default: SIFT1M's 2^20)")
    ap.add_argument("--out", default=None, help="write all results as JSON")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi: no output"
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    from repro_torch.kernels.topk_dist import topk_dist
    from repro_torch.kernels.topk_dist.topk_dist import LIBRARY
    LIBRARY.get()
    log(f"topk_dist kernel built in {LIBRARY.build_seconds:.1f} s")
    for line in LIBRARY.build_log.splitlines():
        if "registers" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")

    if args.n != 1 << 20:
        log(f"cut: main-path N = {args.n} instead of {1 << 20}")
    results = {"card": card, "torch": torch.__version__}
    report = kernel_phase(args.n)
    topk_dist.launches = Live.truth_launches = 0
    results["main_path"] = main_path(args.n)
    # the port's own launches (exact_scan); the ground truth's apart
    report["launches"] = topk_dist.launches - Live.truth_launches
    report["ground_truth_launches"] = Live.truth_launches
    check(report["launches"] > 0, "the main path never launched topk_dist")
    log(f"main path launched topk_dist {report['launches']} times in the "
        f"port, {Live.truth_launches} more for the ground truth")
    results["strategies"] = strategy_phase()
    results["kernels"] = [report]
    results["seconds"] = time.perf_counter() - t_start
    log(f"chip_smoke: {results['seconds']:.1f} s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    print(json.dumps({"kernels": [report]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
