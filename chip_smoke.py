#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--n 1048576] [--out results.json]

Phases, each of which exits nonzero on failure:

  1. the card's name and power limit, the torch version, and the build of
     the three CUDA kernels from ``src/repro_torch/kernels`` (one ``nvcc``
     each, all at once), with each kernel's ``ptxas`` registers;
  2. each kernel against its plain PyTorch version on the card, with times,
     the bound and a library yardstick: ``topk_dist`` (l2 and ip, the
     reference's test shapes, a ~30% mask, fewer than k eligible rows, an
     empty batch, duplicate rows (ties), rows of norm ~1e4 (the l2 form's
     cancellation), the exact tier's main-path shape 64 x N x 128, and the
     1,000-query ground-truth call over it),
     ``l2dist`` (a serving batch against the index, 64 x N x 128, f32 and
     bf16, l2 and ip, plus the test shapes) and ``embed_bag`` (wide-deep's
     1,000,000 x 32 table, 4096 bags of 32 with ~10% padding, sum and
     mean, plus the test shapes); each wrapper is first driven through its
     public entry point at those shapes, and its launches counted;
  3. the main path at the paper's SIFT1M shape: wave build, 5 rounds of 1%
     MN-RU-gamma churn, queries (graph and exact tier) with recall against
     the kernel's exact ground truth, unreachable counts, then a backup
     index and dualSearch; structural checks on the index;
  4. the paper's strategy comparison at N = 65,536: 3 rounds of 5% churn
     under each of the five strategies;
  5. the ``VectorIndex`` facade and maintenance at N = 65,536: build, 3
     rounds of 5% deletes + replaces with 1% more deletes left pending,
     health, consolidation, unreachable repair (Definition 1 to 0), queries
     in every tier, compaction, and a save/load round trip;
  6. the serving engine over phase 3's churned index: 3,072 single queries
     interleaved with 1% deletes + 1% replaces over 3 epochs, with a
     policy that consolidates, every ticket checked against exact ground
     truth over its epoch's live set;
  7. the sharded index and the sharded serving engine: 2^19 x 128 in 4
     shards placed on this host's devices (all on one card when there is
     one), recall of the merged answer and its equality with the stable
     merge of the shards' own answers, then 3 epochs of 1,024 single
     queries interleaved with 128 deletes, 128 replaces and 32 fresh
     inserts routed to their owner shards (half of 256 / 256 / 64, to
     keep the smoke's time; logged as a cut).

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
PEAK_TF32_FLOPS = 495e12       # H100 SXM, TF32 dense on the tensor cores
PEAK_BF16_FLOPS = 989e12       # H100 SXM, bf16 dense on the tensor cores
#: the fastest exact-f32 route: 3xTF32 (three TF32 products per product)
PEAK_EXACT_F32_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_BYTES = 3.35e12           # H100 SXM HBM3
K = 10
REPAIR_PASSES = 10             # sweeps of repair_unreachable in phase 5


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


def events_ms(fn, reps):
    """Milliseconds per call between CUDA events around ``reps`` calls: the
    device time when the calls keep the card busy, else the host's enqueue
    time."""
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


TIMINGS = []      # every (events ms, device ms) pair, for the --out file


def cuda_ms(fn, reps):
    """Device milliseconds per call: the sum of the kernels the calls ran,
    from ``torch.profiler``. Fails when the profiler shows no device time:
    every ``ms`` of the kernel report comes from this one timer. The
    CUDA-event time of the same calls is kept beside it in ``TIMINGS``, as
    a diagnostic only."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    ev = events_ms(fn, reps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    check(us > 0, "torch.profiler recorded no device time")
    dev = us / 1e3 / reps
    TIMINGS.append({"events_ms": ev, "device_ms": dev})
    return dev


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

    def compare(Q, Y, k, metric, mask=None, what="", track=True):
        """Kernel against plain version; ``track`` adds the case to the
        max abs error (of inputs with entries ~N(0, 1))."""
        nonlocal max_err
        dv, iv = topk_dist(Q, Y, k, metric=metric, mask=mask)
        torch.cuda.synchronize()
        dr, ir = topk_dist_ref(Q, Y, k, metric=metric, mask=mask)
        check(same_up_to_ties(dv, iv, dr, ir), f"topk_dist {what} {metric}")
        fin = torch.isfinite(dr)
        check(bool((torch.isfinite(dv) == fin).all())
              and bool((iv[~fin] == -1).all()), f"padding {what} {metric}")
        if fin.any() and track:
            max_err = max(max_err, float((dv[fin] - dr[fin]).abs().max()))
        return dv, iv, dr

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
        dv, iv, _ = compare(rand(4, 32), rand(500, 32), 16, metric, few,
                            "5 eligible")
        check(bool((iv[:, 5:] == -1).all()) and bool(torch.isinf(
            dv[:, 5:]).all()), "(inf, -1) padding")
        d0, i0 = topk_dist(rand(0, 32), rand(500, 32), 8, metric=metric)
        check(d0.shape == (0, 8) and i0.shape == (0, 8), "empty batch")
        base = rand(300, 128)                 # every row four times: ties
        dv, iv, _ = compare(base[:64] + 0.3 * rand(64, 128),
                            torch.cat([base, base, base[:77], base]), 12,
                            metric, what="duplicate rows")
        ordered = (dv[:, :-1] < dv[:, 1:]) | ((dv[:, :-1] == dv[:, 1:])
                                             & (iv[:, :-1] < iv[:, 1:]))
        check(bool(ordered.all()), "order by (distance, id)")
    # |q|^2 + |y|^2 ~ 2e8 cancelling 20-fold (tests/test_torch_cuda.py)
    big = rand(4099, 128) * (1e4 / 128 ** 0.5)
    dv, _, dr = compare(big[:65] + rand(65, 128) * (3e3 / 128 ** 0.5), big,
                        K, "l2", what="norm 1e4", track=False)
    log(f"kernel phase: small shapes agree with the plain version; rows of "
        f"norm 1e4: max rel err {float(((dv - dr) / dr).abs().max()):.3g}")

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
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_EXACT_F32_FLOPS * 1e3
    t_fma = ops / PEAK_F32_FLOPS * 1e3
    # the ground truth's call: 1,000 queries over the same rows
    Qg = rand(1000, 128)
    compare(Qg, Y, K, "l2", what=f"1000x{N_main}x128")
    truth_ms = cuda_ms(lambda: topk_dist(Qg, Y, K), 3)
    log(f"topk_dist 64x{N_main}x128 k={K} l2: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library (cdist+topk) {library_ms:.4f} ms, "
        f"bound {max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f}, "
        f"operations {t_ops:.4f} as 3xTF32; {t_fma:.4f} on the f32 FMA "
        f"route), max abs err {max_err:.3g}; 1000 queries (the ground "
        f"truth's call) {truth_ms:.4f} ms")
    return {"name": "topk_dist", "route": "cuda",
            "source": "src/repro_torch/kernels/topk_dist/csrc/topk_dist.cu",
            "replaces": "src/repro/kernels/topk_dist/topk_dist.py:99",
            "launches": 0, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": library_ms}, {"fma_route_ms": t_fma,
                                        "truth_1000_ms": truth_ms}


def l2dist_phase(N_main):
    """``l2dist`` through its entry point at a serving batch against the
    index (64 x N x 128), then against its plain version."""
    import numpy as np
    import torch
    from repro_torch.kernels.l2dist import l2dist, l2dist_ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)

    def rand(*shape, dtype=torch.float32):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=dev).to(dtype)

    Q, Y = rand(64, 128), rand(N_main, 128)
    Qb, Yb = Q.to(torch.bfloat16), Y.to(torch.bfloat16)
    # the path: the public entry point at the main shapes
    l2dist.launches = 0
    outs = {("l2", "f32"): l2dist(Q, Y),
            ("ip", "f32"): l2dist(Q, Y, metric="ip"),
            ("l2", "bf16"): l2dist(Qb, Yb),
            ("ip", "bf16"): l2dist(Qb, Yb, metric="ip")}
    torch.cuda.synchronize()
    launches = l2dist.launches
    check(launches == 4, "l2dist entry point did not launch its kernel")

    max_err = 0.0

    def compare(out, X, Yy, metric, what, track=True):
        nonlocal max_err
        ref = l2dist_ref(X, Yy, metric=metric)
        check(torch.allclose(out, ref, rtol=TOL, atol=TOL),
              f"l2dist {what} {metric}")
        if track:
            max_err = max(max_err, float((out - ref).abs().max()))
        return float(((out - ref).abs() / (1 + ref.abs())).max())

    for (metric, dt), out in outs.items():
        X, Yy = (Q, Y) if dt == "f32" else (Qb, Yb)
        compare(out, X, Yy, metric, f"64x{N_main}x128 {dt}")
    for dtype in (torch.float32, torch.bfloat16):
        for q, n, d in [(8, 16, 8), (100, 300, 48), (130, 513, 32),
                        (1, 1000, 128), (257, 64, 7)]:
            X, Yy = rand(q, d, dtype=dtype), rand(n, d, dtype=dtype)
            for metric in ("l2", "ip"):
                compare(l2dist(X, Yy, metric=metric), X, Yy, metric,
                        f"{q}x{n}x{d} {dtype}")
    # |q|^2 + |y|^2 ~ 2e8 cancelling 20-fold (tests/test_torch_cuda.py)
    big = rand(4099, 128) * (1e4 / 128 ** 0.5)
    near = big[:65] + rand(65, 128) * (3e3 / 128 ** 0.5)
    rel = compare(l2dist(near, big), near, big, "l2", "norm 1e4", track=False)
    log(f"l2dist: every shape agrees with the plain version; rows of norm "
        f"1e4: max rel err {rel:.3g}")

    def bound(nq, n, d, itemsize, peak_ops):
        bytes_ = itemsize * (nq + n) * d + 4 * nq * n
        ops = 2 * nq * n * d + 2 * (nq + n) * d + 3 * nq * n
        t_b, t_o = bytes_ / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
        return max(t_b, t_o), "bytes" if t_b > t_o else "operations"

    res = {"f32_fma_route_ms": bound(64, N_main, 128, 4, PEAK_F32_FLOPS)[0]}
    for dt, (X, Yy), itemsize, peak in (("f32", (Q, Y), 4,
                                         PEAK_EXACT_F32_FLOPS),
                                        ("bf16", (Qb, Yb), 2,
                                         PEAK_BF16_FLOPS)):
        ms = cuda_ms(lambda: l2dist(X, Yy), 20)
        plain_ms = cuda_ms(lambda: l2dist_ref(X, Yy), 5)
        b, by = bound(64, N_main, 128, itemsize, peak)
        res[dt] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b,
                   "bound_by": by}
        log(f"l2dist 64x{N_main}x128 l2 {dt}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b:.4f} ms ({by})")
    res["f32"]["library_ms"] = cuda_ms(lambda: torch.cdist(
        Q, Y, compute_mode="use_mm_for_euclid_dist").square_(), 5)
    ones = torch.ones((64, N_main), device=dev)
    res["f32_ip"] = {"ms": cuda_ms(lambda: l2dist(Q, Y, metric="ip"), 20),
                     "library_ms": cuda_ms(lambda: torch.addmm(
                         ones, Q, Y.T, beta=1.0, alpha=-1.0), 5)}
    Qs, Ys = rand(64, 128), rand(2048, 128)     # kernels_bench.py's shape
    res["bench_64x2048x128"] = {
        "ms": cuda_ms(lambda: l2dist(Qs, Ys), 50),
        "plain_ms": cuda_ms(lambda: l2dist_ref(Qs, Ys), 50),
        "library_ms": cuda_ms(lambda: torch.cdist(
            Qs, Ys, compute_mode="use_mm_for_euclid_dist").square_(), 50),
        "bound_ms": bound(64, 2048, 128, 4, PEAK_EXACT_F32_FLOPS)[0]}
    log(f"l2dist library (cdist^2) {res['f32']['library_ms']:.4f} ms; ip: "
        f"kernel {res['f32_ip']['ms']:.4f} ms, library (addmm) "
        f"{res['f32_ip']['library_ms']:.4f} ms; 64x2048x128: "
        + json.dumps(res["bench_64x2048x128"]))
    log(f"l2dist max abs err {max_err:.3g}; f32 bound on the FMA route "
        f"{res['f32_fma_route_ms']:.4f} ms")
    f32 = res["f32"]
    report = {"name": "l2dist", "route": "cuda",
              "source": "src/repro_torch/kernels/l2dist/csrc/l2dist.cu",
              "replaces": "src/repro/kernels/l2dist/l2dist.py:55",
              "launches": launches, "max_abs_err": max_err, "ms": f32["ms"],
              "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
              "bound_by": f32["bound_by"], "library_ms": f32["library_ms"]}
    return report, res


def embed_bag_phase(V=1_000_000, D=32, B=4096, L=32, pad=0.1):
    """``embed_bag`` through its entry point at wide-deep's table and bag
    shapes, then against its plain version."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.embed_bag import embed_bag, embed_bag_ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    table = torch.tensor(rng.normal(size=(V, D)), dtype=torch.float32,
                         device=dev)
    idx_np = rng.integers(0, V, size=(B, L)).astype(np.int32)
    idx_np[rng.random((B, L)) < pad] = -1
    idx = torch.from_numpy(idx_np).to(dev)
    tb16 = table.to(torch.bfloat16)
    # the path: the public entry point at the main shapes
    embed_bag.launches = 0
    outs = {("sum", "f32"): embed_bag(table, idx, "sum"),
            ("mean", "f32"): embed_bag(table, idx, "mean"),
            ("sum", "bf16"): embed_bag(tb16, idx, "sum")}
    torch.cuda.synchronize()
    launches = embed_bag.launches
    check(launches == 3, "embed_bag entry point did not launch its kernel")

    max_err = 0.0

    def compare(out, tab, ix, mode, what):
        nonlocal max_err
        ref = embed_bag_ref(tab, ix, mode)
        check(torch.allclose(out, ref, rtol=TOL, atol=TOL),
              f"embed_bag {what} {mode}")
        max_err = max(max_err, float((out - ref).abs().max()))

    for (mode, dt), out in outs.items():
        compare(out, table if dt == "f32" else tb16, idx, mode,
                f"{V}x{D} bags {B}x{L} {dt}")
    for v, d, b, l in [(100, 8, 7, 4), (1000, 32, 37, 12), (513, 16, 8, 1),
                       (2048, 64, 3, 33), (300, 7, 9, 70), (4000, 260, 5, 40)]:
        tab = torch.tensor(rng.normal(size=(v, d)), dtype=torch.float32,
                           device=dev)
        ix = torch.tensor(rng.integers(-1, v, size=(b, l)).astype(np.int32),
                          device=dev)
        ix[0] = -1                                  # an all-padding bag
        for mode in ("sum", "mean"):
            for t in (tab, tab.to(torch.bfloat16)):
                out = embed_bag(t, ix, mode)
                check(bool((out[0] == 0).all()), "all-padding bag")
                compare(out, t, ix, mode, f"{v}x{d} bags {b}x{l}")
    log("embed_bag: every shape agrees with the plain version")

    valid = idx[idx >= 0]
    rows = int(torch.unique(valid).numel())
    bytes_ = rows * D * 4 + B * L * 4 + B * D * 4
    ops = int(valid.numel()) * D
    t_b, t_o = bytes_ / PEAK_BYTES * 1e3, ops / PEAK_F32_FLOPS * 1e3
    ms = cuda_ms(lambda: embed_bag(table, idx, "sum"), 50)
    ms_mean = cuda_ms(lambda: embed_bag(table, idx, "mean"), 50)
    ms_bf16 = cuda_ms(lambda: embed_bag(tb16, idx, "sum"), 50)
    plain_ms = cuda_ms(lambda: embed_bag_ref(table, idx, "sum"), 10)
    lib_idx = idx.clamp_min(0).long()
    weights = (idx >= 0).float()
    library_ms = cuda_ms(lambda: F.embedding_bag(
        lib_idx, table, mode="sum", per_sample_weights=weights), 50)
    check(torch.allclose(F.embedding_bag(lib_idx, table, mode="sum",
                                         per_sample_weights=weights),
                         outs[("sum", "f32")], rtol=TOL, atol=TOL),
          "embed_bag library yardstick computes another function")
    log(f"embed_bag {V}x{D}, {B} bags of {L} ({int(valid.numel())} valid, "
        f"{rows} distinct rows): kernel sum {ms:.4f} ms, mean "
        f"{ms_mean:.4f} ms, bf16 sum {ms_bf16:.4f} ms, plain {plain_ms:.4f} "
        f"ms, library (F.embedding_bag) {library_ms:.4f} ms, bound "
        f"{max(t_b, t_o):.4f} ms (bytes {t_b:.4f}, operations {t_o:.4f}), "
        f"max abs err {max_err:.3g}")
    report = {"name": "embed_bag", "route": "cuda",
              "source": "src/repro_torch/kernels/embed_bag/csrc/embed_bag.cu",
              "replaces": "src/repro/kernels/embed_bag/embed_bag.py:45",
              "launches": launches, "max_abs_err": max_err, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": max(t_b, t_o),
              "bound_by": "bytes" if t_b > t_o else "operations",
              "library_ms": library_ms}
    return report, {"mean_ms": ms_mean, "bf16_sum_ms": ms_bf16,
                    "valid": int(valid.numel()), "distinct_rows": rows}


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

    def truth(self, Q, k, live=None, with_dists=False):
        """Exact k-NN labels over the live set (or the mask ``live``), on
        the kernel."""
        import numpy as np
        import torch
        from repro_torch.kernels.topk_dist import topk_dist
        lab = np.nonzero(self.live if live is None else live)[0]
        Xl = torch.from_numpy(np.concatenate(self.X)[lab]).to(Q.device)
        before = topk_dist.launches
        d, ids = topk_dist(Q, Xl, k)
        Live.truth_launches += topk_dist.launches - before
        found = lab[ids.cpu().numpy()]
        return (found, d.cpu().numpy()) if with_dists else found


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
    state = {"params": params, "index": index, "live": live, "Q": Q,
             "next_label": next_label, "churn": churn}
    return out, state


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


# ---------------------------------------------------------------------------
# phase 5: the VectorIndex facade and maintenance
# ---------------------------------------------------------------------------

def exact_recall(found, found_d, truth, truth_d, tol=TOL):
    """recall@k where a label the truth does not list still counts when its
    distance ties the truth's k-th (the two scans sum in the same order, so
    only exact ties can differ)."""
    import numpy as np
    hits = 0
    for f, fd, t, td in zip(found, found_d, truth, truth_d):
        kth = td[np.isfinite(td)].max()
        ts = set(t.tolist())
        hits += sum(1 for l, d in zip(f.tolist(), fd.tolist())
                    if l in ts or abs(d - kth) <= tol * (1 + abs(kth)))
    return hits / truth.size


def churned_facade(N=65_536, rounds=3, share=0.05, pending=0.01, seed=0,
                   dev="cuda", step=lambda name, fn: fn()):
    """Phase 5's index up to its repair: the facade's build at N x 128,
    ``rounds`` of ``share`` deletes + replaces with ``pending`` more deletes
    left pending each round, health, and consolidation. Returns ``(vi,
    live, out)``; ``step(name, fn)`` runs (and may time) each call."""
    import numpy as np
    from repro_torch import api
    from repro_torch.data import clustered_vectors

    out = {"N": N}
    X = clustered_vectors(N, 128, seed=0)
    live = Live(X)
    vi = api.create(space="l2", dim=128, capacity=N, M=16, M0=32,
                    num_layers=4, ef_construction=64, ef_search=64,
                    strategy="mn_ru_gamma", seed=seed, device=dev)
    step("build", lambda: vi.add_items(X))
    check(vi.count == N, "facade build count")
    rng = np.random.default_rng(seed + 11)
    churn, extra = int(round(share * N)), int(round(pending * N))
    for r in range(rounds):
        dels = rng.choice(live.labels(), churn + extra, replace=False)
        newX = clustered_vectors(churn, 128, seed=0, noise_seed=300 + r)
        new_labels = np.arange(len(np.concatenate(live.X)),
                               len(np.concatenate(live.X)) + churn)

        def churn_round():
            vi.mark_deleted(dels)
            vi.replace_items(newX, new_labels)
        step(f"churn_{r + 1}", churn_round)
        live.live[dels] = False
        live.add(newX)
    check(vi.count == int(live.live.sum()), "facade live count after churn")
    h = step("health", vi.health)
    out["health_before"] = h.asdict()
    check(int(h.deleted) == rounds * extra,
          f"{int(h.deleted)} deletes pending, expected {rounds * extra}")
    reclaimed = step("consolidate", vi.consolidate)
    check(reclaimed == rounds * extra and vi.deleted_count == 0,
          "consolidate() left mark-deleted slots")
    out["reclaimed"] = reclaimed
    out["def1_after_consolidate"] = vi.health().asdict()["unreachable_def1"]
    return vi, live, out


def facade_phase(N=65_536, rounds=3, share=0.05, pending=0.01, seed=0,
                 dev="cuda"):
    """``repro_torch.api`` end to end at N x 128: build, churn with deletes
    left pending, health, consolidate, repair, queries in every tier,
    compact, save/load."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.data import clustered_vectors

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    t = {}
    Q = torch.from_numpy(clustered_vectors(1000, 128, seed=0,
                                           noise_seed=3)).to(dev)
    Qn = Q.cpu().numpy()

    def step(name, fn):
        sync()
        t0 = time.perf_counter()
        r = fn()
        sync()
        t[name] = time.perf_counter() - t0
        return r

    vi, live, out = churned_facade(N, rounds, share, pending, seed, dev, step)

    def repair():
        """One sweep at a time, to record how the count converges."""
        counts = [vi.health().asdict()["unreachable_def1"]]
        while counts[-1] and len(counts) <= REPAIR_PASSES:
            counts.append(vi.repair_unreachable(max_passes=1))
        return counts
    out["def1_per_pass"] = step("repair", repair)
    h = vi.health()
    out["health_after"] = h.asdict()
    check(int(h.unreachable_def1) == 0,
          f"repair_unreachable() left {int(h.unreachable_def1)} Definition-1 "
          f"points after {REPAIR_PASSES} sweeps: {out['def1_per_pass']}")
    check(vi.count == int(live.live.sum()), "maintenance lost a live label")

    truth, truth_d = live.truth(Q, K, with_dists=True)
    launches0 = topk_dist_launches()
    rec = {}
    for mode in ("graph", "exact", "auto"):
        lab, dist = step(f"query_{mode}",
                         lambda: vi.knn_query(Qn, k=K, mode=mode))
        check(lab.shape == (1000, K) and np.isfinite(dist).all(),
              f"knn_query mode={mode} shape or values")
        rec[mode] = (exact_recall(lab, dist, truth, truth_d)
                     if mode == "exact" else recall(lab, truth))
    out["exact_launches"] = topk_dist_launches() - launches0
    check(rec["exact"] == 1.0, f"exact-mode recall@{K} {rec['exact']}")
    check(rec["graph"] >= 0.9, f"graph recall@{K} {rec['graph']:.4f} < 0.9")
    out["recall"] = rec
    step("compact", vi.compact)
    check(vi.count == int(live.live.sum()) and vi.deleted_count == 0,
          "compact() count")
    lab, _ = vi.knn_query(Qn, k=K, mode="graph")
    out["recall_after_compact"] = recall(lab, truth)
    check(out["recall_after_compact"] >= 0.9, "recall after compact")

    path = ROOT / "build" / "smoke" / "index.npz"
    path.parent.mkdir(parents=True, exist_ok=True)

    def roundtrip():
        vi.save(str(path))
        return api.VectorIndex.load(str(path), device=dev)
    vi2 = step("save_load", roundtrip)
    path.unlink()
    lab2, d2 = vi2.knn_query(Qn, k=K, mode="graph")
    lab1, d1 = vi.knn_query(Qn, k=K, mode="graph")
    check(np.array_equal(lab1, lab2) and np.array_equal(d1, d2),
          "a loaded index answers differently")
    out["seconds"] = t
    log(f"facade: N {N}, build {t['build']:.1f} s, churn rounds "
        + ", ".join(f"{t[f'churn_{r + 1}']:.2f}" for r in range(rounds))
        + f" s; health {out['health_before']}; consolidate "
        f"{t['consolidate']:.2f} s ({out['reclaimed']} slots, Definition 1 "
        f"{out['def1_after_consolidate']} after it); repair "
        f"{t['repair']:.1f} s, Definition 1 per sweep "
        f"{out['def1_per_pass']} -> {out['health_after']}")
    log(f"facade: recall@{K} graph {rec['graph']:.4f}, exact "
        f"{rec['exact']:.4f}, auto {rec['auto']:.4f}; compact "
        f"{t['compact']:.1f} s, recall after {out['recall_after_compact']:.4f}"
        f"; save/load {t['save_load']:.1f} s; query s "
        + ", ".join(f"{m} {t['query_' + m]:.3f}" for m in rec))
    return out


def topk_dist_launches() -> int:
    from repro_torch.kernels.topk_dist import topk_dist
    return topk_dist.launches - Live.truth_launches


# ---------------------------------------------------------------------------
# phase 6: the serving engine over the churned full-size index
# ---------------------------------------------------------------------------

def serving_phase(state, per_epoch=1024, seed=0):
    """``VectorIndex.serve`` over phase 3's index: single queries
    interleaved with 1% deletes and 1% replaces over several epochs."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.data import clustered_vectors

    params, index, live = state["params"], state["index"], state["live"]
    dev = index.device
    N = index.capacity
    t0 = time.perf_counter()
    vi = api.VectorIndex(space=params.space, dim=index.dim, M=params.M,
                         M0=params.M0, num_layers=params.num_layers,
                         ef_construction=params.ef_construction,
                         ef_search=params.ef_search, strategy="mn_ru_gamma",
                         device=dev, _index=index,
                         _next_label=state["next_label"])
    def1_start = int(vi.health().unreachable_def1)
    policy = api.MaintenancePolicy(deleted_frac=0.005, unreachable=N)
    engine = vi.serve(k=K, tau=4096, backup_capacity=8192,
                      max_ops_per_drain=16384, maintenance=policy,
                      track_unreachable=True)
    churn = state["churn"]
    rng = np.random.default_rng(seed + 21)
    dels = rng.choice(live.labels(), churn, replace=False)
    newX = clustered_vectors(churn, 128, seed=0, noise_seed=400)
    new_labels = np.arange(state["next_label"], state["next_label"] + churn)
    first = churn // 4          # replaces in epoch 1; the rest in epoch 2
    Qs = clustered_vectors(3 * per_epoch, 128, seed=0, noise_seed=5)
    tickets, live_at = [], {engine.epoch: live.live.copy()}

    def submit_round(r, ops):
        """``per_epoch`` queries, each followed by its share of ``ops``."""
        qs = Qs[r * per_epoch:(r + 1) * per_epoch]
        for i, q in enumerate(qs):
            tickets.append(engine.search(q))
            for kind, j in ops[i::per_epoch]:
                if kind == "d":
                    engine.delete(int(dels[j]))
                else:
                    engine.update(newX[j], int(new_labels[j]))

    rounds = [[("d", j) for j in range(churn)]
              + [("r", j) for j in range(first)],
              [("r", j) for j in range(first, churn)], []]
    pumps = []
    for r, ops in enumerate(rounds):
        submit_round(r, ops)
        pumps.extend(engine.drain_all())
        for kind, j in ops:               # the host's view of this epoch
            if kind == "d":
                live.live[dels[j]] = False
        replaced = [j for kind, j in ops if kind == "r"]
        if replaced:
            live.add(newX[replaced])
        live_at[engine.epoch] = live.live.copy()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0

    check(all(tk.done for tk in tickets), "a ticket was never answered")
    Qt = torch.from_numpy(Qs).to(dev)
    found = np.stack([tk.result()[0] for tk in tickets])
    epochs = np.array([tk.epoch for tk in tickets])
    hits = []
    for ep in np.unique(epochs):
        sel = np.nonzero(epochs == ep)[0]
        truth = live.truth(Qt[sel], K, live=live_at[int(ep)])
        hits.append(recall(found[sel], truth) * len(sel))
        check(not np.isin(found[sel], np.nonzero(~live_at[int(ep)])[0]
                          ).any(), f"epoch {ep}: a deleted label was served")
    served = float(sum(hits) / len(tickets))
    stats = engine.stats()
    consolidations = stats["counters"].get("maintenance_consolidations", 0)
    check(consolidations >= 1, "no consolidation ran in the engine")
    last = epochs == epochs.max()
    structural_check(engine.snapshot().index, live, found[last])
    out = {"seconds": seconds, "tickets": len(tickets),
           "epochs": sorted(int(e) for e in np.unique(epochs)),
           "served_recall": served, "consolidations": consolidations,
           "def1_start": def1_start, "pumps": len(pumps),
           "stats": stats}
    log(f"serving: {len(tickets)} queries over epochs {out['epochs']}, "
        f"{churn} deletes + {churn} replaces in {len(pumps)} pumps, "
        f"{seconds:.1f} s; served recall@{K} {served:.4f}; "
        f"consolidations {consolidations}")
    log("serving stats: " + json.dumps(stats))
    log(engine.metrics.report())
    return out


# ---------------------------------------------------------------------------
# phase 7: the sharded index and the sharded serving engine
# ---------------------------------------------------------------------------

def sharded_phase(N=1 << 19, nshards=4, epochs=3, per_epoch=1024,
                  deletes=None, inserts=None, seed=0, dev="cuda"):
    """``core.distributed`` and ``ServingEngine(mesh=...)`` at d = 128:
    ``nshards`` shards of ``N / nshards`` points, each with 1,024 free
    slots, placed on this host's devices; recall of the merged answer,
    which must equal the stable merge of the shards' own answers; then
    ``epochs`` of ``per_epoch`` single queries interleaved with
    ``deletes`` deletes, as many replaces (new labels on the deleted
    labels' owners) and ``inserts`` fresh inserts (default N / 4,096 and
    N / 16,384, at least 1: 128 and 32 at 2^19, half of the 256 and 64 of
    the full workload, which would take the phase to ~300 s on an H100)."""
    import numpy as np
    import torch
    import repro_torch.core as T
    from repro_torch.core.distributed import (build_sharded, shard_index,
                                              sharded_batch_knn)
    from repro_torch.data import clustered_vectors
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.serving import ServingEngine

    deletes = max(N // 4096, 1) if deletes is None else deletes
    inserts = max(N // 16384, 1) if inserts is None else inserts
    params = T.HNSWParams(M=16, M0=32, num_layers=4, ef_construction=64,
                          ef_search=64)
    S, per = nshards, N // nshards
    cap = per + 1024
    devices = make_local_mesh(dev)
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    out = {"N": N, "nshards": S, "capacity_per_shard": cap,
           "deletes_per_epoch": deletes, "replaces_per_epoch": deletes,
           "inserts_per_epoch": inserts, "queries_per_epoch": per_epoch}
    X = clustered_vectors(N, 128, seed=0)
    live = Live(X)
    sync()
    t0 = time.perf_counter()
    sharded = build_sharded(params, X, nshards=S, capacity=cap, seed=seed,
                            devices=devices)
    sharded = shard_index(sharded, devices)
    sync()
    out["build_s"] = time.perf_counter() - t0
    out["shard_devices"] = [str(d) for d in sharded.devices]
    log(f"sharded: {S} shards of {per} points (capacity {cap}) built in "
        f"{out['build_s']:.1f} s on {out['shard_devices']}")

    def per_shard_counts(sh):
        c = [T.count_unreachable(ix) for ix in sh.shards]
        return ([int(a) for a, _ in c], [int(b) for _, b in c])

    def check_ownership(sh, tag):
        for s, ix in enumerate(sh.shards):
            lab = ix.labels[(ix.levels >= 0) & ~ix.deleted]
            check(bool((lab % S == s).all()),
                  f"{tag}: shard {s} holds a label it does not own")

    def1, bfs = per_shard_counts(sharded)
    out["after_build"] = {"def1": def1, "bfs": bfs, "def1_sum": sum(def1),
                          "bfs_sum": sum(bfs)}
    check_ownership(sharded, "after build")
    check(all(int(ix.count) == per for ix in sharded.shards),
          "a shard's count after the build")

    Q = torch.from_numpy(clustered_vectors(1000, 128, seed=0,
                                           noise_seed=1)).to(sharded.device)
    sync()
    t0 = time.perf_counter()
    lbl, dist = sharded_batch_knn(params, sharded, Q, K)
    sync()
    out["query_s"] = time.perf_counter() - t0
    out["recall_after_build"] = recall(lbl.cpu().numpy(), live.truth(Q, K))
    # the merge: the shards' own answers, shard-major, stable sort
    own = [T.batch_knn(params, ix, Q.to(ix.device), K)
           for ix in sharded.shards]
    lg = torch.stack([o[0].to(Q.device) for o in own], 1).reshape(-1, S * K)
    dg = torch.stack([o[2].to(Q.device) for o in own], 1).reshape(-1, S * K)
    dg = torch.where(lg < 0, float("inf"), dg)
    order = torch.sort(dg, dim=1, stable=True).indices[:, :K]
    check(torch.equal(lg.gather(1, order), lbl)
          and torch.equal(dg.gather(1, order), dist),
          "the merged answer differs from the stable merge of the shards'")
    log(f"sharded: recall@{K} {out['recall_after_build']:.4f} over 1000 "
        f"queries in {out['query_s']:.2f} s (merge equal to the shards' own "
        f"answers); unreachable def1 {def1} (sum {sum(def1)}), bfs {bfs} "
        f"(sum {sum(bfs)})")

    engine = ServingEngine(params, sharded, mesh=devices, k=K, max_batch=64,
                           max_ops_per_drain=1024, track_unreachable=True)
    rng = np.random.default_rng(seed + 31)
    Qs = clustered_vectors(epochs * per_epoch, 128, seed=0, noise_seed=7)
    tickets, live_at = [], {engine.epoch: live.live.copy()}
    epochs_out = []
    t_serve = time.perf_counter()
    for e in range(epochs):
        snap = engine.snapshot().index
        counts = [int(ix.count) for ix in snap.shards]
        free = [(ix.levels < 0).cpu() for ix in snap.shards]
        base = len(live.live)                   # a multiple of S
        dels = rng.choice(live.labels(), deletes, replace=False)
        rep = base + S * np.arange(deletes) + dels % S   # owner = the delete's
        ins = base + S * deletes + np.arange(inserts)
        rows = np.zeros((S * deletes + inserts + (-inserts) % S, 128),
                        np.float32)
        rows[rep - base] = clustered_vectors(deletes, 128, seed=0,
                                             noise_seed=500 + e)
        rows[ins - base] = clustered_vectors(inserts, 128, seed=0,
                                             noise_seed=600 + e)
        live.add(rows)
        live.live[base:] = False
        # groups of 4 deletes, one fresh insert while their tombstones
        # stand, then the 4 replaces that reuse them
        ops = []
        for g in range(0, deletes, 4):
            ops += [("d", j) for j in range(g, min(g + 4, deletes))]
            if g // 4 < inserts:
                ops.append(("i", g // 4))
            ops += [("r", j) for j in range(g, min(g + 4, deletes))]
        ops += [("i", j) for j in range(-(-deletes // 4), inserts)]
        qs = Qs[e * per_epoch:(e + 1) * per_epoch]
        for i, q in enumerate(qs):
            tickets.append(engine.search(q))
            for kind, j in ops[i::per_epoch]:
                if kind == "d":
                    engine.delete(int(dels[j]))
                elif kind == "r":
                    engine.update(rows[rep[j] - base], int(rep[j]))
                else:
                    engine.insert(rows[ins[j] - base], int(ins[j]))
        t0 = time.perf_counter()
        pumps = engine.drain_all()
        sync()
        pump_s = time.perf_counter() - t0
        live.live[dels] = False
        live.live[rep] = True
        live.live[ins] = True
        live_at[engine.epoch] = live.live.copy()

        new = engine.snapshot().index
        check_ownership(new, f"epoch {e + 1}")
        for s, ix in enumerate(new.shards):
            n_ins = int(np.sum(ins % S == s))
            n_del = int(np.sum(dels % S == s))
            check(int(ix.count) == counts[s] + n_ins,
                  f"epoch {e + 1}: shard {s} count {int(ix.count)}, expected "
                  f"{counts[s]} + {n_ins} fresh inserts")
            check(T.num_deleted(ix) == T.num_deleted(snap.shards[s]),
                  f"epoch {e + 1}: shard {s} tombstones moved "
                  f"({n_del} deletes, {n_del} replaces)")
        for lab in ins:
            ix = new.shards[lab % S]
            slot = T.slot_of_label(ix, int(lab))
            check(slot >= 0 and bool(free[lab % S][slot])
                  and not bool(ix.deleted[slot]),
                  f"epoch {e + 1}: insert {lab} did not take a free slot "
                  f"on shard {lab % S}")
        g = engine.stats()["gauges"]
        epochs_out.append({"epoch": engine.epoch, "pumps": len(pumps),
                           "pump_s": pump_s,
                           "updates_applied": sum(p.updates_applied
                                                  for p in pumps),
                           "unreachable_def1": g["unreachable_indegree"],
                           "unreachable_bfs": g["unreachable_bfs"]})
        log(f"  epoch {engine.epoch}: {per_epoch} queries, {deletes} deletes "
            f"+ {deletes} replaces + {inserts} inserts in {len(pumps)} "
            f"pump(s), {pump_s:.1f} s; unreachable def1 "
            f"{g['unreachable_indegree']:.0f} bfs {g['unreachable_bfs']:.0f}")
    out["serve_s"] = time.perf_counter() - t_serve

    check(all(tk.done for tk in tickets), "a ticket was never answered")
    Qt = torch.from_numpy(Qs).to(sharded.device)
    found = np.stack([tk.result()[0] for tk in tickets])
    epochs_t = np.array([tk.epoch for tk in tickets])
    hits = []
    for ep in np.unique(epochs_t):
        sel = np.nonzero(epochs_t == ep)[0]
        truth = live.truth(Qt[sel], K, live=live_at[int(ep)])
        hits.append(recall(found[sel], truth) * len(sel))
        served = found[sel]
        check(not np.isin(served[served >= 0],
                          np.nonzero(~live_at[int(ep)])[0]).any(),
              f"epoch {ep}: a deleted label was served")
    out["served_recall"] = float(sum(hits) / len(tickets))
    check(out["served_recall"] >= 0.9 * out["recall_after_build"],
          f"served recall {out['served_recall']:.4f} < 0.9 x "
          f"{out['recall_after_build']:.4f}")
    stats = engine.stats()
    n_ops = epochs * (2 * deletes + inserts)
    out.update({"epochs": epochs_out, "tickets": len(tickets),
                "stats": stats, "drain_ms_per_op": engine.metrics.histogram(
                    "drain_latency_ms").sum / max(n_ops, 1)})
    log(f"sharded serving: {len(tickets)} queries over epochs "
        f"{sorted(int(x) for x in np.unique(epochs_t))}, served recall@{K} "
        f"{out['served_recall']:.4f} (after build "
        f"{out['recall_after_build']:.4f}), {out['serve_s']:.1f} s, "
        f"{out['drain_ms_per_op']:.1f} ms a routed op")
    log("sharded serving stats: " + json.dumps(stats))
    log(engine.metrics.report())
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
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.embed_bag.embed_bag import LIBRARY as EB_LIB
    from repro_torch.kernels.l2dist.l2dist import LIBRARY as L2_LIB
    from repro_torch.kernels.topk_dist import topk_dist
    from repro_torch.kernels.topk_dist.topk_dist import LIBRARY as TK_LIB
    phase_s = {}
    t = time.perf_counter()
    build_all([TK_LIB, L2_LIB, EB_LIB])
    phase_s["1_build"] = time.perf_counter() - t
    for lib in (TK_LIB, L2_LIB, EB_LIB):
        log(f"{lib.name} kernel built in {lib.build_seconds:.1f} s")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                log(f"  ptxas: {line.strip()}")

    if args.n != 1 << 20:
        log(f"cut: main-path N = {args.n} instead of {1 << 20}")
    results = {"card": card, "torch": torch.__version__}

    def timed(name, fn, *a, **kw):
        t0 = time.perf_counter()
        r = fn(*a, **kw)
        torch.cuda.synchronize()
        phase_s[name] = time.perf_counter() - t0
        log(f"phase {name}: {phase_s[name]:.1f} s")
        return r

    report, results["topk_dist"] = timed("2_topk_dist", kernel_phase, args.n)
    l2_report, results["l2dist"] = timed("2_l2dist", l2dist_phase, args.n)
    eb_report, results["embed_bag"] = timed("2_embed_bag", embed_bag_phase)

    topk_dist.launches = Live.truth_launches = 0
    results["main_path"], state = timed("3_main_path", main_path, args.n)
    # the port's own launches (exact_scan); the ground truth's apart
    launches = {"3": topk_dist_launches()}
    log(f"main path launched topk_dist {launches['3']} times in the port, "
        f"{Live.truth_launches} more for the ground truth")
    check(launches["3"] > 0, "the main path never launched topk_dist")
    results["strategies"] = timed("4_strategies", strategy_phase)

    for phase, fn, arg in (("5", facade_phase, ()),
                           ("6", serving_phase, (state,))):
        topk_dist.launches = Live.truth_launches = 0
        name = "5_facade" if phase == "5" else "6_serving"
        results[name] = timed(name, fn, *arg)
        launches[phase] = topk_dist_launches()
        log(f"phase {phase} launched topk_dist {launches[phase]} times in "
            f"the port, {Live.truth_launches} more for the ground truth")
    check(launches["5"] + launches["6"] > 0,
          "phases 5-6 never launched topk_dist")
    check(results["6_serving"]["served_recall"] >= 0.9 * results[
        "main_path"]["rounds"][-1]["graph_recall"],
          "served recall < 0.9 x the graph recall after churn")
    log("cut: phase 7 routes 128 deletes + 128 replaces + 32 inserts an "
        "epoch instead of 256 + 256 + 64")
    topk_dist.launches = Live.truth_launches = 0
    results["7_sharded"] = timed("7_sharded", sharded_phase)
    launches["7"] = topk_dist_launches()
    log(f"phase 7 launched topk_dist {launches['7']} times in the port (the "
        f"sharded engine pins the graph tier), {Live.truth_launches} more "
        f"for the ground truth")
    report["launches"] = sum(launches.values())
    results["topk_dist_launches_by_phase"] = launches
    results["kernels"] = [report, l2_report, eb_report]
    results["phase_seconds"] = phase_s
    results["timings"] = TIMINGS
    results["seconds"] = time.perf_counter() - t_start
    log("phase seconds: " + json.dumps(
        {k: round(v, 1) for k, v in phase_s.items()}))
    log(f"chip_smoke: {results['seconds']:.1f} s")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    print(json.dumps({"kernels": results["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
