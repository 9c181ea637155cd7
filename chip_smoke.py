#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--n 1048576] [--out results.json]

Phases, each of which exits nonzero on failure:

  1. the card's name and power limit, the torch version, and the build of
     the five CUDA kernels from ``src/repro_torch/kernels`` (one ``nvcc``
     each, all at once), with each kernel's ``ptxas`` registers;
  2. each kernel against its plain PyTorch version on the card, with times,
     the bound and a library yardstick: ``topk_dist`` (l2 and ip, the
     reference's test shapes, a ~30% mask, fewer than k eligible rows, an
     empty batch, duplicate rows (ties), rows of norm ~1e4 (the l2 form's
     cancellation), the exact tier's main-path shape 64 x N x 128, the
     1,000-query ground-truth call over it, a bf16 copy of that index
     (f32 and bf16 queries, timed beside its bf16 byte bound) and the
     large-k route at 64 x 65,536 x 128: k = 129, 1,000, N and past N,
     f32 and bf16),
     ``l2dist`` (a serving batch against the index, 64 x N x 128, f32 and
     bf16, l2 and ip, plus the test shapes) and ``embed_bag`` (wide-deep's
     1,000,000 x 32 table, 4096 bags of 32 with ~10% padding, sum and
     mean, plus the test shapes, and phase 8's 262,144 bags of 32, whose
     times the kernel report gives, with the lane-group layout it took);
     each wrapper is first driven through its public entry point at those
     shapes, and its launches counted; ``count_flags`` at the search
     cells' visited flags, 32,768 x 262,145 (8.6 GB), exact against a
     plain count taken 1,024 lanes at a time, with its time; and
     ``beam_expand``, one step of the lockstep search at the search cells'
     shape (d 128 l2, d 100 ip, ~24% of the slots fresh), exact ids and
     flags against its plain version, with its time, the plain version's
     and its byte bound;
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
  5b. (run after 6) the facade over a bf16 index at phase 5's 65,536 x
     128: build, 1% deletes + replaces, exact and graph queries at k = 10
     and 200; the index stores bf16, the exact tier equals a plain f32
     brute force over the widened stored vectors, and launches
     ``topk_dist`` (k = 200 on its large-k route);
  7. the sharded index and the sharded serving engine: 2^19 x 128 in 4
     shards placed on this host's devices (all on one card when there is
     one), recall of the merged answer and its equality with the stable
     merge of the shards' own answers, then 3 epochs of 1,024 single
     queries interleaved with 128 deletes, 128 replaces and 32 fresh
     inserts routed to their owner shards (half of 256 / 256 / 64, to
     keep the smoke's time; logged as a cut);
  8. the embedding models that feed the index, at their published
     configs: stablelm-1.6b (bf16, random weights from seed 0) embeds
     16,384 documents of 128 tokens into a cosine ``VectorIndex``, 5% are
     edited (re-embedded, markDelete + replace), 1,024 queries run in the
     graph and the exact tier (``topk_dist``), two served epochs of 512
     queries with 1% more edits between them, and ``prefill`` + 16
     ``decode_step``s are held to ``forward``; then wide-deep (its bag on
     ``embed_bag``, at 512 and 262,144 rows, held against the plain bag),
     AutoInt and DIEN at 512 rows, and SASRec's retrieval over its
     1,000,448 padded items (held to a stable sort) and over the first
     131,072 items in an ``ip`` ``VectorIndex`` with 1% delisted and as
     many new items listed (logged as a cut);
  9. the training path at published widths: stablelm-1.6b takes 4 AdamW
     steps of ``make_train_step(lm_loss)`` with remat at 2 x 4,096 tokens
     (global batch cut from 256, logged), wide-deep 5 steps at its
     ``train_batch`` of 65,536 rows with the bag on ``embed_bag`` (one
     step's loss and every gradient held to the plain bag's; the bag's
     forward and backward timed), then ``repro_torch.launch.train``
     crashes at an injected step and resumes from its checkpoint (at the
     smoke config, logged);
 10. the MoE LMs (``moe_phase``): deepseek-moe-16b at its published width
     and depth (28 layers, 16.4 B parameters, bf16, seed-drawn) prefills
     4 x 2,048 tokens with every MoE layer's ``moe_ffn`` held against the
     plain per-expert ``moe_ffn_ref`` on its real hidden state, and
     decodes 16 steps held to ``forward`` (capacity raised so that nothing
     drops, logged; the gap at the published factor reported);
     granite-moe-3b-a800m embeds 8,192 documents in phase 8's RAG
     scenario (exact tier on ``topk_dist``); granite trains 4 steps at
     full depth and deepseek 3 at its dense layer + 3 MoE layers (logged);
     one layer of each on a 1 x 4 grid of the card (the sharded form);
 11. NequIP at its published config (``gnn_phase``): 128 molecules of 30
     atoms (energies, forces, rotation / translation / permutation
     invariance and force equivariance on the card, 5 AdamW steps),
     full_graph_sm (5 steps), and minibatch_lg: a 232,965-node,
     114,615,892-edge graph sorted into CSR on the card, 1,024 seeds
     sampled with fanout (15, 10), one step on the subgraph;
 12. the dry run (``repro_torch.launch.dryrun``): (a) all 40 (arch x
     shape) cells' steps traced on ``meta`` stand-ins at their published
     shapes, in worker processes (counted and model TFLOP, bytes, peak,
     fits, roofline ms, the largest fitting batch); (b) held to the card
     on four cells that phases 9-11 run (``hold_cell``: stablelm-1.6b's
     train step at 2 x 4,096, wide-deep's at 65,536 rows, deepseek-moe-
     16b's prefill at 4 x 2,048, NequIP's molecule batch): one more real
     step under the counting mode, FLOPs equal to the trace's, peak within
     15% of its estimate, the timed step as a share of the roofline bound.
     Phases 9 and 10 price their training steps with the dry run's count.

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
    extra = {"fma_route_ms": t_fma, "truth_1000_ms": truth_ms,
             **bf16_and_large_k(compare, rand, Q, Y, mask, N_main)}
    return {"name": "topk_dist", "route": "cuda",
            "source": "src/repro_torch/kernels/topk_dist/csrc/topk_dist.cu",
            "replaces": "src/repro/kernels/topk_dist/topk_dist.py:99",
            "launches": 0, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "library_ms": library_ms}, extra


def bf16_and_large_k(compare, rand, Q, Y, mask, N_main, n_large=65_536,
                     n_all=8192):
    """``topk_dist`` where the reference's kernel takes more than f32 and
    k <= 128: a bf16 copy of the main-shape index (f32 and bf16 queries),
    timed at k = 10 beside its bf16 byte bound, then the large-k route in
    f32 and bf16: k = 129 and 1,000 at ``n_large`` rows (timed), k = N and
    N + 5 at ``n_all`` rows."""
    import torch
    from repro_torch.kernels.topk_dist import topk_dist, topk_dist_ref

    out = {}
    Yb = Y.to(torch.bfloat16)
    for metric in ("l2", "ip"):
        compare(Q, Yb, K, metric, mask, f"bf16 64x{N_main}x128")
        compare(Q.to(torch.bfloat16), Yb[:100_000], K, metric, mask[:100_000],
                "bf16 Q and Y, 64x100000x128")
    nq, d = Q.shape
    out["bf16_ms"] = cuda_ms(lambda: topk_dist(Q, Yb, K, mask=mask), 20)
    out["bf16_plain_ms"] = cuda_ms(
        lambda: topk_dist_ref(Q, Yb, K, mask=mask), 3)
    out["bf16_bound_ms"] = (2 * N_main * d + 4 * nq * d + N_main
                            + nq * K * 8) / PEAK_BYTES * 1e3
    log(f"topk_dist bf16 Y, f32 Q, 64x{N_main}x128 k={K}: kernel "
        f"{out['bf16_ms']:.4f} ms, plain {out['bf16_plain_ms']:.4f} ms, byte "
        f"bound {out['bf16_bound_ms']:.4f} ms (f32 Y: see above)")

    Yl, ml = Y[:n_large], mask[:n_large]
    for n, ks in ((n_large, (129, 1000)), (n_all, (n_all, n_all + 5))):
        for k in ks:
            for Yk in (Yl[:n], Yl[:n].to(torch.bfloat16)):
                for metric, m in (("l2", ml[:n]), ("ip", None)):
                    compare(Q, Yk, k, metric, m,
                            f"k={k} {Yk.dtype} 64x{n}x128")
    Ylb = Yl.to(torch.bfloat16)
    large = {}
    for k in (129, 1000):
        large[k] = {
            "f32_ms": cuda_ms(lambda: topk_dist(Q, Yl, k, mask=ml), 10),
            "bf16_ms": cuda_ms(lambda: topk_dist(Q, Ylb, k, mask=ml), 10),
            "plain_ms": cuda_ms(lambda: topk_dist_ref(Q, Yl, k, mask=ml), 3)}
        log(f"topk_dist large-k route 64x{n_large}x128 k={k}: f32 "
            f"{large[k]['f32_ms']:.4f} ms, bf16 {large[k]['bf16_ms']:.4f} "
            f"ms, plain {large[k]['plain_ms']:.4f} ms")
    out["large_k"] = large
    log(f"topk_dist: bf16 and k = 129, 1000 (N = {n_large}), {n_all}, "
        f"{n_all + 5} (N = {n_all}) agree with the plain version up to "
        f"ties at the k-th distance")
    return out


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
    shapes, then against its plain version; timed at ``B`` bags and at
    phase 8's serve_bulk bags (262,144 of 32, ~30% padding), whose numbers
    go to the kernel report."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.embed_bag import embed_bag, embed_bag_ref
    from repro_torch.kernels.embed_bag.embed_bag import lane_layout

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

    def measure(ix, reps):
        """Kernel, plain and library times of a sum over ``table``, and the
        bound: each distinct row read once, the ids, the output."""
        nb, nl = ix.shape
        valid = ix[ix >= 0]
        rows = int(torch.unique(valid).numel())
        bytes_ = rows * D * 4 + nb * nl * 4 + nb * D * 4
        ops = int(valid.numel()) * D
        t_b, t_o = bytes_ / PEAK_BYTES * 1e3, ops / PEAK_F32_FLOPS * 1e3
        lib_idx, weights = ix.clamp_min(0).long(), (ix >= 0).float()
        lib = F.embedding_bag(lib_idx, table, mode="sum",
                              per_sample_weights=weights)
        check(torch.allclose(lib, embed_bag_ref(table, ix), rtol=TOL,
                             atol=TOL),
              "embed_bag library yardstick computes another function")
        return {"bags": nb, "valid": int(valid.numel()), "distinct_rows": rows,
                "ms": cuda_ms(lambda: embed_bag(table, ix, "sum"), reps),
                "plain_ms": cuda_ms(lambda: embed_bag_ref(table, ix, "sum"),
                                    max(reps // 5, 2)),
                "library_ms": cuda_ms(lambda: F.embedding_bag(
                    lib_idx, table, mode="sum", per_sample_weights=weights),
                    reps),
                "bound_ms": max(t_b, t_o),
                "bound_by": "bytes" if t_b > t_o else "operations",
                "gather_ms": int(valid.numel()) * D * 4 / PEAK_BYTES * 1e3}

    small = measure(idx, 50)
    small["mean_ms"] = cuda_ms(lambda: embed_bag(table, idx, "mean"), 50)
    small["bf16_sum_ms"] = cuda_ms(lambda: embed_bag(tb16, idx, "sum"), 50)
    # the main path's shape: wide-deep's serve_bulk bags (phase 8's ids)
    from repro_torch.configs import get_config
    from repro_torch.data import recsys_batch
    bulk_idx = torch.from_numpy(recsys_batch(get_config("wide_deep"), 262_144,
                                             seed=1)["bag_ids"]).to(dev)
    compare(embed_bag(table, bulk_idx, "sum"), table, bulk_idx, "sum",
            f"{V}x{D} bags {tuple(bulk_idx.shape)} (serve_bulk)")
    bulk = measure(bulk_idx, 20)
    for tag, m in ((f"{B} bags of {L}", small), ("serve_bulk, 262144 bags of "
                                                  "32", bulk)):
        log(f"embed_bag {V}x{D}, {tag} ({m['valid']} valid, "
            f"{m['distinct_rows']} distinct rows): kernel sum {m['ms']:.4f} "
            f"ms, plain {m['plain_ms']:.4f} ms, library (F.embedding_bag) "
            f"{m['library_ms']:.4f} ms, bound {m['bound_ms']:.4f} ms "
            f"({m['bound_by']}; every valid row gathered once: "
            f"{m['gather_ms']:.4f} ms)")
    layout = {"f32": lane_layout(table), "bf16": lane_layout(tb16)}
    log(f"embed_bag {B} bags: mean {small['mean_ms']:.4f} ms, bf16 sum "
        f"{small['bf16_sum_ms']:.4f} ms; max abs err {max_err:.3g}; lane "
        f"groups at D = {D}: " + "; ".join(
            f"{dt} {m['values_per_lane']} values a lane, "
            f"{m['lanes_per_row']} lanes a row, {m['rows_per_load']} rows a "
            f"load instruction" for dt, m in layout.items()))
    report = {"name": "embed_bag", "route": "cuda",
              "source": "src/repro_torch/kernels/embed_bag/csrc/embed_bag.cu",
              "replaces": "src/repro/kernels/embed_bag/embed_bag.py:45",
              "launches": launches, "max_abs_err": max_err,
              **{k: bulk[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}}
    return report, {"bags_4096": small, "serve_bulk": bulk,
                    "lane_layout": layout}


def count_flags_phase(B=32_768, N=262_144, share=0.01, seed=0):
    """``count_flags`` on the flags the lockstep search marks at the search
    cells' shape: ``[B, N + 1]`` bool (column N is the sink, set in every
    third row and not counted), exact against a plain count taken 1,024
    lanes at a time, one launch by the wrapper's counter, and its device
    time beside the bytes' time at HBM rate."""
    import torch
    from repro_torch.kernels.count_flags import count_flags
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(seed)
    v = torch.empty((B, N + 1), dtype=torch.bool, device=dev)
    for i in range(0, B, 1024):
        v[i:i + 1024] = torch.rand((min(1024, B - i), N + 1), device=dev,
                                   generator=g) < share
    v[::3, N] = True
    want = sum(int(v[i:i + 1024, :N].sum()) for i in range(0, B, 1024))
    count_flags.launches = 0
    got = count_flags(v, N)
    check(count_flags.launches == 1,
          f"count_flags launched {count_flags.launches} times, not once")
    check(got.dtype == torch.int64 and int(got) == want,
          f"count_flags read {int(got)} set flags, the plain count {want}")
    ms = cuda_ms(lambda: count_flags(v, N), reps=5)
    bound_ms = v.numel() / PEAK_BYTES * 1e3
    log(f"count_flags {B} x {N + 1}: {int(got)} set, equal to the plain "
        f"count; {ms:.4f} ms ({v.numel() / ms / 1e6:.0f} GB/s; bound "
        f"{bound_ms:.4f} ms, {100 * bound_ms / ms:.0f}%)")
    del v
    torch.cuda.empty_cache()
    return {"shape": [B, N + 1], "count": int(got), "plain": want,
            "ms": ms, "bound_ms": bound_ms,
            "launches": count_flags.launches}


def beam_expand_phase(B=32_768, N=262_144, M0=32, fresh_share=0.24,
                      reps=5, seed=0):
    """``beam_expand`` at the search cells' shape: one expansion step of
    32,768 lanes over 262,144 rows (M0 32, the visited flags 8.6 GB), sift's
    d 128 l2 and glove's d 100 ip in f32, with ~``fresh_share`` of the slots
    fresh (the share ``search_fresh_pct.search`` reads in those cells);
    ids and flags exact against ``ref.py``, distances within 1e-5, one
    launch, and its device time beside ``ref.py``'s and its bound: the
    bytes it must move at HBM rate (the fresh rows, the neighbour rows, a
    32-byte sector per flag read and per flag set, the queries, ``cur``,
    ``running`` and the outputs). Each timed call expands other rows
    (``cur`` drawn anew), so its slots stay ~``fresh_share`` fresh: a call
    sets at most M0 of a lane's 262,144 flags."""
    import torch
    from repro_torch.core.metrics import get_metric
    from repro_torch.kernels.beam_expand import beam_expand, beam_expand_ref
    dev = "cuda"
    out = {}
    for space, d in (("l2", 128), ("ip", 100)):
        g = torch.Generator(device=dev).manual_seed(seed)
        X = torch.randn(N, d, device=dev, generator=g)
        Q = torch.randn(B, d, device=dev, generator=g)
        nbrs = torch.randint(0, N, (N, M0), device=dev, generator=g,
                             dtype=torch.int32)
        curs = [torch.randint(0, N, (B,), device=dev, generator=g)
                for _ in range(2 * reps + 2)]
        running = torch.ones(B, dtype=torch.bool, device=dev)
        v = torch.empty((B, N + 1), dtype=torch.bool, device=dev)
        for i in range(0, B, 1024):
            v[i:i + 1024] = torch.rand((min(1024, B - i), N + 1),
                                       device=dev, generator=g) \
                >= fresh_share
        metric = get_metric(space)
        v_ref = v.clone()
        nd_r, ni_r = beam_expand_ref(metric.point_fn, Q, X, nbrs, curs[0],
                                     running, v_ref)
        beam_expand.launches = 0
        nd, ni = beam_expand(metric, Q, X, nbrs, curs[0], running, v)
        check(beam_expand.launches == 1,
              f"beam_expand launched {beam_expand.launches} times, not once")
        fresh = ni_r >= 0
        check(torch.equal(ni, ni_r) and torch.equal(v[:, :N], v_ref[:, :N]),
              f"beam_expand {space}: ids or flags differ from ref.py")
        err = float(((nd[fresh] - nd_r[fresh]).abs()
                     / nd_r[fresh].abs().clamp_min(1.0)).max())
        check(bool(torch.isinf(nd[~fresh]).all()) and err <= 1e-5,
              f"beam_expand {space}: distances off by {err:.3g}")
        n_fresh = int(fresh.sum())
        calls = {"kernel": iter(curs[1:]), "plain": iter(curs[1:])}
        ms = cuda_ms(lambda: beam_expand(metric, Q, X, nbrs,
                                         next(calls["kernel"]), running, v),
                     reps)
        plain_ms = cuda_ms(lambda: beam_expand_ref(
            metric.point_fn, Q, X, nbrs, next(calls["plain"]), running,
            v_ref), reps)
        bytes_ = (n_fresh * (d * 4 + 32) + B * M0 * (4 + 32 + 12)
                  + B * (d * 4 + 9))
        bound_ms = bytes_ / PEAK_BYTES * 1e3
        log(f"beam_expand {space} {B} lanes x {N} rows x d {d}, M0 {M0}: "
            f"{n_fresh} fresh slots ({100 * n_fresh / (B * M0):.1f}%), "
            f"exact ids and flags, max rel err {err:.3g}; kernel {ms:.4f} ms, "
            f"ref.py {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bytes_ / 1e6:.1f} MB; {100 * bound_ms / ms:.0f}%)")
        out[space] = {"d": d, "fresh": n_fresh, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bytes": bytes_, "max_rel_err": err,
                      "launches": beam_expand.launches}
        del X, Q, nbrs, curs, v, v_ref, nd, ni, nd_r, ni_r
        torch.cuda.empty_cache()
    return out


def op_overhead(reps=300):
    """Host time a call spends in each kernel's custom op
    (``repro_torch::<name>``) beyond its ctypes launcher, at a small shape
    where the host bounds the call: ``reps`` calls of the launcher, of the
    op and of the public wrapper, timed on the host with one synchronise
    after each run, in turns (launcher, op, wrapper, wrapper, op,
    launcher), after a warm-up. Microseconds a call."""
    import torch
    from repro_torch.kernels.embed_bag import embed_bag
    from repro_torch.kernels.embed_bag.embed_bag import embed_bag_cuda
    from repro_torch.kernels.l2dist import l2dist
    from repro_torch.kernels.l2dist.l2dist import l2dist_cuda
    from repro_torch.kernels.topk_dist import topk_dist
    from repro_torch.kernels.topk_dist.topk_dist import topk_dist_cuda

    g = torch.Generator(device="cuda").manual_seed(0)
    Q = torch.randn(8, 128, device="cuda", generator=g)
    Y = torch.randn(4096, 128, device="cuda", generator=g)
    T = torch.randn(100_000, 32, device="cuda", generator=g)
    ids = torch.randint(0, 100_000, (64, 32), device="cuda", generator=g,
                        dtype=torch.int32)
    ops = torch.ops.repro_torch
    cases = {
        "topk_dist": (lambda: topk_dist_cuda(Q, Y, 10, "l2", None),
                      lambda: ops.topk_dist(Q, Y, 10, "l2", None),
                      lambda: topk_dist(Q, Y, 10)),
        "l2dist": (lambda: l2dist_cuda(Q, Y, "l2"),
                   lambda: ops.l2dist(Q, Y, "l2"), lambda: l2dist(Q, Y)),
        "embed_bag": (lambda: embed_bag_cuda(T, ids, "sum"),
                      lambda: ops.embed_bag(T, ids, "sum"),
                      lambda: embed_bag(T, ids, "sum"))}
    counts = (topk_dist.launches, l2dist.launches, embed_bag.launches)
    out = {}
    for name, fns in cases.items():
        runs = {i: [] for i in range(3)}
        for f in fns:
            f()
        torch.cuda.synchronize()
        for i in (0, 1, 2, 2, 1, 0):
            t0 = time.perf_counter()
            for _ in range(reps):
                fns[i]()
            torch.cuda.synchronize()
            runs[i].append((time.perf_counter() - t0) / reps * 1e6)
        us = {k: min(v) for k, v in zip(("launcher", "op", "wrapper"),
                                         runs.values())}
        us["op_overhead"] = us["op"] - us["launcher"]
        out[name] = us
        log(f"{name} host time a call (us, best of 2 x {reps}): launcher "
            f"{us['launcher']:.2f}, custom op {us['op']:.2f}, wrapper "
            f"{us['wrapper']:.2f}: the op adds {us['op_overhead']:.2f}")
    # comparisons, not the path's launches
    topk_dist.launches, l2dist.launches, embed_bag.launches = counts
    return out


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


def bf16_facade_phase(N=65_536, share=0.01, seed=0, dev="cuda"):
    """The facade over a bf16 index: phase 5's data and parameters with
    ``dtype=torch.bfloat16``, a build, 1% deletes + replaces, then queries
    in the exact and the graph tier at k = 10 and 200 (k = 200 takes
    ``topk_dist``'s large-k route). The index must store bf16 (2 bytes a
    value), the exact tier must equal a plain f32 brute force over the
    stored vectors widened to f32, and the exact queries must launch the
    kernel."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.data import clustered_vectors
    from repro_torch.kernels.topk_dist import topk_dist_ref

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    t = {}

    def step(name, fn):
        sync()
        t0 = time.perf_counter()
        r = fn()
        sync()
        t[name] = time.perf_counter() - t0
        return r

    X = clustered_vectors(N, 128, seed=0)
    vi = api.create(space="l2", dim=128, capacity=N, M=16, M0=32,
                    num_layers=4, ef_construction=64, ef_search=64,
                    strategy="mn_ru_gamma", seed=seed, dtype=torch.bfloat16,
                    device=dev)
    step("build", lambda: vi.add_items(X))
    rng = np.random.default_rng(seed + 17)
    churn = int(round(share * N))
    dels = rng.choice(N, churn, replace=False)
    newX = clustered_vectors(churn, 128, seed=0, noise_seed=400)

    def churn_round():
        vi.mark_deleted(dels)
        vi.replace_items(newX, np.arange(N, N + churn))
    step("churn", churn_round)
    ix = vi.index
    check(ix.vectors.dtype == torch.bfloat16
          and ix.vectors.element_size() == 2,
          f"the bf16 facade stores {ix.vectors.dtype}")
    check(vi.count == N, "bf16 facade live count after churn")
    live = ((ix.levels >= 0) & ~ix.deleted).nonzero().reshape(-1)
    Yw = ix.vectors[live].float()          # the stored values, widened
    Q = torch.from_numpy(clustered_vectors(1000, 128, seed=0,
                                           noise_seed=3)).to(dev)
    Qn = Q.cpu().numpy()
    out = {"N": N, "stored_dtype": str(ix.vectors.dtype),
           "vector_bytes": ix.vectors.numel() * ix.vectors.element_size()}
    launches0 = topk_dist_launches()
    for k in (K, 200):
        td, ti = topk_dist_ref(Q, Yw, k)
        truth = ix.labels[live[ti.long()]].cpu().numpy()
        truth_d = td.cpu().numpy()
        for mode in ("exact", "graph"):
            lab, dist = step(f"query_{mode}_{k}",
                             lambda: vi.knn_query(Qn, k=k, mode=mode))
            check(lab.shape == (1000, k) and np.isfinite(dist).all(),
                  f"bf16 knn_query mode={mode} k={k} shape or values")
            out[f"recall_{mode}_{k}"] = (
                exact_recall(lab, dist, truth, truth_d) if mode == "exact"
                else recall(lab, truth))
        check(out[f"recall_exact_{k}"] == 1.0,
              f"bf16 exact-tier recall@{k} {out[f'recall_exact_{k}']}")
    out["exact_launches"] = topk_dist_launches() - launches0
    check(out[f"recall_graph_{K}"] >= 0.9,
          f"bf16 graph recall@{K} {out[f'recall_graph_{K}']:.4f} < 0.9")
    out["seconds"] = t
    log(f"bf16 facade: N {N}, vectors {out['stored_dtype']} "
        f"({out['vector_bytes']} bytes), build {t['build']:.1f} s, 1% churn "
        f"{t['churn']:.2f} s; recall@10 exact {out['recall_exact_10']:.4f} "
        f"graph {out['recall_graph_10']:.4f}; recall@200 exact "
        f"{out['recall_exact_200']:.4f} graph {out['recall_graph_200']:.4f}; "
        f"query s " + ", ".join(f"{k[6:]} {v:.3f}" for k, v in t.items()
                                if k.startswith("query_")))
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


# ---------------------------------------------------------------------------
# phase 8: the embedding models that feed the index
# ---------------------------------------------------------------------------

def _sync(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def embed_docs(cfg, params, tokens, batch, dev):
    """Mean-pooled final hidden state (f32) of each row of ``tokens``, in
    batches of ``batch``; a host thread (``PrefetchPipeline``) stages the
    next batch in pinned memory while the card runs this one."""
    import itertools
    import torch
    from repro_torch.data import PrefetchPipeline, SyntheticStream
    from repro_torch.models import transformer

    n = len(tokens)
    pin = torch.device(dev).type == "cuda"

    def stage(step):
        t = torch.from_numpy(tokens[step * batch:(step + 1) * batch])
        return t.pin_memory() if pin else t
    steps = -(-n // batch)
    out = torch.empty((n, cfg.d_model), dtype=torch.float32, device=dev)
    pipe = PrefetchPipeline(itertools.islice(SyntheticStream(stage), steps))
    with torch.inference_mode():
        for step, t in enumerate(pipe):
            hidden, _ = transformer.forward_hidden(
                cfg, params, t.to(dev, non_blocking=True))
            out[step * batch:step * batch + len(t)] = hidden.float().mean(1)
    return out


def rag_phase(cfg, n_docs=16384, edit_share=0.05, n_queries=1024,
              per_epoch=512, serve_share=0.01, batch=64, seed=0,
              dev="cuda", decode=True):
    """The RAG scenario (``examples/rag_serving.py``,
    ``examples/streaming_rag.py``) at ``cfg``'s width and depth: embed a
    corpus with the LM, index it in a cosine ``VectorIndex``, edit
    ``edit_share`` of it (re-embed, markDelete, replace under new labels),
    query both tiers, serve two epochs with ``serve_share`` more edits
    queued between them, and (``decode``) check ``prefill`` + 16
    ``decode_step``s against ``forward``."""
    import numpy as np
    import torch
    from repro_torch import api
    from repro_torch.core.metrics import normalize_rows
    from repro_torch.data import lm_token_batch
    from repro_torch.kernels.topk_dist import topk_dist_ref
    from repro_torch.models import transformer

    out = {"arch": cfg.name, "n_docs": n_docs}
    t = {}

    def step(name, fn):
        _sync(dev)
        t0 = time.perf_counter()
        r = fn()
        _sync(dev)
        t[name] = time.perf_counter() - t0
        return r

    params = step("init", lambda: transformer.init_params(cfg, seed=seed,
                                                          device=dev))
    seq = 127                                   # 128 tokens a document
    docs = lm_token_batch(cfg.vocab_size, n_docs, seq, seed=0)
    corpus = step("embed", lambda: embed_docs(cfg, params, docs, batch, dev))
    out["embed_tokens_per_s"] = docs.size / t["embed"]
    check(tuple(corpus.shape) == (n_docs, cfg.d_model)
          and bool(torch.isfinite(corpus).all()), "corpus embeddings")
    corpus = corpus.cpu().numpy()

    vi = api.create(space="cosine", dim=cfg.d_model, capacity=2 * n_docs,
                    M=16, ef_construction=64, num_layers=4, ef_search=64,
                    strategy="mn_ru_gamma", seed=seed, device=dev)
    step("build", lambda: vi.add_items(corpus))
    check(vi.count == n_docs, "RAG build count")
    out["def1_after_build"] = vi.health().asdict()["unreachable_def1"]

    n_edit = int(edit_share * n_docs)
    edited = lm_token_batch(cfg.vocab_size, n_edit, seq, seed=7)
    new_emb = embed_docs(cfg, params, edited, batch, dev).cpu().numpy()
    new_labels = np.arange(n_docs, n_docs + n_edit)

    def edit():
        vi.mark_deleted(np.arange(n_edit))
        vi.replace_items(new_emb, new_labels)
    step("edit", edit)
    check(vi.count == n_docs, "RAG live count after the edits")
    out["def1_after_edits"] = vi.health().asdict()["unreachable_def1"]
    live = np.ones(n_docs + n_edit, bool)
    live[:n_edit] = False
    vectors = normalize_rows(np.concatenate([corpus, new_emb]))
    book = Live(vectors)                        # unit rows: l2 order = cosine
    book.live = live.copy()

    qtok = lm_token_batch(cfg.vocab_size, n_queries, seq, seed=9)
    q_emb = embed_docs(cfg, params, qtok, batch, dev).cpu().numpy()
    Qn = torch.from_numpy(normalize_rows(q_emb)).to(dev)
    launches0 = topk_dist_launches()
    g_lab, _ = step("query_graph", lambda: vi.knn_query(q_emb, k=K,
                                                        mode="graph"))
    e_lab, e_d = step("query_exact", lambda: vi.knn_query(q_emb, k=K,
                                                          mode="exact"))
    out["exact_launches"] = topk_dist_launches() - launches0
    ix = vi.index
    eligible = (ix.levels >= 0) & ~ix.deleted
    rd, ri = topk_dist_ref(Qn, ix.vectors, K, metric="ip", mask=eligible)
    truth = ix.labels[ri.long()].cpu().numpy()
    out["exact_recall"] = exact_recall(e_lab, e_d, truth, rd.cpu().numpy())
    out["graph_recall"] = recall(g_lab, truth)
    check(out["exact_recall"] == 1.0,
          f"RAG exact-tier recall@{K} {out['exact_recall']}")
    self_lab, _ = vi.knn_query(new_emb, k=1)
    out["edited_self_1nn"] = float(np.mean(self_lab[:, 0] == new_labels))
    check(out["edited_self_1nn"] == 1.0,
          f"only {out['edited_self_1nn']:.4f} of the edited documents are "
          f"their own 1-NN")
    check(not np.isin(g_lab, np.arange(n_edit)).any(),
          "a deleted document was returned")

    # serving: two epochs of single queries, edits queued between them
    rng = np.random.default_rng(seed + 41)
    n_serve = max(int(serve_share * n_docs), 1)
    dels = rng.choice(book.labels(), n_serve, replace=False)
    stok = lm_token_batch(cfg.vocab_size, n_serve, seq, seed=13)
    semb = embed_docs(cfg, params, stok, batch, dev).cpu().numpy()
    slabels = np.arange(len(live), len(live) + n_serve)
    engine = vi.serve(k=K, max_ops_per_drain=4 * n_serve,
                      track_unreachable=True)
    tickets, live_at = [], {engine.epoch: book.live.copy()}
    t0 = time.perf_counter()
    for e in range(2):
        for q in q_emb[e * per_epoch:(e + 1) * per_epoch]:
            tickets.append(engine.search(q))
        if e == 0:
            for lab, x, new in zip(dels, semb, slabels):
                engine.delete(int(lab))
                engine.update(x, int(new))
        engine.drain_all()
        if e == 0:
            book.live[dels] = False
            book.add(normalize_rows(semb))
        live_at[engine.epoch] = book.live.copy()
    _sync(dev)
    t["serve"] = time.perf_counter() - t0
    check(all(tk.done for tk in tickets), "a RAG ticket was never answered")
    found = np.stack([tk.result()[0] for tk in tickets])
    epochs = np.array([tk.epoch for tk in tickets])
    Qs = torch.from_numpy(normalize_rows(q_emb[:len(tickets)])).to(dev)
    hits = 0.0
    for ep in np.unique(epochs):
        sel = np.nonzero(epochs == ep)[0]
        hits += recall(found[sel], book.truth(Qs[sel], K,
                                              live=live_at[int(ep)])) * len(sel)
        check(not np.isin(found[sel], np.nonzero(~live_at[int(ep)])[0]).any(),
              f"RAG epoch {ep}: a deleted document was served")
    out["served_recall"] = hits / len(tickets)
    out["served_epochs"] = sorted(int(e) for e in np.unique(epochs))
    check(out["served_recall"] >= 0.9 * out["graph_recall"],
          f"RAG served recall {out['served_recall']:.4f} < 0.9 x "
          f"{out['graph_recall']:.4f}")
    out["def1_after_serving"] = int(engine.stats()["gauges"].get(
        "unreachable_indegree", -1))

    if decode:
        out["decode"] = decode_check(cfg, params, dev)
    out["seconds"] = t
    log(f"RAG ({cfg.name}, {n_docs} docs of {seq + 1} tokens): embed "
        f"{t['embed']:.1f} s ({out['embed_tokens_per_s']:.0f} tokens/s), "
        f"build {t['build']:.1f} s, {n_edit} edits {t['edit']:.2f} s; "
        f"Definition 1 {out['def1_after_build']} -> "
        f"{out['def1_after_edits']}; recall@{K} graph "
        f"{out['graph_recall']:.4f}, exact {out['exact_recall']:.1f} "
        f"({out['exact_launches']} topk_dist launches); edited docs their "
        f"own 1-NN; served recall {out['served_recall']:.4f} over "
        f"{len(tickets)} queries, epochs {out['served_epochs']}, "
        f"{n_serve} edits, {t['serve']:.1f} s")
    return out


def decode_check(cfg, params, dev, batch=8, prompt=64, steps=16, seed=11):
    """``prefill`` of ``batch`` prompts of ``prompt`` tokens, then ``steps``
    ``decode_step``s through the cache written in place, held against
    ``forward`` over the whole sequence at the reference test's 2e-2
    (``tests/test_models_smoke.py``) with the weights cast to f32; and in
    bf16 as shipped, where the gate is bf16's own rounding: if decode and
    forward are each as close to the f32 forward of the same weights as
    bf16 allows (``noise``, the bf16 forward's largest distance from it),
    they differ by at most ``2 * noise`` (the triangle inequality). At
    stablelm-1.6b's 24 layers bf16 alone moves the logits by ~0.07, past
    2e-2 (PERF.md, phase 8)."""
    import torch
    from repro_torch.data import lm_token_batch
    from repro_torch.models import transformer
    from repro_torch._tree import tree_map

    S = prompt + steps
    toks = torch.from_numpy(lm_token_batch(cfg.vocab_size, batch, S - 1,
                                           seed=seed)).to(dev)
    out = {}

    def run(p, dtype):
        with torch.inference_mode():
            full, _ = transformer.forward(cfg, p, toks)
            pre, pcache = transformer.prefill(cfg, p, toks[:, :prompt])
            cache = {n: torch.zeros((cfg.num_layers, batch, S,
                                     cfg.num_kv_heads, cfg.head_dim),
                                    dtype=dtype, device=dev)
                     for n in ("k", "v")}
            for n in cache:
                cache[n][:, :, :prompt] = pcache[n]
            del pcache
            diffs = [(pre, full[:, prompt - 1])]
            _sync(dev)
            t0 = time.perf_counter()
            for q in range(prompt, S):
                logits, cache = transformer.decode_step(
                    cfg, p, cache, toks[:, q],
                    torch.full((batch,), q, device=dev))
                diffs.append((logits, full[:, q]))
            _sync(dev)
            sec = time.perf_counter() - t0
        ok = all(torch.allclose(a, b, rtol=2e-2, atol=2e-2) for a, b in diffs)
        err = max(float((a - b).abs().max()) for a, b in diffs)
        return full, ok, err, batch * steps / sec

    full16, _, err16, tps = run(params, torch.bfloat16)
    full32, ok32, err32, _ = run(tree_map(lambda w: w.float(), params),
                                 torch.float32)
    noise = float((full16 - full32).abs().max())
    out = {"bf16_max_abs_err": err16, "f32_max_abs_err": err32,
           "bf16_vs_f32_forward_max_abs": noise, "tokens_per_s": tps}
    log(f"decode ({cfg.name}): {batch} prompts of {prompt} + {steps} steps, "
        f"{tps:.1f} tokens/s in bf16; max |decode - forward| f32 {err32:.3g} "
        f"(2e-2 allowed), bf16 {err16:.4g} (bf16 forward vs f32 forward "
        f"{noise:.4g})")
    check(ok32, f"f32 decode logits differ from forward's by up to "
                f"{err32:.4g} (2e-2 allowed)")
    check(err16 <= 2 * noise, f"bf16 decode differs from forward by "
                              f"{err16:.4g}, more than twice bf16's own "
                              f"rounding ({noise:.4g})")
    return out


def catalogue_phase(cfgs, bulk=262_144, serve=512, catalogue=131_072,
                    churn_share=0.01, seed=0, dev="cuda"):
    """The recsys towers at ``cfgs`` (kind -> config), one at a time, each
    freed before the next: wide-deep at ``serve`` and ``bulk`` rows through
    the ``embed_bag`` kernel, held against the plain bag; AutoInt and DIEN
    at ``serve`` rows; SASRec's brute-force retrieval over the whole
    catalogue, then its first ``catalogue`` items in an ``ip``
    ``VectorIndex`` with ``churn_share`` delisted and as many new items
    listed (``examples/recsys_retrieval.py``)."""
    import numpy as np
    import torch
    import repro_torch.core as T
    from repro_torch import api
    from repro_torch.core.reach import bfs_unreachable, indegree_unreachable
    from repro_torch.data import recsys_batch
    from repro_torch.kernels.embed_bag import embed_bag_ref
    from repro_torch.models import recsys

    out = {}

    def free():
        _sync(dev)
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()

    def timed_forward(cfg, params, n, **kw):
        batch = recsys.batch_to(recsys_batch(cfg, n, seed=1), dev)
        _sync(dev)
        t0 = time.perf_counter()
        logit, user = recsys.forward(cfg, params, batch, **kw)
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        check(tuple(logit.shape) == (n,) and tuple(user.shape) == (
            n, cfg.embed_dim) and bool(torch.isfinite(logit).all())
              and bool(torch.isfinite(user).all()),
              f"{cfg.name} forward at batch {n}")
        return batch, logit, user, ms

    with torch.inference_mode():
        cfg = cfgs["wide_deep"]
        params = recsys.init_params(cfg, seed=seed, device=dev)
        wd = {}
        for n in (serve, bulk):
            batch, logit, user, ms = timed_forward(cfg, params, n)
            rl, ru = recsys.forward(cfg, params, batch, bag=embed_bag_ref)
            err = max(float((logit - rl).abs().max()),
                      float((user - ru).abs().max()))
            check(torch.allclose(logit, rl, rtol=TOL, atol=TOL)
                  and torch.allclose(user, ru, rtol=TOL, atol=TOL),
                  f"wide-deep at batch {n}: the embed_bag kernel's forward "
                  f"differs from the plain bag's by {err:.3g}")
            wd[n] = {"ms": ms, "max_abs_err_vs_plain_bag": err}
            del batch, logit, user, rl, ru
        out["wide_deep"] = wd
        del params
        free()
        for kind in ("autoint", "dien"):
            cfg = cfgs[kind]
            params = recsys.init_params(cfg, seed=seed, device=dev)
            *_, ms = timed_forward(cfg, params, serve)
            out[kind] = {"ms": ms}
            del params
            free()

        cfg = cfgs["sasrec"]
        params = recsys.init_params(cfg, seed=seed, device=dev)
        batch = recsys.batch_to(recsys_batch(cfg, serve, seed=1), dev)
        _sync(dev)
        t0 = time.perf_counter()
        u = recsys.user_repr(cfg, params, batch)
        top, ids = recsys.retrieval_scores(cfg, params, batch, k=100)
        _sync(dev)
        out["sasrec"] = {"retrieval_ms": (time.perf_counter() - t0) * 1e3}
        scores = u @ params["item_embed"].T
        scores[:, cfg.n_items:] = -float("inf")
        srt = torch.sort(scores[0], descending=True, stable=True)
        check(torch.equal(ids[0], srt.indices[:100])
              and torch.equal(top[0], srt.values[:100]),
              "SASRec retrieval top-100 differs from a stable sort")
        check(bool((ids < cfg.n_items).all()), "a padding row was retrieved")
        del scores, srt

        items = params["item_embed"][:catalogue].cpu().numpy()
        D = cfg.embed_dim
        vi = api.create(space="ip", dim=D, capacity=catalogue, M=16,
                        ef_construction=64, num_layers=4, ef_search=64,
                        strategy="mn_ru_gamma", seed=seed, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        vi.add_items(items)
        _sync(dev)
        build_s = time.perf_counter() - t0
        def1 = vi.health().asdict()["unreachable_def1"]
        rng = np.random.default_rng(seed + 51)
        n_churn = max(int(churn_share * catalogue), 1)
        delisted = rng.choice(catalogue, n_churn, replace=False)
        new_items = rng.normal(size=(n_churn, D)).astype(np.float32)
        new_items /= np.linalg.norm(new_items, axis=1, keepdims=True)
        new_labels = cfg.n_items + np.arange(n_churn)
        _sync(dev)
        t0 = time.perf_counter()
        vi.mark_deleted(delisted)
        vi.replace_items(new_items, new_labels)
        _sync(dev)
        churn_s = time.perf_counter() - t0
        check(vi.count == catalogue, "catalogue live count after churn")
        uq = u.cpu().numpy()
        g_lab, _ = vi.knn_query(uq, k=K)
        check(not np.isin(g_lab, delisted).any(),
              "a delisted item surfaced in a user's top-10")
        # each new item is reachable and its own exact 1-NN; the graph
        # tier's share is reported (ip is no metric: at ef_search 64 its
        # beam can miss a reachable item, PERF.md, phase 8)
        ix = vi.index
        slots = torch.tensor([T.slot_of_label(ix, int(lab))
                              for lab in new_labels], device=ix.device)
        stranded = int((indegree_unreachable(ix)[slots]
                        | bfs_unreachable(ix)[slots]).sum())
        check(stranded == 0, f"{stranded} newly listed items are "
                             f"unreachable")
        launches0 = topk_dist_launches()
        self_lab, _ = vi.knn_query(new_items, k=1, mode="exact")
        check(np.array_equal(self_lab[:, 0], new_labels),
              "a newly listed item is not its own exact 1-NN")
        e_lab, e_d = vi.knn_query(uq, k=K, mode="exact")
        exact_launches = topk_dist_launches() - launches0
        g_self, _ = vi.knn_query(new_items, k=1, mode="graph")
        self_hit = float(np.mean(g_self[:, 0] == new_labels))
        keep = np.ones(catalogue, bool)
        keep[delisted] = False
        live_lab = np.concatenate([np.nonzero(keep)[0], new_labels])
        live_vec = torch.from_numpy(np.concatenate([items[keep], new_items]
                                                   )).to(dev)
        bf = u @ live_vec.T
        bsrt = torch.sort(bf, dim=1, descending=True, stable=True)
        truth = live_lab[bsrt.indices[:, :K].cpu().numpy()]
        truth_d = 1.0 - bsrt.values[:, :K].cpu().numpy()
        exact = exact_recall(e_lab, e_d, truth, truth_d)
        check(exact == 1.0, f"catalogue exact-tier recall@{K} {exact}")
        graph = recall(g_lab, truth)
        out["sasrec"].update({
            "catalogue": catalogue, "build_s": build_s, "def1": def1,
            "churn": n_churn, "churn_s": churn_s,
            "def1_after_churn": vi.health().asdict()["unreachable_def1"],
            "graph_recall": graph, "exact_recall": exact,
            "exact_launches": exact_launches,
            "new_self_1nn_graph": self_hit})
        del params, vi, bf, live_vec
        free()
    log(f"catalogue: wide-deep forward {wd[serve]['ms']:.2f} ms at "
        f"{serve} rows, {wd[bulk]['ms']:.2f} ms at {bulk} (the bag on the "
        f"embed_bag kernel; vs the plain bag max abs err "
        f"{max(v['max_abs_err_vs_plain_bag'] for v in wd.values()):.3g}); "
        f"autoint {out['autoint']['ms']:.2f} ms, dien {out['dien']['ms']:.2f} "
        f"ms at {serve}; sasrec user_repr + top-100 over "
        f"{cfgs['sasrec'].items_padded} items {out['sasrec']['retrieval_ms']:.2f}"
        f" ms (equal to a stable sort); catalogue of {catalogue} built in "
        f"{build_s:.1f} s (Definition 1 {def1}), {n_churn} delisted + listed "
        f"in {churn_s:.2f} s; recall@{K} graph {graph:.4f}, exact {exact:.1f}"
        f"; new items reachable and their own exact 1-NN (graph tier "
        f"{self_hit:.4f}); no delisted item surfaced")
    return out


def substrate_phase(smoke=False, n_docs=None, catalogue=None, bulk=None,
                    dev="cuda"):
    """Phase 8: the RAG scenario on stablelm-1.6b, then the catalogue
    scenario on the four recsys towers, at their published configs:
    16,384 documents, a catalogue of 131,072 items, wide-deep's bulk batch
    of 262,144 (``smoke=True``: the reduced configs at 512 documents, 448
    items and 2,048 rows, a CPU rehearsal of a few minutes)."""
    from repro_torch.configs import get_config, get_smoke_config
    get = get_smoke_config if smoke else get_config
    sizes = (512, 448, 2048) if smoke else (16384, 131_072, 262_144)
    n_docs, catalogue, bulk = (given or default for given, default in
                               zip((n_docs, catalogue, bulk), sizes))
    out = {"rag": rag_phase(get("stablelm-1.6b"), n_docs=n_docs, dev=dev)}
    cfgs = {k: get(k) for k in ("wide_deep", "autoint", "dien", "sasrec")}
    out["catalogue"] = catalogue_phase(cfgs, bulk=bulk, catalogue=catalogue,
                                       dev=dev)
    return out


# ---------------------------------------------------------------------------
# phase 9: the training path
# ---------------------------------------------------------------------------

def _leaves(tree):
    from repro_torch._tree import tree_leaves
    return list(tree_leaves(tree))


def _free(dev):
    import torch
    _sync(dev)
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _peak_bytes(dev):
    import torch
    return (torch.cuda.max_memory_allocated() if torch.device(dev).type
            == "cuda" else None)


def _run_steps(step_fn, params, state, batches, dev):
    """Drive ``step_fn`` over ``batches`` (a function of the step); each
    step's host seconds after a sync, loss and grad norm."""
    out = {"s": [], "loss": [], "grad_norm": [], "aux": []}
    for s in range(len(batches)):
        batch = batches[s]()
        _sync(dev)
        t0 = time.perf_counter()
        params, state, met = step_fn(params, state, batch)
        _sync(dev)
        out["s"].append(time.perf_counter() - t0)
        out["loss"].append(float(met["loss"]))
        out["grad_norm"].append(float(met["grad_norm"]))
        out["aux"].append(float(met.get("aux", 0.0)))
    return params, state, out


def _check_trained(p0, p1, what):
    """The reference test's check, per leaf: every leaf finite and
    changed, except a leaf of zeros that stays zero (a bias the loss never
    reads, such as a tower's ``user_proj``: no gradient, and weight decay
    of zero is zero)."""
    import torch
    for (path, a), (_, b) in zip(_leaves(p0), _leaves(p1)):
        check(bool(torch.isfinite(b.float()).all()),
              f"{what}: leaf {path} not finite after training")
        a = a.to(b.device)
        check(bool((a != b).any()) or not (bool(a.any()) or bool(b.any())),
              f"{what}: leaf {path} never changed")


def lm_train(cfg, steps=4, batch=2, seq=4096, seed=0, dev="cuda",
             hold=None):
    """``steps`` AdamW steps of the ``train_4k`` cell's step at ``batch`` x
    ``seq`` (``make_train_step(lm_loss)``, remat on) on seed-drawn
    weights: every loss finite, step 1's CE within 1.0 of ln V, every leaf
    changed and finite. The step updates the parameters in place, so the
    initial ones are kept on the host for the check. Its FLOPs are the dry
    run's count of this step (``launch.dryrun``), beside the model FLOPs of
    the reference's roofline formula; ``hold`` names the cell phase 12
    holds to the card with one more step (``hold_cell``)."""
    import math
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import lm_token_batch
    from repro_torch.launch import dryrun
    from repro_torch.models import get_api
    from repro_torch.train import adamw_init

    _free(dev)
    api = get_api(cfg)
    shape = ShapeSpec("train_4k", "train", seq_len=seq, global_batch=batch)
    bundle = api.make_step(shape)
    trace = dryrun.trace_step(bundle.fn, dryrun.call_shapes(api, bundle))
    t0 = time.perf_counter()
    params = api.init_params(seed=seed, device=dev)
    state = adamw_init(params)
    _sync(dev)
    init_s = time.perf_counter() - t0
    step_fn = bundle.fn
    batches = [lambda s=s: {"tokens": torch.from_numpy(lm_token_batch(
        cfg.vocab_size, batch, seq, seed=s)).to(dev)} for s in range(steps)]
    p0 = _host_tree(params)
    p1, state, out = _run_steps(step_fn, params, state, batches, dev)
    check(all(math.isfinite(x) for x in out["loss"] + out["grad_norm"]),
          f"{cfg.name}: a loss or grad norm is not finite: {out}")
    ln_v = math.log(cfg.vocab_size)
    check(abs(out["loss"][0] - ln_v) <= 1.0,
          f"{cfg.name}: step 1's loss {out['loss'][0]:.4f} is not within 1.0 "
          f"of ln V = {ln_v:.4f}")
    _check_trained(p0, p1, cfg.name)
    n_params = sum(p.numel() for _, p in _leaves(params))
    warm = out["s"][1:] or out["s"]
    out.update({"arch": cfg.name, "params": n_params, "batch": batch,
                "seq": seq, "init_s": init_s,
                "s_per_step": float(np.mean(warm)),
                "tokens_per_s": batch * seq / float(np.mean(warm)),
                "counted_tflop_per_step": trace["cost"]["flops"] / 1e12,
                "model_tflop_per_step": dryrun.model_flops(cfg, shape) / 1e12,
                "trace_s": trace["seconds"],
                "peak_bytes": _peak_bytes(dev), "ln_v": ln_v})
    for k in ("counted", "model"):
        out[f"{k}_tflop_per_s"] = out[f"{k}_tflop_per_step"] \
            / out["s_per_step"]
    log(f"train {cfg.name} ({n_params:,} params, bf16; batch {batch} x "
        f"{seq}, remat): init "
        f"{init_s:.1f} s; steps "
        + ", ".join(f"{s:.3f}" for s in out["s"])
        + f" s (step 1 warm-up); {out['s_per_step']:.4f} s/step, "
        f"{out['tokens_per_s']:.0f} tokens/s, "
        f"{out['counted_tflop_per_step']:.3f} TFLOP a step counted "
        f"({out['counted_tflop_per_s']:.2f} TFLOP/s), "
        f"{out['model_tflop_per_step']:.3f} model "
        f"({out['model_tflop_per_s']:.2f} TFLOP/s); losses "
        + ", ".join(f"{x:.4f}" for x in out["loss"])
        + f" (ln V {ln_v:.4f}); grad norms "
        + ", ".join(f"{x:.4f}" for x in out["grad_norm"])
        + (f"; aux {', '.join(f'{x:.4f}' for x in out['aux'])} (step 1's CE "
           f"held to ln V, not the loss with 0.01 x aux)" if cfg.moe else "")
        + f"; peak {out['peak_bytes']} bytes; every leaf changed and finite")
    if hold:
        hold_cell(hold, step_fn, [p1, state, batches[0]()],
                  out["s_per_step"], dev, trace)
    del params, p0, p1, state
    _free(dev)
    return out


def _host_tree(tree):
    """A copy of a parameter tree on the host."""
    from repro_torch._tree import tree_map
    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def _leaf_err(a, b):
    """``max |a - b|`` over ``b``'s largest magnitude: a leaf held to its own
    scale, so a leaf of small values (wide-deep's gradients are ~1e-7) is
    not passed by an absolute tolerance alone."""
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def bag_gradient_check(table, ids, dev, seed=0):
    """``EmbedBagFunction`` (the kernel forward, the scatter-add backward)
    against autograd through ``embed_bag_ref`` at the training batch's
    shape, with an O(1) output gradient: the output and the table's
    gradient, each within ``TOL`` of its own largest magnitude. The check
    must see a backward that returns zeros, scatters to the wrong rows or
    means instead of summing: each is held to fail it. Calls the Function,
    not the wrapper: a comparison, not counted."""
    import torch
    from repro_torch.kernels.embed_bag import (EmbedBagFunction,
                                               embed_bag_backward_ref,
                                               embed_bag_ref)
    V = table.shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    gout = torch.randn((ids.shape[0], table.shape[1]), generator=gen,
                       device=dev)
    tk = table.detach().requires_grad_()
    out_k = EmbedBagFunction.apply(tk, ids, "sum")
    out_k.backward(gout)
    tr = table.detach().requires_grad_()
    out_r = embed_bag_ref(tr, ids, "sum")
    out_r.backward(gout)
    res = {"forward_rel_err": _leaf_err(out_k, out_r),
           "backward_rel_err": _leaf_err(tk.grad, tr.grad)}
    wrong = {"zeros": torch.zeros_like(tr.grad),
             "rows_shifted": tr.grad.roll(1, 0),
             "mean_not_sum": embed_bag_backward_ref(gout, ids, V, table.dtype,
                                                    "mean")}
    res["wrong_backward_rel_err"] = {k: _leaf_err(w, tr.grad)
                                     for k, w in wrong.items()}
    log(f"bag gradient ({ids.shape[0]} x {ids.shape[1]} ids over {V} x "
        f"{table.shape[1]}, N(0, 1) output gradient): EmbedBagFunction vs "
        f"autograd through embed_bag_ref, relative to each one's largest "
        f"magnitude: forward {res['forward_rel_err']:.3g}, table gradient "
        f"{res['backward_rel_err']:.3g} ({TOL} allowed); a wrong backward "
        f"would be off by " + ", ".join(
            f"{k} {v:.3g}" for k, v in res["wrong_backward_rel_err"].items()))
    check(res["forward_rel_err"] <= TOL,
          f"the bag kernel's forward vs the plain bag: "
          f"{res['forward_rel_err']:.3g} relative")
    check(res["backward_rel_err"] <= TOL,
          f"EmbedBagFunction's table gradient vs autograd through the plain "
          f"bag: {res['backward_rel_err']:.3g} relative")
    for k, e in res["wrong_backward_rel_err"].items():
        check(e > TOL, f"the bag gradient check cannot see a backward that "
                       f"is wrong by {k} ({e:.3g} relative)")
    return res


def recsys_train(cfg, steps=5, batch=65_536, seed=0, dev="cuda"):
    """wide-deep: one step's loss and every gradient leaf with the bag on
    the kernel (``EmbedBagFunction``) held to the same step with the plain
    bag pinned to the kernel's values, each leaf within ``TOL`` of its own
    largest magnitude, and the loss with the plain bag's own; the bag's
    Function alone against the plain bag's autograd at the batch's shape
    (``bag_gradient_check``); its forward and backward timed alone (CUDA
    events) beside the backward's bound; then ``steps`` AdamW steps through
    the kernel (the launches the caller counts)."""
    import math
    import numpy as np
    import torch
    from functools import partial
    from repro_torch.data import recsys_batch
    from repro_torch.kernels.embed_bag import (EmbedBagFunction, embed_bag,
                                               embed_bag_backward_ref,
                                               embed_bag_ref)
    from repro_torch.models import (get_api, make_train_step, recsys,
                                    value_and_grad)
    from repro_torch.train import adamw_init
    from repro_torch.train.checkpoint import keystr

    _free(dev)
    api = get_api(cfg)
    t0 = time.perf_counter()
    params = api.init_params(seed=seed, device=dev)
    state = adamw_init(params)
    _sync(dev)
    init_s = time.perf_counter() - t0
    b0 = recsys.batch_to(recsys_batch(cfg, batch, seed=0), dev)
    out = {"arch": cfg.name, "batch": batch, "init_s": init_s}

    # the kernel's step against the plain bag's (not counted: a
    # comparison). Left to its own f32 sums, the plain bag flips the few
    # ReLUs whose input lies within that rounding of zero, and a flipped
    # unit moves one row's gradient by percents: so the plain bag is also
    # run pinned to the kernel's output values, bit for bit (k + (r - r),
    # r - r being exactly 0), with its own autograd, and every leaf of that
    # step is held to the kernel's; the unpinned step's loss is held, its
    # leaves and flips reported
    def pinned_bag(t, i, mode):
        r = embed_bag_ref(t, i, mode)
        return embed_bag(t.detach(), i, mode) + (r - r.detach())

    launches0 = embed_bag.launches
    (lk, _), gk = value_and_grad(partial(recsys.loss_fn, cfg), params, b0)
    on_card = torch.device(dev).type == "cuda"
    check(embed_bag.launches - launches0 == int(on_card),
          "wide-deep's gradient step did not launch embed_bag")
    (lp, _), gp = value_and_grad(partial(recsys.loss_fn, cfg,
                                         bag=pinned_bag), params, b0)
    out["loss_rel_err_vs_pinned_plain_bag"] = e = (
        abs(float(lk) - float(lp)) / max(abs(float(lp)), 1e-30))
    check(e <= TOL, f"wide-deep loss with the kernel bag {float(lk)} vs "
                    f"the pinned plain bag {float(lp)}")
    leaf_err = {}
    for (path, a), (_, b) in zip(_leaves(gk), _leaves(gp)):
        e = leaf_err[keystr(path)] = _leaf_err(a, b)
        check(e <= TOL, f"wide-deep gradient {path}: kernel bag vs pinned "
                        f"plain bag {e:.3g} of its largest magnitude")
    del gp
    out["grad_rel_err_vs_pinned_plain_bag"] = leaf_err
    err = max(leaf_err.values())
    out["max_rel_err_vs_pinned_plain_bag"] = err
    (lr_, _), gr = value_and_grad(partial(recsys.loss_fn, cfg,
                                          bag=embed_bag_ref), params, b0)
    out["loss_rel_err_vs_plain_bag"] = loss_err = (
        abs(float(lk) - float(lr_)) / max(abs(float(lr_)), 1e-30))
    check(loss_err <= TOL, f"wide-deep loss with the kernel bag {float(lk)} "
                           f"vs the plain bag {float(lr_)}")
    out["grad_rel_err_vs_plain_bag"] = {
        keystr(path): _leaf_err(a, b)
        for (path, a), (_, b) in zip(_leaves(gk), _leaves(gr))}
    del gr
    with torch.no_grad():
        emb = params["tables"][torch.arange(cfg.n_sparse, device=dev)[None, :],
                               b0["sparse_ids"].long()].flatten(1)
        w1 = params["mlp"][0]
        pre = [recsys._apply(w1, torch.cat([emb, bag(
            params["bag_table"], b0["bag_ids"], "sum")], dim=-1)) > 0
            for bag in (embed_bag, embed_bag_ref)]
        out["first_layer_relu_flips"] = int((pre[0] != pre[1]).sum())
        del emb, pre
    embed_bag.launches = launches0      # comparisons: not the path's
    rows_hit = int((gk["bag_table"].abs().sum(1) > 0).sum())
    del gk
    _free(dev)

    # the bag alone: the Function against the plain bag's autograd, then
    # forward (the kernel) and backward (the scatter-add) timed
    table, ids = params["bag_table"], b0["bag_ids"]
    V, Dm = table.shape
    if on_card:
        launches0 = embed_bag.launches
        out["bag_check"] = bag_gradient_check(table, ids, dev, seed)
        _free(dev)
        gout = torch.randn((batch, Dm), device=dev)
        # the Function itself (its op counts these launches, put back
        # below: measurements, not the path's)
        fwd_ms = events_ms(lambda: EmbedBagFunction.apply(
            table.detach().requires_grad_(), ids, "sum"), 20)
        bwd_ms = events_ms(lambda: embed_bag_backward_ref(
            gout, ids, V, table.dtype, "sum"), 20)
        valid = ids[ids >= 0]
        distinct = int(torch.unique(valid).numel())
        # the least the backward must move: the output gradient and the ids
        # read once, the dense [V, D] gradient written once; its adds are
        # B * L * D f32 operations
        need = (gout.numel() * 4 + ids.numel() * ids.element_size()
                + V * Dm * table.element_size())
        bound = max(need / PEAK_BYTES, valid.numel() * Dm / PEAK_F32_FLOPS) * 1e3
        out["bag"] = {"forward_ms": fwd_ms, "backward_ms": bwd_ms,
                      "backward_bound_ms": bound, "backward_bytes": need,
                      # a sparse model beside it: the output gradient read
                      # once, each touched row read and written once
                      "backward_rmw_model_ms": (gout.numel() * 4 + 2 * distinct
                                                * Dm * 4) / PEAK_BYTES * 1e3,
                      "dense_grad_write_ms": V * Dm * 4 / PEAK_BYTES * 1e3,
                      "valid_ids": int(valid.numel()),
                      "distinct_rows": distinct, "rows_hit": rows_hit}
        del gout
        embed_bag.launches = launches0

    # the path: AdamW steps, the bag on the kernel
    step_fn = make_train_step(partial(recsys.loss_fn, cfg), api.opt_cfg)
    batches = [lambda: b0] + [
        lambda s=s: recsys.batch_to(recsys_batch(cfg, batch, seed=s), dev)
        for s in range(1, steps)]
    launches0 = embed_bag.launches
    p0 = _host_tree(params)                # the step updates in place
    p1, state, run = _run_steps(step_fn, params, state, batches, dev)
    out["launches"] = embed_bag.launches - launches0
    check(out["launches"] == steps * int(on_card),
          f"wide-deep's {steps} steps launched embed_bag "
          f"{out['launches']} times")
    out.update(run)
    check(all(math.isfinite(x) for x in run["loss"] + run["grad_norm"]),
          f"wide-deep: a loss or grad norm is not finite: {run}")
    _check_trained(p0, p1, cfg.name)
    warm = run["s"][1:] or run["s"]
    out.update({"s_per_step": float(np.mean(warm)),
                "rows_per_s": batch / float(np.mean(warm)),
                "peak_bytes": _peak_bytes(dev),
                "params": sum(p.numel() for _, p in _leaves(params))})
    # phase 12: one more step, counted (not the path's launch)
    launches0 = embed_bag.launches
    hold_cell("wide-deep train_batch", step_fn, [p1, state, b0],
              out["s_per_step"], dev)
    embed_bag.launches = launches0
    bag = out.get("bag")
    log(f"train {cfg.name} ({out['params']:,} params, f32; batch {batch}): "
        f"init {init_s:.1f} s; kernel bag vs the plain bag pinned to its "
        f"values: loss {out['loss_rel_err_vs_pinned_plain_bag']:.3g} "
        f"relative, every gradient leaf within {TOL} of its own largest "
        f"magnitude (largest {err:.3g}); vs the plain bag's own "
        f"sums: loss {out['loss_rel_err_vs_plain_bag']:.3g} relative, "
        f"{out['first_layer_relu_flips']} first-layer ReLUs flipped, leaves "
        f"up to {max(out['grad_rel_err_vs_plain_bag'].values()):.3g} of "
        f"their largest; steps "
        + ", ".join(f"{s:.4f}" for s in run["s"])
        + f" s; {out['s_per_step']:.4f} s/step, {out['rows_per_s']:.0f} "
        f"rows/s; losses " + ", ".join(f"{x:.4f}" for x in run["loss"])
        + f"; peak {out['peak_bytes']} bytes"
        + (f"; bag forward {bag['forward_ms']:.4f} ms, backward "
           f"{bag['backward_ms']:.4f} ms (bound {bag['backward_bound_ms']:.4f}"
           f" ms: {bag['backward_bytes']} bytes read and written; touched "
           f"rows read-modify-written instead, {bag['distinct_rows']} of them"
           f": {bag['backward_rmw_model_ms']:.4f} ms)"
           if bag else ""))
    del params, p0, p1, state, b0
    _free(dev)
    return out


def cli_train(dev="cuda", seed=0):
    """``python -m repro_torch.launch.train`` at the reference test's flags
    (``tests/test_system.py``): a crash injected at step 25, the checkpoint
    of step 20 restored through the port's manager equal to its npz, then
    ``--resume`` from step 20."""
    import os
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer
    from repro_torch.train import CheckpointManager, adamw_init, compress_init
    from repro_torch.train.checkpoint import keystr

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = {}
    with tempfile.TemporaryDirectory() as ckpt:
        base = [sys.executable, "-m", "repro_torch.launch.train", "--device",
                str(dev), "--arch", "stablelm-1.6b", "--steps", "30",
                "--batch", "2", "--seq", "32", "--ckpt-dir", ckpt,
                "--ckpt-every", "10", "--log-every", "10"]
        t0 = time.perf_counter()
        r = subprocess.run(base + ["--fail-at-step", "25"], env=env,
                           capture_output=True, text=True, timeout=300)
        out["crash_s"] = time.perf_counter() - t0
        check(r.returncode != 0 and "injected failure" in r.stderr,
              f"the trainer did not fail at the injected step:\n{r.stdout}\n"
              f"{r.stderr[-2000:]}")
        mgr = CheckpointManager(ckpt)
        check(mgr.all_steps() == [10, 20],
              f"checkpoints after the crash: {mgr.all_steps()}")
        cfg = get_smoke_config("stablelm-1.6b")
        params = transformer.init_params(cfg, seed=seed, device=dev)
        like = {"params": params, "opt": adamw_init(params),
                "ef": compress_init(params)}
        state, meta = mgr.restore(like)
        check(meta["step"] == 20, f"restored step {meta['step']}")
        with np.load(os.path.join(ckpt, "ckpt_0000000020", "state.npz")) as z:
            for path, t in _leaves(state):
                a = z[keystr(path)]
                check(t.device.type == torch.device(dev).type
                      and np.array_equal(t.float().cpu().numpy(),
                                         a.astype(np.float32)),
                      f"restored leaf {path} differs from the saved one")
        t0 = time.perf_counter()
        r2 = subprocess.run(base + ["--resume"], env=env,
                            capture_output=True, text=True, timeout=300)
        out["resume_s"] = time.perf_counter() - t0
        check(r2.returncode == 0 and "resumed from step 20" in r2.stdout,
              f"the trainer did not resume from step 20:\n{r2.stdout}\n"
              f"{r2.stderr[-2000:]}")
        out["resume_log"] = r2.stdout.strip().splitlines()
    log(f"trainer CLI: injected failure at step 25 ({out['crash_s']:.1f} s), "
        f"step 20's checkpoint restored equal to its npz, resumed from step "
        f"20 ({out['resume_s']:.1f} s): {out['resume_log'][-1]}")
    return out


def train_phase(smoke=False, dev="cuda"):
    """Phase 9: stablelm-1.6b (4 steps at 2 x 4,096, remat) and wide-deep
    (5 steps at 65,536 rows, the bag on ``embed_bag``) at their published
    widths, then the trainer's CLI crash and resume (``smoke=True``: the
    reduced configs at 2 x 512 and 2,048 rows, a CPU rehearsal)."""
    from repro_torch.configs import get_config, get_smoke_config
    get = get_smoke_config if smoke else get_config
    seq, rows = (512, 2048) if smoke else (4096, 65_536)
    return {"lm": lm_train(get("stablelm-1.6b"), seq=seq, dev=dev,
                           hold="stablelm-1.6b train_4k"),
            "recsys": recsys_train(get("wide_deep"), batch=rows, dev=dev),
            "cli": cli_train(dev=dev)}


# ---------------------------------------------------------------------------
# phase 10: the MoE LMs
# ---------------------------------------------------------------------------

BF16_TOL = 2e-2     # bf16 as shipped (tests/torch_train_parity.py)


def no_drop(cfg):
    """``cfg`` with a capacity factor at which no expert can overflow: C
    is at least the block's token count (E / K, with a margin for the
    float rounding of ``capacity``)."""
    import dataclasses
    return dataclasses.replace(cfg, capacity_factor=cfg.num_experts
                               / cfg.top_k * 1.001)


def _moe_walk(cfg, params, tokens, dev, visit):
    """The forward over ``tokens`` layer by layer; at each MoE layer,
    ``visit(lp, h)`` takes the FFN's input ``h [B*S, D]`` and returns the
    layer's FFN output."""
    import torch
    from repro_torch.models import transformer as tf

    B, S = tokens.shape
    with torch.inference_mode():
        x = params["embed"][tokens.long()]
        pos = torch.arange(S, device=dev).expand(B, S)
        for lp, moe in tf._stacks(cfg, params):
            if not moe:
                x, _ = tf._block(cfg, lp, x, pos, False)
                continue
            x = x + tf.gqa_attention(cfg, lp, tf.rmsnorm(
                x, lp["attn_norm"], cfg.norm_eps), pos)
            h = tf.rmsnorm(x, lp["ffn_norm"], cfg.norm_eps).reshape(B * S, -1)
            x = x + visit(lp, h).reshape(B, S, -1)


def _expert_load(cfg, lp, h):
    """Assignments each expert receives from the block ``h`` (all ``top_k``
    choices), before the capacity drops any."""
    import torch
    from repro_torch.models import transformer as tf
    flat_e = tf._moe_route(cfg, lp["router"], h,
                           tf.capacity(cfg, h.shape[0]))[0]
    return torch.bincount(flat_e, minlength=cfg.num_experts).tolist()


def moe_layer_check(cfg, params, tokens, dev):
    """The forward over ``tokens`` layer by layer, each MoE layer's
    ``moe_ffn`` on its real hidden state held against ``moe_ffn_ref`` (a
    plain loop over the experts, the same capacity and drop order) at
    bf16's tolerance; each MoE layer's error, dropped assignments and
    per-expert load."""
    import torch
    from repro_torch.models import transformer as tf

    errs, dropped, load = [], [], []

    def visit(lp, h):
        y, aux = tf.moe_ffn(cfg, lp, h)
        yr, auxr, drop = tf.moe_ffn_ref(cfg, lp, h)
        errs.append(float((y.float() - yr.float()).abs().max()))
        dropped.append(drop)
        load.append(_expert_load(cfg, lp, h))
        check(torch.allclose(y.float(), yr.float(), rtol=BF16_TOL,
                             atol=BF16_TOL) and torch.equal(aux, auxr),
              f"{cfg.name} MoE layer {len(errs)}: moe_ffn differs from "
              f"the per-expert loop by {errs[-1]:.4g}")
        return y
    _moe_walk(cfg, params, tokens, dev, visit)
    return errs, dropped, load


def moe_route_stats(cfg, params, tokens, dev):
    """Each MoE layer's dropped assignments and per-expert load over
    ``tokens`` (the forward layer by layer, ``moe_ffn`` unchecked)."""
    from repro_torch.models import transformer as tf

    dropped, load = [], []

    def visit(lp, h):
        C = tf.capacity(cfg, h.shape[0])
        keep = tf._moe_route(cfg, lp["router"], h, C)[2]
        dropped.append(int((~keep).sum()))
        load.append(_expert_load(cfg, lp, h))
        return tf.moe_ffn(cfg, lp, h)[0]
    _moe_walk(cfg, params, tokens, dev, visit)
    return dropped, load


def _load_summary(load):
    """The busiest expert's share of a layer's assignments against an even
    share, and how many experts receive none."""
    n = sum(load)
    return {"max_share": max(load) / n, "even_share": 1 / len(load),
            "idle_experts": sum(1 for c in load if c == 0),
            "max_over_even": max(load) * len(load) / n}


def moe_decode(cfg, params, toks, prompt, dev):
    """``prefill`` of ``toks[:, :prompt]``, then a ``decode_step`` at each
    later position through a cache written in place: the logits of the
    last prompt position and of every step ``[B, 1 + steps, V]`` (those of
    ``forward`` at ``prompt - 1`` onwards), and decode tokens/s."""
    import torch
    from repro_torch.models import transformer as tf

    B, S = toks.shape
    with torch.inference_mode():
        pre, pcache = tf.prefill(cfg, params, toks[:, :prompt])
        cache = {n: torch.zeros((cfg.num_layers, B, S, cfg.num_kv_heads,
                                 cfg.head_dim), dtype=pcache[n].dtype,
                                device=dev) for n in ("k", "v")}
        for n in cache:
            cache[n][:, :, :prompt] = pcache[n]
        del pcache
        out = [pre]
        _sync(dev)
        t0 = time.perf_counter()
        for q in range(prompt, S):
            logits, cache = tf.decode_step(cfg, params, cache, toks[:, q],
                                           torch.full((B,), q, device=dev))
            out.append(logits)
        _sync(dev)
        tps = B * (S - prompt) / (time.perf_counter() - t0)
    return torch.stack(out, 1), tps


def f32_forward_logits(cfg, params, toks, first, dev):
    """``forward``'s logits at positions ``first`` onwards with every
    weight widened to f32 one layer at a time (an f32 copy of the whole
    model would not fit beside the bf16 one): bf16's rounding floor."""
    import torch
    from repro_torch.models import transformer as tf

    B, S = toks.shape
    with torch.inference_mode():
        x = params["embed"][toks.long()].float()
        pos = torch.arange(S, device=dev).expand(B, S)
        for lp, moe in tf._stacks(cfg, params):
            x, _ = tf._block(cfg, {k: v.float() for k, v in lp.items()}, x,
                             pos, moe)
        x = tf.rmsnorm(x[:, first:], params["final_norm"], cfg.norm_eps)
        return (x @ params["lm_head"].float())[..., :cfg.vocab_size]


def deepseek_serve(cfg, batch=4, prompt=2048, steps=16, seed=0, dev="cuda"):
    """deepseek-moe-16b at its published width and depth: every MoE
    layer's ``moe_ffn`` held against ``moe_ffn_ref`` on the prompt's real
    hidden states; ``forward`` and ``prefill`` timed; then ``steps`` decode
    steps held to ``forward``, where nothing can drop (``no_drop``; decode
    routes each step's ``batch`` tokens as one block, with its own
    capacity) within twice bf16's rounding floor (the bf16 forward against
    the f32 one), and at the published capacity factor, where the gap is
    reported."""
    import math
    import torch
    from repro_torch.data import lm_token_batch
    from repro_torch.models import transformer as tf

    _free(dev)
    out = {"arch": cfg.name, "batch": batch, "prompt": prompt,
           "steps": steps}
    t0 = time.perf_counter()
    params = tf.init_params(cfg, seed=seed, device=dev)
    _sync(dev)
    out["init_s"] = time.perf_counter() - t0
    out["params"] = sum(p.numel() for _, p in _leaves(params))
    out["param_bytes"] = sum(p.numel() * p.element_size()
                             for _, p in _leaves(params))
    # lm_token_batch gives seq + 1 tokens: the prompt and ``steps`` more
    toks = torch.from_numpy(lm_token_batch(cfg.vocab_size, batch,
                                           prompt + steps - 1,
                                           seed=seed)).to(dev)
    t0 = time.perf_counter()
    out["layer_err"], out["dropped"], out["expert_load"] = moe_layer_check(
        cfg, params, toks[:, :prompt], dev)
    out["layer_check_s"] = time.perf_counter() - t0
    # the same routing over tokens drawn uniformly from the vocabulary: a
    # drop share that falls there comes from the Zipf stream's repeats, one
    # that stays from the router or the hidden states
    gen = torch.Generator(device=dev).manual_seed(seed)
    uni = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=gen,
                        device=dev, dtype=torch.int32)
    out["dropped_uniform"], out["expert_load_uniform"] = moe_route_stats(
        cfg, params, uni, dev)
    del uni
    out["load_first_moe_layer"] = {
        "zipf": _load_summary(out["expert_load"][0]),
        "uniform": _load_summary(out["expert_load_uniform"][0])}

    with torch.inference_mode():
        fwd = lambda: tf.forward(cfg, params, toks[:, :prompt])  # noqa: E731
        fwd()
        _sync(dev)
        t0 = time.perf_counter()
        logits, aux = fwd()
        _sync(dev)
        out["forward_ms"] = 1e3 * (time.perf_counter() - t0)
        check(bool(torch.isfinite(logits).all()) and math.isfinite(
            float(aux)), f"{cfg.name}: forward not finite")
        del logits
        t0 = time.perf_counter()
        tf.prefill(cfg, params, toks[:, :prompt])
        _sync(dev)
        out["prefill_ms"] = 1e3 * (time.perf_counter() - t0)
        hold_cell(f"{cfg.name} prefill {batch} x {prompt}",
                  lambda p, b: tf.prefill(cfg, p, b["tokens"]),
                  [params, {"tokens": toks[:, :prompt].contiguous()}],
                  out["prefill_ms"] / 1e3, dev)
    out["forward_tokens_per_s"] = batch * prompt / out["forward_ms"] * 1e3
    out["peak_bytes_forward"] = _peak_bytes(dev)

    gaps = {}
    for name, c in (("published", cfg), ("no_drop", no_drop(cfg))):
        dec, tps = moe_decode(c, params, toks, prompt, dev)
        with torch.inference_mode():
            full, _ = tf.forward(c, params, toks)
            full = full[:, prompt - 1:]
        gaps[name] = float((dec - full).abs().max())
        out[f"decode_tokens_per_s_{name}"] = tps
        if name == "no_drop":
            f32 = f32_forward_logits(c, params, toks, prompt - 1, dev)
            out["bf16_vs_f32_forward_max_abs"] = float(
                (full - f32).abs().max())
            out["decode_argmax_agree"] = float(
                (dec.argmax(-1) == full.argmax(-1)).float().mean())
        del dec, full
    out["decode_gap"] = gaps
    out["peak_bytes"] = _peak_bytes(dev)
    noise = out["bf16_vs_f32_forward_max_abs"]
    lz, lu = (out["load_first_moe_layer"][k] for k in ("zipf", "uniform"))
    log(f"serve {cfg.name} ({out['params']:,} params, "
        f"{out['param_bytes']} bytes in bf16, init {out['init_s']:.1f} s): "
        f"{len(out['layer_err'])} MoE layers held to moe_ffn_ref on the "
        f"prompt's hidden states (max err {max(out['layer_err']):.4g}, "
        f"{BF16_TOL} allowed; {out['layer_check_s']:.1f} s); dropped "
        f"assignments a layer at capacity factor {cfg.capacity_factor}: "
        f"{min(out['dropped'])}-{max(out['dropped'])} of "
        f"{batch * prompt * cfg.top_k} on the Zipf prompt, "
        f"{min(out['dropped_uniform'])}-{max(out['dropped_uniform'])} on "
        f"uniform tokens; first MoE layer's busiest expert "
        f"{lz['max_over_even']:.2f}x an even share ({lz['idle_experts']} "
        f"experts idle) on the Zipf prompt, {lu['max_over_even']:.2f}x "
        f"({lu['idle_experts']} idle) on uniform tokens; forward {batch} x "
        f"{prompt} "
        f"{out['forward_ms']:.1f} ms ({out['forward_tokens_per_s']:.0f} "
        f"tokens/s), prefill {out['prefill_ms']:.1f} ms; decode {steps} "
        f"steps: {out['decode_tokens_per_s_published']:.1f} tokens/s; max "
        f"|decode - forward| with nothing dropped {gaps['no_drop']:.4g} "
        f"(bf16 forward vs f32 {noise:.4g}; argmax agree "
        f"{out['decode_argmax_agree']:.4f}), at the published factor "
        f"{gaps['published']:.4g}; peak {out['peak_bytes']} bytes")
    check(gaps["no_drop"] <= 2 * noise,
          f"{cfg.name}: decode differs from forward by {gaps['no_drop']:.4g} "
          f"with nothing dropped, more than twice bf16's own rounding "
          f"({noise:.4g})")
    del params
    _free(dev)
    return out


def sharded_moe_check(cfgs, T=8192, seed=0, dev="cuda"):
    """One MoE layer of each config under ``use_mesh`` of a 1 x 4 grid of
    the card (granite: every expert's FFN columns in four slices; deepseek:
    its experts in four), against the unsharded call: one data block, so
    the same capacity and routing; only the slices' sum rounds."""
    import dataclasses
    import torch
    from repro_torch.launch.mesh import make_grid
    from repro_torch.models import dist_ctx, transformer as tf

    out = {}
    for cfg in cfgs:
        c = dataclasses.replace(cfg, num_layers=cfg.first_dense_layers + 1,
                                vocab_size=128)
        lp = {k: v[0] for k, v in tf.init_params(
            c, seed=seed, device=dev)["layers"].items()}
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(T, c.d_model, generator=gen,
                        device=dev).to(torch.bfloat16)
        with torch.inference_mode():
            whole, aux = tf.moe_ffn(c, lp, x)
            with dist_ctx.use_mesh(make_grid(1, 4, device=dev)):
                parts, aux4 = tf.moe_ffn(c, lp, x)
        err = float((parts.float() - whole.float()).abs().max())
        out[c.name] = {"moe_shard": c.moe_shard, "max_abs_err": err}
        check(torch.allclose(parts.float(), whole.float(), rtol=BF16_TOL,
                             atol=BF16_TOL) and torch.equal(aux, aux4),
              f"{c.name}: the 1 x 4 grid's MoE layer differs from the "
              f"unsharded one by {err:.4g}")
    log("sharded MoE on a 1 x 4 grid of the card, one data block, " + ", ".join(
        f"{k} ({v['moe_shard']} slices) max |sharded - unsharded| "
        f"{v['max_abs_err']:.4g}" for k, v in out.items()))
    return out


def moe_phase(smoke=False, dev="cuda"):
    """Phase 10: deepseek-moe-16b served at its published width and depth
    (``deepseek_serve``), granite-moe-3b-a800m as the RAG encoder of phase
    8's scenario (8,192 documents), both trained (granite at full depth,
    deepseek cut to its dense layer and 3 MoE layers), and the sharded
    form on a 1 x 4 grid of the card (``smoke=True``: the reduced configs
    at small sizes, a CPU rehearsal)."""
    import dataclasses
    from repro_torch.configs import get_config, get_smoke_config
    get = get_smoke_config if smoke else get_config
    deep, gran = get("deepseek-moe-16b"), get("granite-moe-3b-a800m")
    prompt, n_docs, seq, T = (64, 256, 512, 256) if smoke else \
        (2048, 8192, 4096, 8192)
    out = {"serve": deepseek_serve(deep, prompt=prompt, dev=dev)}
    out["rag"] = rag_phase(gran, n_docs=n_docs, dev=dev, decode=False)
    out["train"] = {
        "granite": lm_train(gran, seq=seq, dev=dev),
        "deepseek": lm_train(dataclasses.replace(deep, num_layers=4),
                             steps=3, seq=seq, dev=dev)}
    out["sharded"] = sharded_moe_check([gran, deep], T=T, dev=dev)
    return out


# ---------------------------------------------------------------------------
# phase 11: NequIP
# ---------------------------------------------------------------------------

def molecule_batch(cfg, n_mol=128, atoms=30, edges=64, seed=0):
    """``n_mol`` molecules of ``atoms`` atoms, each with ``edges`` directed
    edges between two distinct atoms of the molecule, batched by
    ``batch_molecules``; the pair-potential energy as the target."""
    import numpy as np
    from repro_torch.data.synthetic import _pair_potential
    from repro_torch.models.gnn_common import batch_molecules

    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(n_mol, atoms, 3)) * 1.5).astype(np.float32)
    spec = rng.integers(0, cfg.n_species, size=(n_mol, atoms)).astype(
        np.int32)
    a = rng.integers(0, atoms, size=(n_mol, edges))
    b = (a + rng.integers(1, atoms, size=(n_mol, edges))) % atoms
    p, s, src, dst, gid = batch_molecules(pos, spec, np.stack([a, b], -1),
                                          n_mol)
    return {"positions": p, "species": s, "src": src.astype(np.int32),
            "dst": dst.astype(np.int32),
            "edge_mask": np.ones(len(src), np.float32),
            "node_mask": np.ones(len(p), np.float32),
            "graph_id": gid.astype(np.int32), "n_graphs": n_mol,
            "energy_target": _pair_potential(p, src, dst, gid, n_mol)}


def _to(batch, dev):
    import torch
    return {k: (torch.as_tensor(v, device=dev) if k != "n_graphs" else v)
            for k, v in batch.items()}


def gnn_train(cfg, batch, steps, dev, seed=0, hold=None):
    """``steps`` AdamW steps of ``make_train_step(nequip.loss_fn)`` on one
    batch: every loss finite, every leaf changed and finite; ms a step.
    ``hold``: the name under which phase 12 holds the step (the cell's
    step, ``n_graphs`` static) to the card."""
    import math
    import numpy as np
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import get_api, make_train_step, nequip
    from repro_torch.train import adamw_init

    api = get_api(cfg)
    params = api.init_params(seed=seed, device=dev)
    state = adamw_init(params)
    step_fn = make_train_step(lambda p, b: nequip.loss_fn(cfg, p, b),
                              api.opt_cfg)
    p0 = _host_tree(params)                # the step updates in place
    p1, state, out = _run_steps(step_fn, params, state,
                                [lambda: batch] * steps, dev)
    check(all(math.isfinite(x) for x in out["loss"] + out["grad_norm"]),
          f"{cfg.name}: a loss or grad norm is not finite: {out}")
    _check_trained(p0, p1, cfg.name)
    warm = out["s"][1:] or out["s"]
    out["ms_per_step"] = 1e3 * float(np.mean(warm))
    if hold:
        cell = api.make_step(ShapeSpec("molecule", "graph",
                                       graph_batch=batch["n_graphs"]))
        hold_cell(hold, cell.fn, [p1, state, {
            k: v for k, v in batch.items() if k != "n_graphs"}],
            out["ms_per_step"] / 1e3, dev)
    return out


def invariance_check(cfg, params, batch, dev):
    """The reference's invariance tests (``tests/test_nequip.py``) on the
    card at their tolerances: energies under 3 rotations and a translation
    (2e-3 / 1e-3), a permutation of the atoms (1e-4), and forces that
    rotate with the system (5e-3 / 1e-3)."""
    import numpy as np
    import torch
    from repro_torch.models import e3, nequip

    def rot(seed):
        return torch.from_numpy(e3.random_rotation(
            np.random.default_rng(seed))).float().to(dev)

    def close(a, b, rtol, atol):
        return float((a - b).abs().max()), bool(torch.allclose(
            a, b, rtol=rtol, atol=atol))
    res = {}
    with torch.no_grad():
        e0 = nequip.forward(cfg, params, batch)
        res["rotation"] = max(
            (close(e0, nequip.forward(cfg, params, {
                **batch, "positions": batch["positions"] @ rot(s).T}),
                   2e-3, 1e-3) for s in range(3)), key=lambda r: r[0])
        res["translation"] = close(e0, nequip.forward(cfg, params, {
            **batch, "positions": batch["positions"] + torch.tensor(
                [5., -3., 1.], device=dev)}), 2e-3, 1e-3)
        n = batch["positions"].shape[0]
        perm = torch.from_numpy(np.random.default_rng(1).permutation(n)).to(
            dev)
        inv = torch.argsort(perm)
        b2 = dict(batch)
        for k in ("positions", "species", "node_mask", "graph_id"):
            b2[k] = batch[k][perm]
        b2["src"], b2["dst"] = inv[batch["src"].long()], inv[
            batch["dst"].long()]
        res["permutation"] = close(e0, nequip.forward(cfg, params, b2), 1e-4,
                                   1e-4)
    _, f0 = nequip.energy_and_forces(cfg, params, batch)
    R = rot(5)
    _, f1 = nequip.energy_and_forces(
        cfg, params, {**batch, "positions": batch["positions"] @ R.T})
    res["forces"] = close(f0 @ R.T, f1, 5e-3, 1e-3)
    for k, (err, ok) in res.items():
        check(ok, f"{cfg.name}: {k} invariance off by {err:.4g}")
    return {k: err for k, (err, _) in res.items()}


def minibatch_lg(cfg, n_nodes=232_965, n_edges=114_615_892, seeds=1024,
                 fanout=(15, 10), seed=0, dev="cuda"):
    """``minibatch_lg``: a synthetic graph of the published node and edge
    counts (uniform random edges; the Reddit graph is not in the repo),
    built and sorted into CSR on the card; ``seeds`` seeds sampled with the
    published fanout; every sampled edge a graph edge or a degree-0 node's
    self-loop (against the sorted edge keys); one training step on the
    subgraph over the global node arrays."""
    import numpy as np
    import torch
    from repro_torch.data.synthetic import _pair_potential
    from repro_torch.models.gnn_common import sample_subgraph, to_csr

    _free(dev)
    out = {"n_nodes": n_nodes, "n_edges": n_edges, "seeds": seeds,
           "fanout": list(fanout)}
    gen = torch.Generator(device=dev).manual_seed(seed)
    src = torch.randint(0, n_nodes, (n_edges,), generator=gen, device=dev,
                        dtype=torch.int32)
    dst = torch.randint(0, n_nodes, (n_edges,), generator=gen, device=dev,
                        dtype=torch.int32)
    _sync(dev)
    t0 = time.perf_counter()
    indptr, indices = to_csr(n_nodes, src, dst)
    _sync(dev)
    out["csr_s"] = time.perf_counter() - t0
    check(int(indptr[-1]) == n_edges, "CSR row pointer")
    roots = torch.randperm(n_nodes, generator=gen, device=dev)[:seeds]
    t0 = time.perf_counter()
    s, d = sample_subgraph(gen, indptr, indices, roots.int(), fanout)
    _sync(dev)
    out["sample_s"] = time.perf_counter() - t0
    n_sub = seeds * fanout[0] * (1 + fanout[1])
    check(s.shape == (n_sub,) == d.shape, f"subgraph of {s.shape} edges")
    keys = torch.sort(dst.long() * n_nodes + src.long()).values
    del src, dst
    q = d.long() * n_nodes + s.long()
    hit = keys[torch.searchsorted(keys, q).clamp(max=n_edges - 1)] == q
    deg0 = (indptr[d.long() + 1] == indptr[d.long()]) & (s == d)
    check(bool((hit | deg0).all()), "a sampled edge is not a graph edge")
    out["self_loops"] = int(deg0.sum())
    del keys, q, indices
    _free(dev)

    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(n_nodes, 3)) * 2.0).astype(np.float32)
    sn, dn = s.cpu().numpy(), d.cpu().numpy()
    gid = np.zeros(n_nodes, np.int32)
    batch = _to({"positions": pos,
                 "species": rng.integers(0, cfg.n_species, n_nodes).astype(
                     np.int32),
                 "src": sn, "dst": dn,
                 "edge_mask": np.ones(n_sub, np.float32),
                 "node_mask": np.ones(n_nodes, np.float32),
                 "graph_id": gid, "n_graphs": 1,
                 "energy_target": _pair_potential(pos, sn, dn, gid, 1)}, dev)
    tr = gnn_train(cfg, batch, 1, dev)
    out["step_s"] = tr["s"][0]
    out["loss"] = tr["loss"][0]
    out["peak_bytes"] = _peak_bytes(dev)
    log(f"minibatch_lg ({n_nodes:,} nodes, {n_edges:,} edges on the card): "
        f"CSR {out['csr_s']:.3f} s; {seeds} seeds x fanout {fanout} -> "
        f"{n_sub:,} sampled edges ({out['self_loops']} self-loops of "
        f"degree-0 nodes) in {out['sample_s']:.4f} s, every one a graph "
        f"edge; one step {out['step_s']:.3f} s (loss {out['loss']:.4g}); "
        f"peak {out['peak_bytes']} bytes")
    return out


def gnn_phase(smoke=False, dev="cuda"):
    """Phase 11: NequIP at its published config (5 layers, 32 channels,
    l_max 2, 8 radial functions, cutoff 5): the molecule cell (128
    molecules of 30 atoms, 64 intra-molecule edges each) with energies,
    forces, the invariances and 5 AdamW steps; full_graph_sm (2,708 nodes,
    10,556 edges, 1,433 synthetic features) 5 steps; minibatch_lg
    (``minibatch_lg``). ``smoke=True``: the reduced config with 3 layers
    at small sizes, a CPU rehearsal (at its 2 layers the paths into l > 0
    get no gradient: the first layer has no l > 0 input, and the last
    layer's l > 0 output reaches no energy, so a leaf stays put)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.data import gnn_batch
    from repro_torch.models import nequip

    cfg = (dataclasses.replace(get_smoke_config("nequip"), n_layers=3)
           if smoke else get_config("nequip"))
    mols, lg = ((16, (2000, 40_000, 64)) if smoke
                else (128, (232_965, 114_615_892, 1024)))
    out = {}
    _free(dev)
    mb = _to(molecule_batch(cfg, n_mol=mols), dev)
    params = nequip.init_params(cfg, seed=0, device=dev)
    nequip.energy_and_forces(cfg, params, mb)     # the CG tensors, cached
    _sync(dev)
    t0 = time.perf_counter()
    E, Fo = nequip.energy_and_forces(cfg, params, mb)
    _sync(dev)
    out["energy_forces_ms"] = 1e3 * (time.perf_counter() - t0)
    check(bool(torch.isfinite(Fo).all()) and bool(torch.isfinite(E)),
          "molecule energies and forces")
    out["invariance_err"] = invariance_check(cfg, params, mb, dev)
    out["molecule"] = gnn_train(cfg, mb, 5, dev, hold="nequip molecule")
    out["molecule_nodes_edges"] = (len(mb["positions"]), len(mb["src"]))
    log(f"NequIP molecule ({mols} molecules, {out['molecule_nodes_edges']} "
        f"atoms and edges): energy + forces {out['energy_forces_ms']:.1f} "
        f"ms; invariance errors " + ", ".join(
            f"{k} {v:.3g}" for k, v in out["invariance_err"].items())
        + f"; 5 steps {out['molecule']['ms_per_step']:.2f} ms a step, "
        f"losses " + ", ".join(f"{x:.4g}" for x in out["molecule"]["loss"]))

    fcfg = dataclasses.replace(cfg, d_feat=1433)
    gb = gnn_batch(fcfg, 2708, 10556, seed=0, n_graphs=1, d_feat=1433)
    out["full_graph_sm"] = gnn_train(fcfg, _to(gb, dev), 5, dev)
    log(f"NequIP full_graph_sm (2,708 nodes, 10,556 edges, d_feat 1,433, "
        f"synthetic features): 5 steps "
        f"{out['full_graph_sm']['ms_per_step']:.2f} ms a step, losses "
        + ", ".join(f"{x:.4g}" for x in out["full_graph_sm"]["loss"]))
    n, e, s = lg
    out["minibatch_lg"] = minibatch_lg(cfg, n, e, s, dev=dev)
    return out


# ---------------------------------------------------------------------------
# phase 12: the dry run
# ---------------------------------------------------------------------------

HELD = {}          # phase 12(b): the held cells' records, by name
PEAK_TOL = 0.15    # measured peak vs the dry run's estimate


def hold_cell(name, fn, call_args, step_s, dev, trace=None):
    """Phase 12(b): hold the dry run to the card on one cell. ``fn`` over
    ``call_args`` (the phase's own parameters and batch) runs once more
    under the dry run's counting mode: its FLOPs must equal the trace's
    (on ``meta`` stand-ins of the same shapes; ``trace`` if the caller
    has it), and what the step adds to the allocator's peak
    (``max_memory_allocated`` after a reset, less what was live before)
    must lie within ``PEAK_TOL`` of ``total_peak_estimate`` less the
    arguments (``step_peak_ratio``; ``peak_ratio`` adds the arguments to
    both sides and is reported only). The phase's timed step
    (``step_s``, not this counted one) is reported as a share of the
    trace's roofline bound."""
    import torch
    from repro_torch.launch import dryrun

    if trace is None:
        trace = dryrun.trace_step(fn, dryrun.shapes_of(call_args))
    on_card = torch.device(dev).type == "cuda"
    _sync(dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    real = dryrun.count_step(fn, call_args)
    _sync(dev)
    est, got = trace["per_device_bytes"], real["per_device_bytes"]
    roof = dryrun.roofline_ms(trace["cost"])
    rec = {"cell": name, "counted_flops": trace["cost"]["flops"],
           "real_flops": real["cost"]["flops"],
           "flops_by_family": trace["cost"]["flops_by_family"],
           "bytes_accessed": trace["cost"]["bytes_accessed"],
           "real_bytes_accessed": real["cost"]["bytes_accessed"],
           "estimate": est, "real_tracker": got,
           "trace_s": trace["seconds"], "count_s": real["seconds"],
           "step_ms": 1e3 * step_s, "roofline": roof,
           "share_of_bound": roof["ms"] / (1e3 * step_s)}
    want = rec["counted_flops"]
    if not on_card:     # a CPU tensor takes each kernel's plain version,
        want -= sum(trace["cost"]["flops_by_family"].get(k, 0)  # uncounted
                    for k in ("topk_dist", "l2dist", "embed_bag"))
    check(rec["real_flops"] == want,
          f"{name}: a real step counts {rec['real_flops']} FLOPs, the dry "
          f"run {want}")
    msg = ""
    if on_card:
        grew = torch.cuda.max_memory_allocated() - before
        rec["measured_peak"] = got["arguments"] + grew
        rec["peak_ratio"] = rec["measured_peak"] / est["total_peak_estimate"]
        rec["step_peak_ratio"] = grew / max(
            est["total_peak_estimate"] - est["arguments"], 1)
        msg = (f"; measured peak {rec['measured_peak']} bytes = "
               f"{rec['peak_ratio']:.4f} x the estimate "
               f"{est['total_peak_estimate']} (the step's own growth "
               f"{grew} = {rec['step_peak_ratio']:.4f} x its estimate)")
        # the step's own growth against the estimate less the arguments:
        # the arguments are the tracker's count on both sides
        check(abs(rec["step_peak_ratio"] - 1) <= PEAK_TOL,
              f"{name}: the step grew the allocator's peak by {grew} "
              f"bytes, the estimate says "
              f"{est['total_peak_estimate'] - est['arguments']}")
    HELD[name] = rec
    log(f"held {name}: counted {rec['counted_flops']} FLOPs = the real "
        f"step's; bytes {rec['bytes_accessed']:.6g} (real "
        f"{rec['real_bytes_accessed']:.6g}){msg}; timed step "
        f"{rec['step_ms']:.3f} ms vs roofline {roof['ms']:.4f} ms "
        f"({roof['bound']}-bound): {rec['share_of_bound']:.4f} of the "
        f"bound; trace {rec['trace_s']:.1f} s, counted step "
        f"{rec['count_s']:.1f} s")
    return rec


def _dryrun_cell(arch, shape, search):
    """One cell of phase 12(a), in a worker process (``meta`` only)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun
    return dryrun.run_cell(arch, shape, search=search)


#: cells whose largest-batch search phase 12(a) leaves out (logged as a
#: cut): the 32k prefills, whose probes each trace 64 query blocks a layer
UNSEARCHED = {"prefill_32k"}


def dryrun_phase(workers=None):
    """Phase 12(a): every (arch x shape) cell's step traced on the fake
    card at its published shape (``repro_torch.launch.dryrun``), in
    ``workers`` processes at once (``spawn``: they touch no GPU); one line
    each, and a ``cut:`` line for the largest-batch searches left out."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor
    from repro_torch.launch import dryrun

    todo = dryrun.cells()
    workers = workers or max(1, min(8, os.cpu_count() or 1))
    search = [s not in UNSEARCHED for a, s in todo]
    cut = [f"{a} {s}" for (a, s), on in zip(todo, search) if not on]
    if cut:
        log(f"cut: phase 12 searches no largest fitting batch for "
            f"{len(cut)} cells: " + ", ".join(cut))
    recs = {}
    t0 = time.perf_counter()
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        futs = {(a, s): pool.submit(_dryrun_cell, a, s, on)
                for (a, s), on in zip(todo, search)}
        for key, fut in futs.items():
            recs[key] = fut.result()
    wall = time.perf_counter() - t0
    for key in todo:
        log(f"dryrun {dryrun.summary(recs[key])}")
    check(len(recs) == 40, f"phase 12 traced {len(recs)} cells, not 40")
    host = sum(r["seconds"] + r.get("search_seconds", 0)
               for r in recs.values())
    log(f"phase 12(a): 40 cells in {wall:.1f} s on {workers} processes "
        f"({host:.1f} s of tracing)")
    return {"cells": [recs[k] for k in todo], "wall_s": wall,
            "trace_host_s": host, "workers": workers}


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
    from repro_torch.kernels.beam_expand.beam_expand import LIBRARY as BE_LIB
    from repro_torch.kernels.count_flags.count_flags import LIBRARY as CF_LIB
    from repro_torch.kernels.embed_bag.embed_bag import LIBRARY as EB_LIB
    from repro_torch.kernels.l2dist.l2dist import LIBRARY as L2_LIB
    from repro_torch.kernels.topk_dist import topk_dist
    from repro_torch.kernels.topk_dist.topk_dist import LIBRARY as TK_LIB
    phase_s = {}
    t = time.perf_counter()
    build_all([TK_LIB, L2_LIB, EB_LIB, CF_LIB, BE_LIB])
    phase_s["1_build"] = time.perf_counter() - t
    for lib in (TK_LIB, L2_LIB, EB_LIB, CF_LIB, BE_LIB):
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
    results["count_flags"] = timed("2_count_flags", count_flags_phase)
    results["beam_expand"] = timed("2_beam_expand", beam_expand_phase)
    results["op_overhead_us"] = timed("2_op_overhead", op_overhead)

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
    log("cut: the bf16 facade phase runs phase 5's N = 65,536 x 128 (phase "
        "5's cut of SIFT1M's 2^20), with 1% churn and no maintenance")
    topk_dist.launches = Live.truth_launches = 0
    results["5b_bf16_facade"] = timed("5b_bf16_facade", bf16_facade_phase)
    launches["5b"] = topk_dist_launches()
    log(f"phase 5b launched topk_dist {launches['5b']} times in the port")
    check(launches["5b"] >= 2, "phase 5b never launched topk_dist")
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

    log("cut: phase 8's ANN catalogue holds the first 131,072 of SASRec's "
        "1,000,000 items (a wave build of the whole catalogue takes ~380 s)")
    from repro_torch.kernels.embed_bag import embed_bag
    embed_bag.launches = 0
    topk_dist.launches = Live.truth_launches = 0
    results["8_substrate"] = timed("8_substrate", substrate_phase)
    launches["8"] = topk_dist_launches()
    log(f"phase 8 launched embed_bag {embed_bag.launches} times (wide-deep's "
        f"bag) and topk_dist {launches['8']} times in the port (the exact "
        f"tier), {Live.truth_launches} more for the ground truth")
    check(embed_bag.launches > 0, "phase 8 never launched embed_bag")
    check(launches["8"] > 0, "phase 8 never launched topk_dist")
    eb_launches = {"8": embed_bag.launches}

    log("cut: phase 9 trains stablelm-1.6b at global batch 2 instead of "
        "train_4k's 256 (one card holds the 1.64 B parameters, bf16 grads "
        "and f32 moments, ~20 GB, plus one microbatch of 2 x 4,096)")
    log("cut: phase 9's trainer CLI runs stablelm-1.6b's smoke config (a "
        "full-width checkpoint with moments and error buffers is ~26 GB of "
        "npz)")
    embed_bag.launches = 0
    topk_dist.launches = Live.truth_launches = 0
    results["9_train"] = timed("9_train", train_phase)
    eb_launches["9"] = embed_bag.launches
    launches["9"] = topk_dist_launches()
    log(f"phase 9 launched embed_bag {eb_launches['9']} times (wide-deep's "
        f"bag, one forward a training step; its backward is the plain "
        f"scatter-add) and topk_dist {launches['9']} times")
    check(eb_launches["9"] == 5, "phase 9 did not launch embed_bag once a "
                                 "wide-deep step")
    log("cut: phase 10 decodes deepseek-moe-16b against forward with "
        "capacity_factor raised to E / K x 1.001 (no expert can overflow: "
        "decode routes each step's 4 tokens as one block, the forward all "
        "8,256); at the published 1.25 the gap is reported, not gated")
    log("cut: phase 10's RAG embeds 8,192 documents with granite-moe-3b-"
        "a800m, not phase 8's 16,384 (the smoke's time limit)")
    log("cut: phase 10 trains granite-moe-3b-a800m at global batch 2 x "
        "4,096 (as phase 9), and deepseek-moe-16b cut to its dense layer + "
        "3 MoE layers (~2.3 B parameters; at 28 layers its bf16 weights and "
        "gradients and f32 moments need ~196 GB)")
    topk_dist.launches = Live.truth_launches = 0
    results["10_moe"] = timed("10_moe", moe_phase)
    launches["10"] = topk_dist_launches()
    log(f"phase 10 launched topk_dist {launches['10']} times in the port "
        f"(the RAG index's exact tier), {Live.truth_launches} more for the "
        f"ground truth")
    check(launches["10"] > 0, "phase 10 never launched topk_dist")

    log("cut: phase 11 does not run ogb_products (61.9 M edges: one path's "
        "[E, 32, 5] f32 messages are ~40 GB; the reference shards it over "
        "a pod); minibatch_lg's graph is uniform random at Reddit's node "
        "and edge counts, full_graph_sm's features synthetic (no Cora file "
        "in the repo)")
    topk_dist.launches = Live.truth_launches = 0
    results["11_gnn"] = timed("11_gnn", gnn_phase)
    launches["11"] = topk_dist_launches()

    results["12_dryrun"] = timed("12_dryrun", dryrun_phase)
    results["12_dryrun"]["held"] = HELD
    check(len(HELD) == 4, f"phase 12 held {len(HELD)} cells, not 4: "
                          f"{sorted(HELD)}")
    eb_report["launches"] = sum(eb_launches.values())
    results["embed_bag_launches_by_phase"] = eb_launches
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
