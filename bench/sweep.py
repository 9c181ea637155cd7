"""Windows of one cell in one process, after one set-up: the knee sweep of
an open-loop cell, or a cell's readings at several window lengths.

    python3 bench/sweep.py --workload sift128-churn --seed 7 \\
        --rates 2000,4000,6000,8000,10000 --seconds 15 --out knee.json
    python3 bench/sweep.py --workload glove100-search --seed 7 \\
        --windows 10,40,40

Run it from the root of a checkout on a machine with a card. With
``--rates`` (open loops) each rate runs for ``--seconds`` on fresh
arrivals, on the index as the previous rate left it; with ``--windows``
the cell's own mix runs window after window of the lengths given. Each
window prints one JSON line: every metric of the cell that its reader can
take from the window alone (the reference is not run), and for an open
loop the queries each pump found waiting (its backlog: the means over the
window's first and second half and the slope of a least-squares line, in
queries per second per second), the pumps' mean milliseconds in each half
and the generator's lag. The knee is the highest rate whose backlog does
not grow; an open-loop cell runs at four fifths of it.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time


def _backlog(w: dict, spans) -> dict:
    import numpy as np
    t = np.array([b[0] for b in w["backlog"]])
    q = np.array([b[1] for b in w["backlog"]], float)
    ps = [s.seconds * 1e3 for s in spans.named("pump", w["t0"], w["t1"])]
    h, hq = len(ps) // 2, len(q) // 2
    return {"pumps": w["pumps"],
            "backlog_slope_per_s": (float(np.polyfit(t, q, 1)[0])
                                    if len(t) > 2 else math.nan),
            "backlog_first_half": float(q[:hq].mean()) if hq else None,
            "backlog_second_half": float(q[hq:].mean()),
            "pump_ms_first_half": float(np.mean(ps[:h])) if h else None,
            "pump_ms_second_half": float(np.mean(ps[h:])),
            "submit_lag_ms_max": float(w["submit_lag_ms"].max())
            if len(w["submit_lag_ms"]) else 0.0}


def main(argv=None) -> int:
    t_start = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from bench import harness, tracing
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--rates", help="query rates, comma-separated")
    what.add_argument("--windows", help="window seconds, comma-separated")
    ap.add_argument("--seconds", type=float, default=15.0,
                    help="each rate's window")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    root = harness.checkout()
    import torch
    cell = harness.Cell.load(root, args.workload)
    if args.rates and cell.traffic["loop"] != "open":
        raise SystemExit(f"{args.workload} is not an open-loop cell")
    from repro_torch.kernels.topk_dist import topk_dist
    torch.backends.cuda.matmul.allow_tf32 = False
    spans = tracing.Spans()
    loop = cell.make_loop(args.seed, torch.device(harness.DEVICE), spans)
    loop.setup()
    out = {"workload": args.workload, "seed": args.seed,
           "setup_s": time.perf_counter() - t_start,
           "device": torch.cuda.get_device_name(0), "windows": []}
    readers = {m["name"]: harness.load_reader(root, m["name"])
               for m in cell.metrics(False) + cell.metrics(True)}
    steps = ([("rate", float(r), args.seconds)
              for r in args.rates.split(",")] if args.rates else
             [("window", None, float(s)) for s in args.windows.split(",")])
    for kind, rate, seconds in steps:
        if rate is not None:
            loop.restart(rate)
        n0 = topk_dist.launches
        w = loop.window(seconds)
        obs = harness.Obs(out["setup_s"], w, spans, None,
                          {"topk_dist_launches": topk_dist.launches - n0})
        row = {"rate": rate, "window_s": w["window_s"],
               "queries": w["queries"]}
        for n, r in readers.items():
            v = None if getattr(r, "PROGRAM", False) else r.read(obs)
            if v is not None and n != "setup_s":
                row[n] = v
        if "backlog" in w:
            row.update(_backlog(w, spans))
        out["windows"].append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
