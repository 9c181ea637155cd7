"""Run one cell of ``BENCHMARK.json`` once: set up, measure, judge, report.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file found by its name in the manifest:

  * ``bench/configs/<config>.json`` — the deployment: rows, width, metric
    space, storage type and the index's settings;
  * ``bench/traffic/<traffic>.json`` — the mix: its parameters, and the
    name of the loop that drives the window with them,
    ``bench/loops/<loop>.py`` (a class ``Loop``), and of any draws that
    loop takes from ``bench/draws/`` (see ``bench/updates.py``);
  * ``bench/limits/<cell>.json`` — the limit of each number that decides
    ``correct`` (see ``PERF.md`` for the readings each was set from);
  * ``bench/metrics/<metric>.py`` — a reader ``read(obs) -> float | None``
    of one metric; with ``PROGRAM = True`` it reads the program's state,
    before that state is freed.

A run without ``--trace`` measures one window and reports the cell's
end-to-end metrics. One with ``--trace 1`` reports its per-layer metrics:
it measures one window as an untraced run does, which the host-clock,
span and counter readers read, and then a second, profiled window of the
same length, which the trace readers read (the profiler slows the host,
so host numbers are not taken under it). Every answer of both windows is
judged.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

from .common import load_file, load_json

#: the card a run uses (every cell takes one)
DEVICE = "cuda:0"
#: top-level modules that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the numbers compared, in the order they are printed
COMPARED = ("short_rows", "dup_labels", "ineligible", "unanswered",
            "live_set_diff", "dist_gap", "recall_miss")


def cache_env(root: Path) -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths (the port builds its own kernels into ``build/kernels``)."""
    base = root / "build" / "bench"
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(base / "extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


@dataclasses.dataclass
class Cell:
    root: Path
    manifest: dict
    workload: dict
    config: dict
    traffic: dict
    limits: dict

    @classmethod
    def load(cls, root: Path, name: str, traffic: str | None = None
             ) -> "Cell":
        """The manifest's cell ``name``; with ``traffic``, the same cell
        under another mix (a mix outside the manifest, for a witness),
        held to the cell's limits."""
        root = Path(root)
        man = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in man["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json; "
                             f"cells: {sorted(cells)}")
        w = dict(cells[name])
        if traffic is not None:
            w.update(name=f"{w['config']}-{traffic}", traffic=traffic)
        b = root / "bench"
        return cls(root, man, w,
                   load_json(b / "configs" / f"{w['config']}.json"),
                   load_json(b / "traffic" / f"{w['traffic']}.json"),
                   load_json(b / "limits" / f"{name}.json"))

    def make_loop(self, seed: int, device, spans):
        """The mix's loop for this cell, not yet set up."""
        cls = load_file(self.root, "loops", self.traffic["loop"]).Loop
        return cls(self.config, self.traffic, seed, device, spans, self.root)

    def metrics(self, traced: bool) -> list[dict]:
        """The metrics this cell reports: per-layer when traced."""
        key = "per_layer" if traced else "end_to_end"
        return [m for m in self.manifest[key]
                if self.workload["name"] in m.get("workloads",
                                                  [self.workload["name"]])]


def checkout() -> Path:
    """The checkout a script runs from (its working directory), with the
    caches set inside it."""
    root = Path.cwd()
    cache_env(root)
    return root


def load_reader(root: Path, metric: str):
    return load_file(root, "metrics", metric)


@dataclasses.dataclass
class Obs:
    """What a run observed, for the metric readers: ``window`` and
    ``counters`` are the untraced window's, ``traced`` the profiled
    window's and ``trace`` its reduction (``None`` untraced)."""
    setup_s: float
    window: dict
    spans: object
    trace: dict | None
    counters: dict
    traced: dict | None = None
    readings: dict | None = None
    program: object = None          # the loop, while the program lives


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(device, chips: int, peak: int) -> dict:
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": chips, "memory_peak_bytes": int(peak)}
    return {"platform": dev.type, "kind": dev.type, "count": chips,
            "memory_peak_bytes": int(peak)}


def run_cell(root: Path, name: "str | Cell", seed: int, seconds: float,
             trace: bool, device, t_start: float | None = None,
             control: bool = False, log=print) -> dict:
    """Run one cell (a name in the manifest, or a :class:`Cell`) once;
    returns the result line's object (with the control's readings under
    ``control`` when asked for)."""
    import numpy as np
    import torch
    from . import tracing
    from .common import sync
    from .reference import exact

    t_start = time.perf_counter() if t_start is None else t_start
    cell = name if isinstance(name, Cell) else Cell.load(Path(root), name)
    name = cell.workload["name"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.empty(1, device=dev)          # the allocator now knows dev
        torch.cuda.reset_peak_memory_stats(dev)
    from repro_torch.kernels.topk_dist import topk_dist

    spans = tracing.Spans(traced=trace)
    loop = cell.make_loop(seed, dev, spans)
    loop.setup()
    setup_s = time.perf_counter() - t_start
    launches0 = topk_dist.launches
    win = loop.window(seconds)
    sync(dev)
    counters = {"topk_dist_launches": topk_dist.launches - launches0}

    twin = trace_sum = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        spans.traced = True
        with profile(activities=acts) as prof:
            with spans.span(tracing.WINDOW):
                twin = loop.window(seconds)
                sync(dev)
        spans.traced = False
        trace_sum = tracing.reduce_trace(prof)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    obs = Obs(setup_s, win, spans, trace_sum, counters, traced=twin,
              program=loop)
    metric_defs = cell.metrics(trace)
    readers = {m["name"]: load_reader(cell.root, m["name"])
               for m in metric_defs}
    values = {}
    for m in metric_defs:
        if getattr(readers[m["name"]], "PROGRAM", False):
            values[m["name"]] = readers[m["name"]].read(obs)
    prog = loop.program_readings()
    fault = None
    if control and cell.traffic.get("categories", 0) == 0:
        fault = _unchanged_search_probe(loop)
    loop.free()
    obs.program = None
    if cuda:
        torch.cuda.empty_cache()

    X, Q, groups, ans = loop.reference_inputs()
    pool = exact.Pool.make(cell.config["space"], X, Q, dev)
    G = [torch.from_numpy(g).to(dev) for g in groups]
    lim = cell.limits
    readings = exact.judge(pool, G, ans, loop.k, lim["dist_gap"])
    readings.update(prog)
    obs.readings = readings
    for m in metric_defs:
        if not getattr(readers[m["name"]], "PROGRAM", False):
            values[m["name"]] = readers[m["name"]].read(obs)

    names = [n for n in COMPARED if n in readings and n in lim]
    checks = {n: {"value": readings[n], "limit": lim[n]} for n in names}
    correct = (all(readings[n] <= lim[n] for n in names)
               and readings["rows"] > 0)
    line = {"correct": bool(correct),
            "attempted": int(readings["rows"]
                             + readings.get("unanswered", 0)),
            "failed": int(readings["failed_rows"]
                          + readings.get("unanswered", 0)),
            "metrics": {m["name"]: {"value": float(values[m["name"]]),
                                    "unit": m["unit"]}
                        for m in metric_defs
                        if values.get(m["name"]) is not None},
            "device": device_info(dev, cell.workload["chips"], peak)}
    if trace_sum is not None:
        line["device"]["busy_s"] = trace_sum["busy_s"]
        line["device"]["window_s"] = trace_sum["window_s"]
        line["breakdown"] = {"device_ops": trace_sum["device_ops"],
                             "idle_gaps": trace_sum["idle_gaps"]}
    if control:
        line["control"] = _control_readings(pool, G, ans, loop.k, lim,
                                            fault, exact)
    line["checks"] = checks
    for w in (win, twin) if twin is not None else (win,):
        log(f"[bench] {name} seed {seed}: setup {setup_s:.3f} s, "
            f"{'traced ' if w is twin else ''}window {w['window_s']:.3f} s, "
            f"{w['queries']} queries")
        if "latency_ms" in w and len(w["latency_ms"]):
            lag = w["submit_lag_ms"]
            log(f"[bench] generator lag ms: median "
                f"{float(np.median(lag)):.3f} max {float(lag.max()):.3f}; "
                f"pumps {w['pumps']}")
    log("[bench] readings " + json.dumps(readings))
    return line


def _unchanged_search_probe(loop):
    """A fault planted in the program at the cell's size: the beam search
    returns its entry state unchanged (no step runs)."""
    import repro_torch.core.search as S
    real = S.search_layer

    def unchanged(params, index, Q, ep, layer, ef, max_steps=None,
                  allow=None):
        return real(params, index, Q, ep, layer, ef, max_steps=0,
                    allow=allow)
    S.search_layer = unchanged
    try:
        return loop.probe()
    finally:
        S.search_layer = real


def _control_readings(pool, G, ans, k, lim, fault, exact) -> dict:
    """The control (the reference in TF32, in the program's place) and the
    planted fault, judged as the program is."""
    out = {"control": exact.judge(pool, G, exact.control_answers(
        pool, G, ans, k), k, lim["dist_gap"])}
    if fault is not None:
        out["unchanged_search"] = exact.judge(pool, G, fault, k,
                                              lim["dist_gap"])
    return out


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also judge the control and a planted fault "
                         "(setting limits; not part of a measured run)")
    args = ap.parse_args(argv)
    root = checkout()
    cell = Cell.load(root, args.workload)
    import torch
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[bench] {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    line = run_cell(root, args.workload, args.seed, args.seconds,
                    bool(args.trace), DEVICE, t_start,
                    control=bool(args.control), log=log)
    bad = forbidden_modules()
    if bad:
        log(f"[bench] forbidden modules loaded in this process: {bad}")
        return 3
    if "control" in line:
        log("[bench] control: " + json.dumps(line["control"]))
    for n, c in line["checks"].items():
        log(f"[bench] check {n}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0
