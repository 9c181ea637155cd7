"""Where a training step's time goes on the card: smoke phase 9's two
cells (stablelm-1.6b at 2 x 4,096 with remat, wide-deep at 65,536 rows)
and phase 10's two (granite-moe-3b-a800m at full depth and deepseek-moe-16b
cut to 4 layers, 2 x 4,096 with remat), two warm-up
steps each, then one step under ``torch.profiler`` and one timed by parts
(loss + backward, the AdamW update) with CUDA syncs.

    python tools/train_profile.py [--cells stablelm,wide-deep,granite,deepseek]
        [--top 20] [--out train_profile.json]

Prints the card's name and power limit, each cell's step time, the
device's busy time and idle share over the profiled step, and the kernels
that took the most device time. Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _sync():
    import torch
    torch.cuda.synchronize()


def _profile(step, top):
    """One call of ``step`` under the profiler: wall seconds, device busy
    seconds (the union of kernel intervals), and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    _sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        _sync()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)[:top]
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"wall_s": wall, "device_busy_s": busy / 1e6,
            "idle_share": 1 - busy / 1e6 / wall,
            "kernel_s": total / 1e6,
            "top": [{"name": e.key[:90], "calls": e.count,
                     "s": e.self_device_time_total / 1e6} for e in rows]}


def _parts(loss_fn, params, state, batch, opt_cfg):
    """One step split at the update: loss + grads, then AdamW (seconds)."""
    from repro_torch.models import value_and_grad
    from repro_torch.train import adamw_update
    _sync()
    t0 = time.perf_counter()
    _, grads = value_and_grad(loss_fn, params, batch)
    _sync()
    t1 = time.perf_counter()
    adamw_update(opt_cfg, grads, state, params)
    _sync()
    return {"loss_and_grads_s": t1 - t0,
            "adamw_s": time.perf_counter() - t1}


def cell(name, cfg, loss_fn, batch, top):
    import torch
    from repro_torch.models import get_api, make_train_step
    from repro_torch.train import adamw_init
    api = get_api(cfg)
    params = api.init_params(seed=0, device="cuda")
    state = adamw_init(params)
    step = make_train_step(loss_fn, api.opt_cfg)
    for _ in range(2):
        params, state, _ = step(params, state, batch)
    _sync()
    t0 = time.perf_counter()
    step(params, state, batch)
    _sync()
    out = {"cell": name, "step_s": time.perf_counter() - t0}
    out.update(_parts(loss_fn, params, state, batch, api.opt_cfg))
    out["profile"] = _profile(lambda: step(params, state, batch), top)
    del params, state
    torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="stablelm,wide-deep,granite,deepseek")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("train_profile: needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.data import lm_token_batch, recsys_batch
    from repro_torch.models import recsys, transformer
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    wd = get_config("wide_deep")

    def lm_cell(name, cfg):
        return cell(f"{name} 2x4096 remat", cfg,
                    lambda p, b: transformer.lm_loss(cfg, p, b["tokens"]),
                    {"tokens": torch.from_numpy(lm_token_batch(
                        cfg.vocab_size, 2, 4096, seed=0)).cuda()}, args.top)
    makers = {
        "stablelm": lambda: lm_cell("stablelm-1.6b",
                                    get_config("stablelm-1.6b")),
        "wide-deep": lambda: cell(
            "wide-deep 65536", wd, partial(recsys.loss_fn, wd),
            recsys.batch_to(recsys_batch(wd, 65_536, seed=0), "cuda"),
            args.top),
        "granite": lambda: lm_cell("granite-moe-3b-a800m",
                                   get_config("granite-moe-3b-a800m")),
        "deepseek": lambda: lm_cell(
            "deepseek-moe-16b 4 layers", dataclasses.replace(
                get_config("deepseek-moe-16b"), num_layers=4))}
    cells = [makers[c]() for c in args.cells.split(",")]
    for c in cells:
        p = c["profile"]
        print(f"{c['cell']}: step {c['step_s']:.4f} s (loss + grads "
              f"{c['loss_and_grads_s']:.4f} s, AdamW {c['adamw_s']:.4f} s); "
              f"profiled step {p['wall_s']:.4f} s, device busy "
              f"{p['device_busy_s']:.4f} s (idle {p['idle_share']:.3f}), "
              f"kernels {p['kernel_s']:.4f} s")
        for r in p["top"]:
            print(f"  {r['s']:9.4f} s {r['calls']:6d}x  {r['name']}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "cells": cells},
                                             indent=1))


if __name__ == "__main__":
    main()
