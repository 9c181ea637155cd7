#!/usr/bin/env python3
"""Time three forms of the ``embed_bag`` table gradient on one GPU.

    python3 tools/embed_bag_backward.py [--out results.json]

The gradient scatter-adds each bag's output gradient into the rows its
ids name, in f32 (``kernels/embed_bag/ref.py::embed_bag_backward_ref``).
The forms differ only in what the pads (``-1`` ids) do:

* ``masked``: a boolean mask gathers the valid ids first (the number of
  adds depends on the data, so a dry run cannot trace it);
* ``row0``: every shape static, each pad adds an exact zero to row 0;
* ``spread``: every shape static, each pad adds an exact zero to a row of
  its own (``arange % V``): the form the port ships.

All run at wide-deep's ``train_batch`` (65,536 bags of 32 ids over a
1,000,000 x 32 f32 table, 30% pads, ``recsys_batch`` seed 0, an N(0, 1)
output gradient), are held to one another (1e-5), and are timed with CUDA
events over 20 calls, in four rounds of alternating order. Prints one line
per form and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def masked(g, ids, V):
    B, L = ids.shape
    valid = (ids >= 0) & (ids < V)
    rows = ids.long()[valid]
    src = g[:, None, :].expand(B, L, g.shape[1])[valid]
    grad = g.new_zeros((V, g.shape[1]))
    return grad.index_add_(0, rows, src)


def static(g, ids, V, spread: bool):
    import torch
    B, L = ids.shape
    valid = ((ids >= 0) & (ids < V)).reshape(B * L)
    pad = (torch.arange(B * L, device=g.device) % V) if spread else 0
    rows = torch.where(valid, ids.long().reshape(B * L), pad)
    src = torch.where(valid[:, None], g[:, None, :].expand(
        B, L, g.shape[1]).reshape(B * L, g.shape[1]), 0.0)
    grad = g.new_zeros((V, g.shape[1]))
    return grad.index_add_(0, rows, src)


def events_ms(fn, reps=20):
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import recsys_batch
    from repro_torch.kernels.embed_bag import embed_bag_backward_ref

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    cfg = get_config("wide_deep")
    B = 65_536
    ids = torch.as_tensor(recsys_batch(cfg, B, seed=0)["bag_ids"]).cuda()
    V, D = cfg.vocab_size, cfg.embed_dim
    g = torch.randn((B, D), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    forms = {"masked": lambda: masked(g, ids, V),
             "row0": lambda: static(g, ids, V, spread=False),
             "spread": lambda: static(g, ids, V, spread=True),
             "shipped": lambda: embed_bag_backward_ref(
                 g, ids, V, torch.float32, "sum")}
    want = forms["masked"]()
    err = {k: float((f() - want).abs().max()) for k, f in forms.items()}
    if max(err.values()) > 1e-5:
        raise SystemExit(f"the forms disagree: {err}")
    times = {k: [] for k in forms}
    order = list(forms)
    for r in range(4):
        for k in (order if r % 2 == 0 else order[::-1]):
            times[k].append(events_ms(forms[k]))
    res = {"card": card, "torch": torch.__version__, "B": B, "L": ids.shape[1],
           "V": V, "D": D, "pads": int((ids < 0).sum()),
           "ids": ids.numel(), "max_abs_err_vs_masked": err, "ms": times}
    print(card)
    for k, t in times.items():
        print(f"{k:8s} best {min(t):.4f} ms, median "
              f"{sorted(t)[len(t) // 2]:.4f} ms, rounds "
              + ", ".join(f"{x:.4f}" for x in t))
    print(f"{res['pads']} of {res['ids']} ids are pads")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
