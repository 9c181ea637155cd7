#!/usr/bin/env python3
"""What the ``embed_bag`` wrapper costs a serving call, for one source tree.

    python3 tools/embed_bag_serving_cost.py [ROOT]

``ROOT`` is a checkout of this repo (default: the one holding this script);
its ``src/`` and ``chip_smoke.py`` are imported, and its kernel is built
under ``ROOT/build/kernels/``. On one GPU, with no table requiring grad
(the serving case) and under ``torch.inference_mode``, it measures:

* ``serve_bulk_device_ms``: the wrapper at 262,144 bags of 32 ids over a
  1,000,000 x 32 f32 table (ids uniform in [-1, V), seed 0), device time
  from ``torch.profiler`` (``chip_smoke.cuda_ms``, 20 calls);
* ``wrapper_us_512``: host microseconds a call at 512 bags, over 2,000
  calls after 100 warm-ups, one sync at the end;
* ``wide_deep_forward_ms_512``: host milliseconds of ``recsys.forward`` at
  wide-deep's published config and 512 rows (``recsys_batch`` seed 1),
  over 200 calls after 5 warm-ups.

To compare two trees, run each in its own process within one machine, in
the order parent, change, change, parent. Prints the card's name and power
limit, then one JSON line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = Path(argv[0] if argv else Path(__file__).resolve().parents[1])
    root = root.resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import torch
    if not torch.cuda.is_available():
        print("embed_bag_serving_cost: no CUDA GPU available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.data import recsys_batch
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.embed_bag import embed_bag
    from repro_torch.kernels.embed_bag.embed_bag import LIBRARY
    from repro_torch.models import recsys

    build_all([LIBRARY])
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn((1_000_000, 32), generator=gen, device=dev)
    bulk = torch.randint(-1, 1_000_000, (262_144, 32), generator=gen,
                         device=dev, dtype=torch.int32)
    small = bulk[:512].contiguous()
    res = {"tree": str(root)}
    with torch.inference_mode():
        res["serve_bulk_device_ms"] = chip_smoke.cuda_ms(
            lambda: embed_bag(table, bulk, "sum"), 20)
        for _ in range(100):
            embed_bag(table, small, "sum")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            embed_bag(table, small, "sum")
        torch.cuda.synchronize()
        res["wrapper_us_512"] = (time.perf_counter() - t0) / 2000 * 1e6
    cfg = get_config("wide_deep")
    params = recsys.init_params(cfg, seed=0, device=dev)
    batch = recsys.batch_to(recsys_batch(cfg, 512, seed=1), dev)
    with torch.inference_mode():
        for _ in range(5):
            recsys.forward(cfg, params, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            recsys.forward(cfg, params, batch)
        torch.cuda.synchronize()
        res["wide_deep_forward_ms_512"] = (time.perf_counter() - t0) / 200 * 1e3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
