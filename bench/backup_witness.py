"""Witness: the churn mix with the backup index on serves deleted labels.

    python3 bench/backup_witness.py --seed 7 --seconds 20 [--traffic churn_backup]

Run it from the root of a checkout on a machine with a card. It runs the
``sift128-churn`` cell once under another mix, by default
``bench/traffic/churn_backup.json`` (``tau`` 4,096 and a backup of 8,192),
held to the cell's limits, and prints the result line. Between two backup
rebuilds the backup still holds points whose labels were deleted since,
and ``batch_dual_search`` merges its hits without asking the main index,
so ``ineligible`` (labels served that were not live at the answer's epoch)
reads above 0. With the backup off (``--traffic churn``, the cell's own
mix) it reads 0.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    t_start = time.perf_counter()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from bench import harness
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--traffic", default="churn_backup")
    args = ap.parse_args(argv)
    root = harness.checkout()
    cell = harness.Cell.load(root, "sift128-churn", traffic=args.traffic)
    line = harness.run_cell(root, cell, args.seed, args.seconds, False,
                            harness.DEVICE, t_start,
                            log=lambda m: print(m, file=sys.stderr))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
