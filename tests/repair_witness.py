"""Definition-1 count per repair sweep, under the port's repair and under
the JAX reference's, on one maintenance state.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/repair_witness.py \
        [--n 65536] [--sweeps 10] [--out witness.json]

Builds, with the port on the CPU, the state that phase 5 of
``chip_smoke.py`` repairs: the facade at N x 128 after three rounds of 5%
deletes + replaces, with 1% more deletes left pending each round, and a
consolidation. The same arrays then go to both packages, and each runs
``repair_unreachable`` one sweep at a time (up to ``--sweeps``), counting
the paper's Definition-1 points after every sweep. The two repairs differ
only in the edge their connectivity backstop evicts. For the points the
reference leaves unreachable, the script lists the slot, its first layer-0
out-neighbour and its number of layer-0 out-edges.

Imports both packages, like the parity tests; not collected by pytest.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=65_536)
    ap.add_argument("--sweeps", type=int, default=10)
    ap.add_argument("--out", default=None, help="write the counts as JSON")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import jax.numpy as jnp
    import numpy as np

    import chip_smoke
    import repro_torch.core as T
    from repro.core import HNSWParams as JParams
    from repro.core import count_unreachable as j_count
    from repro.core.index import HNSWIndex as JIndex
    from repro.core.maintenance import repair_unreachable as j_repair
    from repro.core.reach import indegree_unreachable as j_indegree_unreach

    t0 = time.perf_counter()
    vi, _, out = chip_smoke.churned_facade(args.n, dev="cpu")
    state_s = time.perf_counter() - t0
    port, params = vi.index, vi.params
    jparams = JParams(**dataclasses.asdict(params))
    ref = JIndex(**{f: jnp.asarray(a) for f, a in T.to_arrays(port).items()})

    counts = {"port": [T.count_unreachable(port)[0]],
              "reference": [int(j_count(ref)[0])]}
    seconds = {"port": 0.0, "reference": 0.0}
    for _ in range(args.sweeps):
        if counts["port"][-1]:
            t0 = time.perf_counter()
            T.repair_unreachable(params, port)
            counts["port"].append(T.count_unreachable(port)[0])
            seconds["port"] += time.perf_counter() - t0
        if counts["reference"][-1]:
            t0 = time.perf_counter()
            ref = j_repair(jparams, ref)
            counts["reference"].append(int(j_count(ref)[0]))
            seconds["reference"] += time.perf_counter() - t0

    nb = np.asarray(ref.neighbors[0])
    stuck = np.nonzero(np.asarray(j_indegree_unreach(ref)))[0]
    result = {"N": args.n, "reclaimed": out["reclaimed"],
              "def1_per_sweep": counts, "repair_seconds": seconds,
              "state_seconds": state_s,
              "reference_stuck": [[int(s), int(nb[s, 0]),
                                   int((nb[s] >= 0).sum())] for s in stuck]}
    print(json.dumps(result))
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
