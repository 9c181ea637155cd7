"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run it from the root of a checkout: ``BENCHMARK.json`` there names the
cell's configuration, traffic mix and metrics (see ``bench/harness.py``).
The last line of standard output is the result as one JSON object; the
numbers that decide ``correct`` are the last lines of standard error.
"""
import time

T_START = time.perf_counter()       # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from bench.harness import main
    sys.exit(main(sys.argv[1:], t_start=T_START))
