"""Runs one cell of the benchmark once and prints its result as the last
line of standard output.

    python3 stwo_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

NAME is a workload of BENCHMARK.json.  --trace 0 measures the cell's
end-to-end metrics; --trace 1 traces a window and reports its per-layer
metrics.  Either way the outputs of the window are compared with the plain
reference (stwo_bench/reference/), and each number compared is printed
beside its limit as the last lines of standard error.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from stwo_bench.harness import cell  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


if __name__ == "__main__":
    sys.exit(cell.main(parse_args(), STARTED))
