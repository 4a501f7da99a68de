"""Benchmark of pangraph_tpu_torch, one run of one cell:

    python3 port_bench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds the program. Exits 2 without a
result where the cell's CUDA devices are missing, 3 where the run loaded
JAX or the JAX package. See harness.py for what a run does."""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from port_bench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
