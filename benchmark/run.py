#!/usr/bin/env python3
"""Run one cell of the benchmark of distributedconvrl_pde_control_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with the CUDA devices the cell asks
for (`BENCHMARK.json`). Prints the check's numbers beside their limits as
the last lines of standard error, and one JSON result line last on standard
output. Exits non-zero without a CUDA device.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
