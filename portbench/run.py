"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Exits with 2 and prints no result without a
CUDA card, where JAX or the JAX package is loaded, or where a file of the
benchmark or the measured package is missing.
"""

import time

T_START = time.perf_counter()  # the process's start, for setup_s

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:], T_START))
