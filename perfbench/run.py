"""Run one cell of ``BENCHMARK.json`` once, on the machine it is started on:

    python perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (JSON); the numbers
compared with the plain reference are the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench.harness.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
