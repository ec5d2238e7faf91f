"""Run one cell of the port's benchmark: ``python3 portbench/run.py
--workload <name> --seed <n> --seconds <s> --trace <0|1>`` from the root
of a checkout. The last line of standard output is the result."""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT  # import portbench as a package, never its folder

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
