#!/usr/bin/env python3
"""Run one cell of the port's benchmark and print its result line:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cells are ``BENCHMARK.json``'s
``workloads``; see ``portbench/harness/main.py``.
"""

import os
import sys
import time

T0 = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
