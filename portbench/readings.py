#!/usr/bin/env python3
"""Read the numbers that decide a cell's ``correct`` over many seeds in one
process, for its limits (``portbench/limits/<cell>.json``):

    python3 portbench/readings.py --workload <cell> --seeds 1 2 3 \\
        --control-seeds 4 5 6 --seconds 5

Each seed is one run of the cell (set-up, a window of ``--seconds``, the
check), the program's for ``--seeds`` and the control's, the reference
computed in bfloat16 in the program's place, for ``--control-seeds``.
``--faults unchanged half_batch --fault-seeds 7 8 9`` reads the program
with each named fault of the cell's loop planted underneath it, and
``--override '{"check": {"reference_steps": 300}}'`` changes the traffic
(its ``check`` merged key by key). It prints one JSON line a run: the
variant, the seed, the calls judged and each number compared. The
benchmark's own runs never run the control or a fault.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from portbench.harness.main import run_cell  # noqa: E402
from portbench.harness.spec import ROOT, load_cell  # noqa: E402


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--override", type=json.loads, default={})
    a = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("readings: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(2)
    cell = load_cell(a.workload, ROOT)
    over = {k: dict(cell.traffic[k], **v) if isinstance(v, dict) else v
            for k, v in a.override.items()}
    runs = ([("port", s) for s in a.seeds]
            + [("control", s) for s in a.control_seeds]
            + [(f, s) for f in a.faults for s in a.fault_seeds])
    for variant, seed in runs:
        result = run_cell(cell, seed, a.seconds, False, "cuda:0",
                          time.perf_counter(), variant, over)
        print(json.dumps({"workload": a.workload, "variant": variant,
                          "seed": seed, "attempted": result["attempted"],
                          "correct": result["correct"],
                          "readings": {k: c["value"]
                                       for k, c in result["checks"].items()}}),
              flush=True)


if __name__ == "__main__":
    main()
