"""Read a cell's compared numbers over many seeds in one process: the
program's, and the control's (the plain reference one precision below the
configuration's, in the program's place), to set each limit between the
two (PERF.md gives the readings and the limits).

    python3 benchmark/readings.py --workload frame.live.f32 --seeds 1000 1001 ... \
        --seconds 3 --programs program control [--out readings.jsonl]

One JSON line per run: workload, program, fault, seed, correct, checks,
what was compared, metrics.  ``--fault`` plants one of ``faults.FAULTS``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--programs", nargs="+", default=["program", "control"])
    parser.add_argument("--fault", default=None, help="a fault of benchmark/faults.py planted under the program")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    import torch

    import contextlib

    from benchmark import faults, harness

    if not torch.cuda.is_available():
        print("readings.py: no CUDA device", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    try:
        for program in args.programs:
            for seed in args.seeds:
                with faults.FAULTS[args.fault]() if args.fault else contextlib.nullcontext():
                    r = harness.run_cell(args.workload, seed, args.seconds, False, t0=time.perf_counter(), program=program)
                line = json.dumps({"workload": args.workload, "program": program, "fault": args.fault, "seed": seed,
                                   "correct": r["correct"],
                                   "checks": r["checks"], "compared": r["compared"],
                                   "metrics": r["metrics"]})
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
