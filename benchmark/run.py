"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the chips the cell asks
for.  The run makes its inputs from the seed, warms up every shape it
uses, measures for ``--seconds``, checks what the timed path produced
against the plain reference, and prints one JSON object as the last line
of standard output (end-to-end metrics with ``--trace 0``, per-layer ones
and the device trace's breakdown with ``--trace 1``), and each compared
number beside its limit as the last lines of standard error.  Without a
CUDA device, or with fewer than the cell asks for, it exits 2 and prints
no result; with JAX or the JAX package loaded after the window, 3.
"""

import time

T0 = time.perf_counter()  # set-up is measured from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# A fixed string-hash seed for the run's process, set by running the script
# again in its place: most of a frame's host time is Python over dicts whose
# layout the seed decides, and a seed drawn anew in each process spread the
# frame cell's rate between runs (PERF.md section 2).
if os.environ.get("PYTHONHASHSEED") != "0":
    os.environ["PYTHONHASHSEED"] = "0"
    os.environ["PORTBENCH_T0"] = repr(T0)
    os.execv(sys.executable, [sys.executable, *sys.argv])
T0 = float(os.environ.pop("PORTBENCH_T0", T0))  # the monotonic clock holds across the exec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Kernel caches at fixed paths inside the checkout, so that only a cell's
# first run there compiles (the port builds its own into tha4_tpu_torch/_build/).
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions", "TORCHINDUCTOR_CACHE_DIR": "inductor"}
# One host thread for the run's one process: the cells are host-bound, and
# idle pool threads spinning beside the loop spread its timings.
THREADS = "1"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = THREADS
    sys.path[0] = ROOT  # the checkout's root, not benchmark/
    import torch

    torch.set_num_threads(int(THREADS))
    from benchmark import harness

    chips = harness.find_cell(harness.load_spec(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: {args.workload} needs {chips} CUDA device(s); torch.cuda.is_available() = "
              f"{torch.cuda.is_available()}, device_count = {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0=T0)
    found = harness.forbidden_modules()
    if found:
        print(f"run.py: these modules were loaded in the run's process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} (limit {check['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
