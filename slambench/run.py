"""The benchmark of ``rgbd_slam_tpu_torch`` on one NVIDIA card: one run of one
cell of ``BENCHMARK.json``.

    python slambench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the program (``rgbd_slam_tpu_torch/``)
beside ``slambench/``.  Prints as its last line of standard output one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each number the check
compared beside its limit), and as its last lines of standard error the same
numbers.  Without a CUDA card, or without the program, it exits with 2 and
prints no result; it never falls back to the CPU.  ``--tf32`` runs the check's
control: the program with TF32 products, which the check has to call
incorrect.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0,
                    help="1: the per-layer metrics, from a traced run")
    ap.add_argument("--tf32", action="store_true",
                    help="the check's control: the program with TF32 products")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # the checkout's root, not slambench/, is where imports start
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    sys.path.insert(0, str(here.parent))
    from slambench import harness

    return harness.run(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
