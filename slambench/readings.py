"""The check's readings on the card, in one process: the program on a dozen
seeds or more and the control (TF32 products) on a few, each one timed
sequence of the seed's first realisation checked as a run checks it, at the
cell's own size.  The limits in ``slambench/limits/<cell>.json`` are set from
what it writes.

    python slambench/readings.py --workload <cell> --seeds <n> ... \\
        --control-seeds <n> ... --out <file.json>
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    args.seed, args.trace, args.tf32, args.seconds = args.seeds[0], 0, False, 0.0
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    sys.path.insert(0, str(here.parent))
    from slambench import harness

    return harness.run(args, T_START, body=harness.readings)


if __name__ == "__main__":
    sys.exit(main())
