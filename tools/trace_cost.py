"""What the run's trace costs on one NVIDIA card.

    python tools/trace_cost.py [--configs vo slam vo_host] [--pairs 10] \
        [--frames 120] [--out FILE]

Runs ``runner.run_frames`` over RoomScene frames at 640x480 on an orbit
(``synthetic.orbit_trajectory(frames, speed_mm=4.0)``, Kinect depth noise) in
three configurations: ``vo`` (points and planes, no backend, the frames staged
on the card by ``runner.stage_frames``), ``slam`` (the same with ``ba_every=8``,
a window of 8, 8 iterations and the pose graph) and ``vo_host`` (``vo`` with the
frames as host arrays, so that each is uploaded from pageable memory between
two stamps).  Every sequence passes an ``on_frame`` that takes the host's
clock, as the benchmark's cells do, so ``run_frames`` clones each frame's state
and outputs out of the step graph's buffers.

* ``clock``: 64 stamps back to back, replayed from a CUDA graph: the smallest
  step of the card's clock as the stamps read it, and the greatest common
  divisor of the steps.
* the cost: in each configuration, sequences alternate in one process between
  ``trace=False`` (``off``), the default trace (``on``) and a recorder with its
  event log (``log``), in an order that rotates every round, for ``--pairs``
  rounds after one round of warm-up.  A sequence's frames/s is ``RunStats.fps``
  (its first frame, which holds the capture, left out); its steady frames/s
  leaves out the first refine and the first graph solve too, whose captures
  vary from sequence to sequence by more than the trace costs; its whole
  frames/s counts every frame, the capture's included, as the benchmark's
  ``fps`` does.  Reported: the medians of each mode, and the paired ratios
  ``on/off`` and ``log/off`` of each round, with their median and quartiles.

Without a card it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import functools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from rgbd_slam_tpu_torch import config, profiling, runner  # noqa: E402
from rgbd_slam_tpu_torch.ops import stamps_cuda  # noqa: E402
from rgbd_slam_tpu_torch.synthetic import RoomScene, orbit_trajectory  # noqa: E402

#: configuration -> (frames staged on the card, run_frames' backend arguments)
CONFIGS = {"vo": (True, {}),
           "slam": (True, {"ba_every": 8, "ba_window": 8, "ba_iterations": 8,
                           "with_pose_graph": True}),
           "vo_host": (False, {})}
MODES = ("off", "on", "log")


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def clock_steps(device, n: int = 64, reps: int = 50) -> dict:
    """The card's clock as the stamps read it: ``n`` stamps back to back,
    replayed from a CUDA graph ``reps`` times; the smallest non-zero step
    between two of them and the greatest common divisor of the steps, in ns."""
    buf = torch.zeros(n, dtype=torch.int64, device=device)
    stamps_cuda.stamp(buf, 0)
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for k in range(n):
            stamps_cuda.stamp(buf, k)
    steps = []
    for _ in range(reps):
        graph.replay()
        steps += np.diff(buf.cpu().numpy()).tolist()
    graph.reset()
    moved = [s for s in steps if s > 0]
    return {"smallest_step_ns": min(moved), "gcd_ns": functools.reduce(math.gcd, moved),
            "zero_steps": len(steps) - len(moved), "steps": len(steps),
            "median_step_ns": statistics.median(steps)}


def steady_fps(stats) -> float:
    """Frames/s past the first frame, the first refine and the first graph
    solve (``RunStats``)."""
    s = stats.total_step_s - stats.compile_s - stats.ba_compile_s - stats.graph_first_s
    return (stats.frame_count - 1) / s


def ratios(a: list, b: list) -> dict:
    """The paired ratios ``a[k] / b[k]``: each, their median and quartiles."""
    r = [x / y for x, y in zip(a, b)]
    q1, q2, q3 = statistics.quantiles(r, n=4)
    return {"median": q2, "q1": q1, "q3": q3, "below_1": sum(x < 1 for x in r), "each": r}


def cost(frames, cam, cfg, device, kw, pairs) -> dict:
    fps = {m: [] for m in MODES}
    steady = {m: [] for m in MODES}
    whole = {m: [] for m in MODES}
    for r in range(pairs + 1):
        for m in MODES[r % 3:] + MODES[:r % 3]:
            trace = {"off": False, "on": True, "log": profiling.StageTimer(log=True)}[m]
            done = []
            _, _, stats = runner.run_frames(
                frames, cam, cfg, seed=r, device=device, trace=trace,
                on_frame=lambda *_: done.append(time.perf_counter()), **kw)
            if r > 0:
                fps[m].append(stats.fps)
                steady[m].append(steady_fps(stats))
                whole[m].append(stats.frame_count / stats.total_step_s)
    return {"fps_median": {m: statistics.median(v) for m, v in fps.items()},
            "steady_fps_median": {m: statistics.median(v) for m, v in steady.items()},
            "on_over_off": ratios(fps["on"], fps["off"]),
            "log_over_off": ratios(fps["log"], fps["off"]),
            "steady_on_over_off": ratios(steady["on"], steady["off"]),
            "steady_log_over_off": ratios(steady["log"], steady["off"]),
            "whole_on_over_off": ratios(whole["on"], whole["off"]),
            "whole_log_over_off": ratios(whole["log"], whole["off"]),
            "fps": fps, "steady_fps": steady, "whole_fps": whole}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", nargs="+", default=list(CONFIGS), choices=list(CONFIGS))
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--out", default="trace_cost.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    cam, cfg = config.TUM_FR1, config.SlamConfig()
    scene = RoomScene(cam, depth_noise=config.DepthNoiseModel())
    host = [scene.render(q, p) for q, p in orbit_trajectory(args.frames, speed_mm=4.0)]
    staged = runner.stage_frames(host, device=device)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    result = {"card": card_line(), "torch": torch.__version__, "frames": args.frames,
              "clock": clock_steps(device)}
    print(json.dumps(result), flush=True)
    for name in args.configs:
        on_card, kw = CONFIGS[name]
        result[name] = cost(staged if on_card else host, cam, cfg, device, kw, args.pairs)
        print(name, json.dumps({k: v for k, v in result[name].items()
                                if k not in ("fps", "steady_fps", "whole_fps")}), flush=True)
    out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
