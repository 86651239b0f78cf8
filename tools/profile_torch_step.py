"""Stage profile of the PyTorch port's SLAM step on one NVIDIA card.

    python tools/profile_torch_step.py [--tracked 128] [--no-planes] [--frames 25]

Runs RoomScene orbit frames at 640x480 (default ``SlamConfig``, depth noise on)
through ``rgbd_slam_tpu_torch.runner.run_frames`` on the card.  The frames
after a 5-frame warm-up are split in two: the first half is timed per stage
(each stage's entry function gets a device sync on both sides and a host clock),
the second half runs unstaged under ``torch.profiler`` for device time, kernel
counts, device syncs and host reads per frame.  Two more frames run under
``torch.cuda.set_sync_debug_mode`` to name the package line of every host sync.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import traceback
import warnings
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rgbd_slam_tpu_torch import config, engine, runner, synthetic  # noqa: E402
from rgbd_slam_tpu_torch.features import primitives  # noqa: E402
from rgbd_slam_tpu_torch.ops import brief, fast, image, matching, optical_flow  # noqa: E402
from rgbd_slam_tpu_torch.tracking import inverse_depth_tracking, kalman  # noqa: E402

#: stage -> the (module, function name) pairs the step calls for it
STAGES = {
    "pyramid": [(image, "build_pyramid")],
    "optical_flow": [(optical_flow, "track_forward_backward")],
    "detect": [(fast, "tracked_points_mask"), (fast, "detect_fast_grid"),
               (brief, "compute_brief")],
    "match": [(matching, "match_precompute"), (matching, "match_from_distances"),
              (matching, "resolve_match_conflicts"), (matching, "match_descriptors")],
    "plane_extract": [(primitives, "find_primitives")],
    "plane_match": [(engine, "_match_planes")],
    "pose_opt": [(engine, "compute_optimized_pose")],
    "point_update": [(kalman, "track_points"),
                     (inverse_depth_tracking, "fuse_screen_observation_3d"),
                     (inverse_depth_tracking, "fuse_screen_observation_2d")],
    "plane_update": [(engine, "_update_planes")],
    "plane_insert": [(engine, "_insert_planes")],
}


class StageTimer:
    """Wraps each stage function with a device sync on both sides and a host
    clock; only the outermost wrapped call is timed."""

    def __init__(self):
        self.ms = defaultdict(float)
        self.active = False
        self.saved = []

    def install(self):
        for stage, targets in STAGES.items():
            for module, name in targets:
                fn = getattr(module, name)
                self.saved.append((module, name, fn))
                setattr(module, name, self._wrap(stage, fn))

    def remove(self):
        for module, name, fn in self.saved:
            setattr(module, name, fn)
        self.saved = []

    def _wrap(self, stage, fn):
        def timed(*args, **kw):
            if self.active:
                return fn(*args, **kw)
            self.active = True
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                torch.cuda.synchronize()
                self.ms[stage] += 1e3 * (time.perf_counter() - t0)
                return out
            finally:
                self.active = False
        return timed


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _sync_sites(frames, cam, cfg, with_planes, state, device):
    """Host syncs per frame by the package line that caused them, from
    ``torch.cuda.set_sync_debug_mode``'s warnings over ``frames``."""
    sites = defaultdict(int)
    package = str(Path(runner.__file__).parent)

    def record(message, *_args, **_kw):
        if "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack() if f.filename.startswith(package)]
        where = ours[-1] if ours else None
        sites[f"{Path(where.filename).relative_to(package)}:{where.lineno}"
              if where else "outside the package"] += 1

    with warnings.catch_warnings():   # restores showwarning on exit
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            runner.run_frames(frames, cam, cfg, with_planes=with_planes, state=state,
                              device=device)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return {k: v / len(frames) for k, v in sorted(sites.items())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tracked", type=int, default=128, help="max_tracked_points")
    ap.add_argument("--no-planes", action="store_true", help="the points-only step")
    ap.add_argument("--frames", type=int, default=25,
                    help="frames of the timed run, warm-up included")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    cam = config.TUM_FR1
    cfg = config.SlamConfig()
    cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(
        cfg.mapping, max_tracked_points=args.tracked))
    with_planes = not args.no_planes
    scene = synthetic.RoomScene(cam, depth_noise=config.DepthNoiseModel())
    n_sync = 2   # frames run after the profile to find the sync sites
    frames = [scene.render(q, p)
              for q, p in synthetic.orbit_trajectory(args.frames + n_sync, speed_mm=4.0)]
    warm = 5
    n_staged = (args.frames - warm) // 2
    n_prof = args.frames - warm - n_staged

    state, _, _ = runner.run_frames(frames[:warm], cam, cfg, with_planes=with_planes,
                                    device=device)
    timer = StageTimer()
    timer.install()
    t0 = time.perf_counter()
    state, _, _ = runner.run_frames(frames[warm:warm + n_staged], cam, cfg,
                                    with_planes=with_planes, state=state, device=device)
    torch.cuda.synchronize()
    staged_ms = 1e3 * (time.perf_counter() - t0) / n_staged
    timer.remove()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, _, _ = runner.run_frames(frames[warm + n_staged:args.frames], cam, cfg,
                                        with_planes=with_planes, state=state, device=device)
        torch.cuda.synchronize()
        unstaged_ms = 1e3 * (time.perf_counter() - t0) / n_prof
    kernels, busy_us = 0, 0.0
    lk_us = defaultdict(list)
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            kernels += 1
            us = evt.time_range.elapsed_us()
            busy_us += us
            if evt.name.startswith("lk_"):
                lk_us[evt.name.split("(")[0]].append(us)
    counts = defaultdict(int)
    for avg in prof.key_averages():
        if avg.key in ("cudaStreamSynchronize", "aten::item", "aten::_local_scalar_dense",
                       "cudaMemcpyAsync", "cudaLaunchKernel"):
            counts[avg.key] = avg.count

    sync_sites = _sync_sites(frames[args.frames:], cam, cfg, with_planes, state, device)
    stage_ms = {k: timer.ms[k] / n_staged for k in STAGES}
    stage_ms["rest"] = staged_ms - sum(stage_ms.values())
    print(json.dumps({
        "card": _card_line(), "with_planes": with_planes, "tracked": args.tracked,
        "staged_frames": n_staged, "profiled_frames": n_prof,
        "step_ms_staged": staged_ms, "step_ms_unstaged": unstaged_ms,
        "stage_ms": stage_ms,
        "kernels_per_frame": kernels / n_prof,
        "device_busy_ms_per_frame": busy_us / 1e3 / n_prof,
        "device_idle_share": 1.0 - busy_us / 1e3 / n_prof / unstaged_ms,
        "per_frame": {k: v / n_prof for k, v in counts.items()},
        "lk_kernel_us_per_launch": {k: float(np.mean(v)) for k, v in lk_us.items()},
        "lk_launches_per_frame": {k: len(v) / n_prof for k, v in lk_us.items()},
        "sync_sites_per_frame": sync_sites,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
