"""Stage profile of the PyTorch port's SLAM step on one NVIDIA card.

    python tools/profile_torch_step.py [--tracked 128] [--no-planes] [--frames 25]
                                       [--lines] [--stripe-wall] [--ba-every 8]
    python tools/profile_torch_step.py --tum DIR [--camera-yaml FILE] [--frames 40]
                                       [--ba-every 8]

Runs RoomScene orbit frames at 640x480 (default ``SlamConfig``, depth noise on;
``--stripe-wall``: the low-texture StripeWallScene on a lateral run) through
``rgbd_slam_tpu_torch.runner.run_frames`` on the card, with lines (``--lines``)
and the keyframe / BA / pose-graph backend (``--ba-every``) on request.  The frames
after a 5-frame warm-up are split in two: the first half is timed per stage
(each stage's entry function gets a device sync on both sides and a host clock),
the second half runs unstaged under ``torch.profiler`` for device time, kernel
counts, device syncs and host reads per frame.  Eight more frames (one batch
of the runner's summary reads) run under ``torch.cuda.set_sync_debug_mode`` to
name the package line of every host sync.  Each run segment is a ``run_frames``
call of its own, so with ``--ba-every 8`` a refine fires only in a segment of
16 frames or more (three keyframes by its frame 15): ``--frames 53``.
Prints one JSON line.

``--tum DIR`` profiles the command-line entry point's loop instead
(``rgbd_slam_tpu_torch.cli``: decode with the native loader, upload, rectify for
the rig of ``--camera-yaml``, step, streamed map export) over the first
``--frames`` frames of a TUM directory: ms a frame by stage (decode on the host
clock; rectify, step and export with a device sync on both sides; the rest is
upload and the runner's own work), then the host syncs a frame by package line,
once with the frames uploaded one by one from pageable memory, as the CLI feeds
them, and once through ``runner.stage_frames``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rgbd_slam_tpu_torch import cli, config, engine, runner, synthetic  # noqa: E402
from rgbd_slam_tpu_torch.features import primitives  # noqa: E402
from rgbd_slam_tpu_torch.io import datasets  # noqa: E402
from rgbd_slam_tpu_torch.ops import brief, fast, image, matching, optical_flow  # noqa: E402
from rgbd_slam_tpu_torch.parallel.keyframes import KeyframeWindow  # noqa: E402
from rgbd_slam_tpu_torch.parallel.pose_graph import PoseGraph  # noqa: E402
from rgbd_slam_tpu_torch.tracking import inverse_depth_tracking, kalman  # noqa: E402

#: stage -> the (module or class, function name) pairs the step calls for it
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
    "line_detect": [(engine, "_observe_lines")],
    "line_match": [(engine, "_match_lines")],
    "line_update": [(engine, "_update_lines")],
    "ba_refine": [(KeyframeWindow, "refine")],
    "pose_graph": [(PoseGraph, "solve")],
}


#: the stages of the command-line loop (``--tum``)
TUM_STAGES = {
    "rectify": [(runner, "rectify_depth")],
    "step": [(engine, "step")],
    "map_export": [(runner, "append_dying_features"), (runner, "append_alive_features")],
}


class StageTimer:
    """Wraps each stage function with a device sync on both sides and a host
    clock; only the outermost wrapped call is timed."""

    def __init__(self, stages=None):
        self.stages = STAGES if stages is None else stages
        self.ms = defaultdict(float)
        self.active = False
        self.saved = []

    def install(self):
        for stage, targets in self.stages.items():
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


def _sync_sites(frames, cam, cfg, run_kw, state, device):
    """Host syncs per frame by the package line that caused them, from
    ``torch.cuda.set_sync_debug_mode``'s warnings over ``frames``; the key
    ``all`` is their sum."""
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
            runner.run_frames(frames, cam, cfg, state=state, device=device, **run_kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    per_frame = {k: v / len(frames) for k, v in sorted(sites.items())}
    per_frame["all"] = sum(per_frame.values())
    return per_frame


def profile_tum(args, device) -> int:
    """The command-line loop over a TUM directory: stage times, then the syncs a
    frame with and without staged uploads."""
    setup = config.load_camera_yaml(args.camera_yaml) if args.camera_yaml else None
    cam = setup.rgb if setup is not None else config.TUM_FR1
    cfg = config.SlamConfig()
    index = datasets.index_tum(args.tum)[:args.frames]
    if not index:
        print(f"profile_torch_step: no frames in {args.tum}", file=sys.stderr)
        return 1
    n = len(index)
    decode_ms = [0.0]

    def decoded():
        frames = cli.open_frames(index, cam, native=True)
        while True:
            t0 = time.perf_counter()
            frame = next(frames, None)
            decode_ms[0] += 1e3 * (time.perf_counter() - t0)
            if frame is None:
                return
            yield frame

    with tempfile.TemporaryDirectory() as work:
        run_kw = dict(ba_every=args.ba_every, camera_setup=setup,
                      export_map=str(Path(work) / "map.obj"))
        warm = list(cli.open_frames(index[:5], cam, native=True))
        runner.run_frames(warm, cam, cfg, device=device, **run_kw)
        timer = StageTimer(TUM_STAGES)
        timer.install()
        t0 = time.perf_counter()
        _, _, stats = runner.run_frames(decoded(), cam, cfg, device=device, **run_kw)
        torch.cuda.synchronize()
        frame_ms = 1e3 * (time.perf_counter() - t0) / n
        timer.remove()
        frames = list(cli.open_frames(index, cam, native=True))
        rectify_us, rectify_kernels = None, None
        if setup is not None:
            # device time and launches of one rectification, the profiler's count
            depth = torch.as_tensor(frames[0][1], device=device)
            ext = torch.tensor(setup.depth_to_rgb, dtype=torch.float32, device=device)
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(20):
                    runner.rectify_depth(depth, setup.depth, cam, ext)
                torch.cuda.synchronize()
            on_card = [e.time_range.elapsed_us() for e in prof.events()
                       if e.device_type == DeviceType.CUDA]
            rectify_us, rectify_kernels = sum(on_card) / 20, len(on_card) / 20
        pageable = _sync_sites(frames, cam, cfg, run_kw, None, device)
        staged = _sync_sites(runner.stage_frames(frames, device=device), cam, cfg, run_kw,
                             None, device)
    stage_ms = {k: timer.ms[k] / n for k in TUM_STAGES}
    stage_ms["decode"] = decode_ms[0] / n
    stage_ms["upload_and_runner"] = frame_ms - sum(stage_ms.values())
    print(json.dumps({
        "card": _card_line(), "tum": args.tum, "frames": n, "ba_every": args.ba_every,
        "rectified": setup is not None, "frame_ms": frame_ms, "stage_ms": stage_ms,
        "rectify_device_us": rectify_us, "rectify_kernels": rectify_kernels,
        "lost": stats.lost_count, "map_streamed": stats.map_streamed,
        "map_alive_at_end": stats.map_alive_at_end,
        "syncs_per_frame_pageable": pageable["all"], "syncs_per_frame_staged": staged["all"],
        "sync_sites_per_frame_pageable": pageable, "sync_sites_per_frame_staged": staged,
    }))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tracked", type=int, default=128, help="max_tracked_points")
    ap.add_argument("--no-planes", action="store_true", help="the points-only step")
    ap.add_argument("--frames", type=int, default=25,
                    help="frames of the timed run, warm-up included")
    ap.add_argument("--lines", action="store_true", help="line features on")
    ap.add_argument("--stripe-wall", action="store_true",
                    help="the low-texture StripeWallScene instead of the RoomScene")
    ap.add_argument("--ba-every", type=int, default=None,
                    help="the backend on, a refine every this many frames")
    ap.add_argument("--tum", default="", metavar="DIR",
                    help="profile the command-line loop over this TUM directory instead")
    ap.add_argument("--camera-yaml", default="", help="with --tum: the rig's camera YAML")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    if args.tum:
        return profile_tum(args, device)
    cam = config.TUM_FR1
    cfg = config.SlamConfig()
    cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(
        cfg.mapping, max_tracked_points=args.tracked))
    with_planes = not args.no_planes
    run_kw = dict(with_planes=with_planes, with_lines=args.lines, ba_every=args.ba_every)
    # the sync sites are found over one more batch of summary reads
    n_sync = runner.SUMMARY_BATCH
    if args.stripe_wall:
        scene = synthetic.StripeWallScene(cam, texture_scale=0.03, stripe_period_z=2400.0)
        poses = synthetic.lateral_trajectory(args.frames + n_sync, speed_mm=4.0)
    else:
        scene = synthetic.RoomScene(cam, depth_noise=config.DepthNoiseModel())
        poses = synthetic.orbit_trajectory(args.frames + n_sync, speed_mm=4.0)
    frames = [scene.render(q, p) for q, p in poses]
    warm = 5
    n_staged = (args.frames - warm) // 2
    n_prof = args.frames - warm - n_staged

    state, _, _ = runner.run_frames(frames[:warm], cam, cfg, device=device, **run_kw)
    timer = StageTimer()
    timer.install()
    t0 = time.perf_counter()
    state, _, _ = runner.run_frames(frames[warm:warm + n_staged], cam, cfg, state=state,
                                    device=device, **run_kw)
    torch.cuda.synchronize()
    staged_ms = 1e3 * (time.perf_counter() - t0) / n_staged
    timer.remove()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, _, _ = runner.run_frames(frames[warm + n_staged:args.frames], cam, cfg,
                                        state=state, device=device, **run_kw)
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

    sync_sites = _sync_sites(frames[args.frames:], cam, cfg, run_kw, state, device)
    stage_ms = {k: timer.ms[k] / n_staged for k in STAGES}
    stage_ms["rest"] = staged_ms - sum(stage_ms.values())
    print(json.dumps({
        "card": _card_line(), "with_planes": with_planes, "with_lines": args.lines,
        "scene": "stripe_wall" if args.stripe_wall else "room", "ba_every": args.ba_every,
        "tracked": args.tracked,
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
