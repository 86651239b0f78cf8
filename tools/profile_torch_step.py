"""Stage profile of the PyTorch port's SLAM step on one NVIDIA card.

    python tools/profile_torch_step.py [--tracked 128] [--no-planes] [--frames 25]
                                       [--lines] [--stripe-wall] [--ba-every 8]
    python tools/profile_torch_step.py --tum DIR [--camera-yaml FILE] [--frames 40]
                                       [--ba-every 8]

Runs RoomScene orbit frames at 640x480 (default ``SlamConfig``, depth noise on;
``--stripe-wall``: the low-texture StripeWallScene on a lateral run) through
``rgbd_slam_tpu_torch.runner.run_frames`` on the card, with the step run eagerly
(``step_graph.EagerStep``, where ``run_frames`` would record it as one CUDA
graph: the stage timer's syncs and ranges cannot run inside a graph; the JSON
line's ``step`` says so), with lines (``--lines``)
and the keyframe / BA / pose-graph backend (``--ba-every``) on request.  The frames
after a 5-frame warm-up are split in two: the first half is timed per stage
(each stage's entry function gets a device sync on both sides and a host clock),
the second half runs unstaged under ``torch.profiler`` for device time, kernel
counts, device syncs and host reads per frame, and ``pose_opt``'s device time
and kernels split into the hypotheses' LM, P3P, scoring and the refit with its
Monte-Carlo covariance (``POSE_STAGES``; the two LM ranges hold the LM's
preparation and packing, and the LM kernels themselves, which the profiler
charges to no range, are ``lm_kernels``: ``OWN_KERNELS``; the scoring kernel is
charged to ``scoring`` the same way).  Eight more frames (one group
of the backend's cadence, ``runner.SUMMARY_BATCH``) run under ``torch.cuda.set_sync_debug_mode`` to
name the package line of every host sync.  With planes on, ``PRIMITIVE_FRAMES``
more frames run under the profiler with every op of ``find_primitives`` in a
range of its part (``PRIMITIVE_STAGES``: cells, components, regions,
cylinders, compact_merge, boundaries; ``PrimitiveRanges``), which splits
``plane_extract``'s device µs and kernels a frame
(``plane_extract_per_frame``).  Each run segment is a ``run_frames``
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
import ast
import dataclasses
import inspect
import json
import subprocess
import sys
import tempfile
import textwrap
import time
import traceback
import warnings
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.overrides import TorchFunctionMode

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rgbd_slam_tpu_torch import (cli, config, engine, runner, step_graph,  # noqa: E402
                                 synthetic)
from rgbd_slam_tpu_torch.features import primitives  # noqa: E402
from rgbd_slam_tpu_torch.io import datasets  # noqa: E402
from rgbd_slam_tpu_torch.ops import (brief, fast, image, matching, optical_flow,  # noqa: E402
                                     ransac_score_cuda)
from rgbd_slam_tpu_torch.parallel.keyframes import KeyframeWindow  # noqa: E402
from rgbd_slam_tpu_torch.parallel.pose_graph import PoseGraph  # noqa: E402
from rgbd_slam_tpu_torch.pose import optimizer  # noqa: E402
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


#: the parts of ``pose_opt`` the profiled frames split it into: the LM of the
#: RANSAC hypotheses (``lm_solve`` outside the refit), the P3P hypotheses, the
#: hypotheses' and the final pose's scoring (``ransac_score_cuda.score``: the
#: wrapper's allocations, and its kernel by name, ``OWN_POSE_PARTS``), and the
#: refit with its Monte-Carlo covariance (one LM batch); the rest of
#: ``pose_opt`` (subset draws, compaction, feature preparation) is
#: ``pose_opt_other``
POSE_STAGES = {
    "lm_hypotheses": [(optimizer, "lm_solve")],
    "p3p": [(optimizer, "p3p")],
    "scoring": [(ransac_score_cuda, "score")],
    "refit_mc": [(optimizer, "refit_with_variance")],
}
#: the part of ``pose_opt`` each of its own kernels is charged to, by name
#: prefix (the LM kernels, which both LM parts launch, are a part of their own)
OWN_POSE_PARTS = {"lm_solve_kernel": "lm_kernels", "ransac_score_kernel": "scoring"}
#: prefix of the profiler ranges around the parts of ``pose_opt``
POSE_PREFIX = "pose:"

#: the parts of ``plane_extract`` the primitive frames split it into.  Each
#: statement of ``find_primitives``' body belongs to one part, found by the
#: names it assigns (``primitive_parts``), and so does every op it runs, in the
#: functions it calls too: ``cells`` is the per-cell pass (the cloud, the cell
#: fits, the edge maps, the normal bins; ``csrc/cells.cu`` where the port has
#: it), ``components`` the connected components, ``regions`` the statements
#: between them and the cylinder stage (region sizes, top-k, moment combine,
#: region fit, the seed gate), ``cylinders`` the cylinder stage from the axis
#: gate to the routing back (``csrc/cylinders.cu`` where the port has it),
#: ``compact_merge`` the model choice, compaction, plane merge, refit and
#: cloud covariance, and ``boundaries`` the statements from the boundary
#: polygons on
PRIMITIVE_STAGES = {
    "cells": ("cloud", "valid", "grid", "edges", "bins", "cells"),
    "components": ("comp",),
    "regions": (),
    # the prefixes of the names its first and its last statement assign
    "cylinders": (("cy_", "cyl_"), "cy_"),
    "compact_merge": (),
    "boundaries": ("planes_out",),
}
#: prefix of the profiler ranges around the ops of each part
PRIMITIVE_PREFIX = "prim:"
#: frames profiled for the parts of ``plane_extract``, after the sync sites'
PRIMITIVE_FRAMES = 4
#: the port's own kernels by name prefix, and the part of ``plane_extract``
#: that launches each
PRIMITIVE_KERNELS = {"cells_": "cells", "components_kernel": "components",
                     "cylinders_kernel": "cylinders"}

#: how the profiled runs step: eagerly, stage by stage
EAGER = "eager: engine.step a frame (step_graph.EagerStep), not the CUDA graph run_frames " \
    "records on a card"

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


#: prefix of the profiler ranges that ``StageRanges`` opens around a stage
RANGE_PREFIX = "stage:"
#: the port's own kernels by name prefix, and the stage that launches each.
#: They are launched through ctypes, outside every PyTorch op, so the profiler
#: charges them to no range: they are charged to their stage by name.
OWN_KERNELS = {"lk_": "optical_flow", "components_kernel": "plane_extract",
               "cells_": "plane_extract", "cylinders_kernel": "plane_extract",
               "lm_solve_kernel": "pose_opt", "ransac_score_kernel": "pose_opt"}


def own_stage(name: str):
    """The stage of one of the port's own kernels (``OWN_KERNELS``), or None."""
    return next((stage for prefix, stage in OWN_KERNELS.items() if name.startswith(prefix)),
                None)


class StageRanges(StageTimer):
    """Opens a ``torch.profiler.record_function`` range (named ``prefix`` +
    the stage) around the outermost call of each stage function, with no sync
    and no clock: under ``torch.profiler`` the kernels a stage launches are
    charged to it (``device_breakdown``, ``range_breakdown``)."""

    def __init__(self, stages=None, prefix=RANGE_PREFIX):
        super().__init__(stages)
        self.prefix = prefix

    def _wrap(self, stage, fn):
        def ranged(*args, **kw):
            if self.active:
                return fn(*args, **kw)
            self.active = True
            try:
                with torch.profiler.record_function(self.prefix + stage):
                    return fn(*args, **kw)
            finally:
                self.active = False
        return ranged


def primitive_parts(fn=None) -> dict:
    """{source line: part} of ``find_primitives``' body (``PRIMITIVE_STAGES``):
    the statements before the one that assigns ``comp`` are ``cells``, that one
    is ``components``; the cylinder stage runs from the first statement that
    assigns a ``cy_`` or ``cyl_`` name to the last that assigns a ``cy_`` name;
    the statements between ``comp`` and it are ``regions`` (but ``bins``,
    ``cells``), those after it ``compact_merge``, and from the one that assigns
    ``planes_out`` on ``boundaries``."""
    fn = primitives.find_primitives if fn is None else fn
    lines, first = inspect.getsourcelines(fn)
    body = ast.parse(textwrap.dedent("".join(lines))).body[0].body
    offset = first - 1

    def assigned(stmt):
        targets = getattr(stmt, "targets", None) or [getattr(stmt, "target", None)]
        return {n.id for t in targets if t is not None for n in ast.walk(t)
                if isinstance(n, ast.Name)}

    names = [assigned(s) for s in body]

    def first_index(pred, default=None):
        return next((i for i, n in enumerate(names) if pred(n)), default)

    i_comp = first_index(lambda n: set(PRIMITIVE_STAGES["components"]) & n)
    first, last = PRIMITIVE_STAGES["cylinders"]
    i_cyl0 = first_index(lambda n: any(x.startswith(first) for x in n))
    i_cyl1 = max(i for i, n in enumerate(names) if any(x.startswith(last) for x in n))
    i_bound = first_index(lambda n: set(PRIMITIVE_STAGES["boundaries"]) & n)
    cells = set(PRIMITIVE_STAGES["cells"])
    parts = {}
    for i, stmt in enumerate(body):
        if i < i_comp or names[i] & cells:
            part = "cells"
        elif i == i_comp:
            part = "components"
        elif i < i_cyl0:
            part = "regions"
        elif i <= i_cyl1:
            part = "cylinders"
        elif i < i_bound:
            part = "compact_merge"
        else:
            part = "boundaries"
        for line in range(stmt.lineno + offset, stmt.end_lineno + offset + 1):
            parts[line] = part
    return parts


class PrimitiveRanges(TorchFunctionMode):
    """While ``find_primitives`` runs, every PyTorch op it runs (in the
    functions it calls too) goes into a profiler range named
    ``PRIMITIVE_PREFIX`` + its part, the part of the body statement it runs
    under (``primitive_parts``).  The port's own kernels launch through ctypes,
    outside every op: ``PRIMITIVE_KERNELS`` charges them by name.  Costs host
    time on every op: profile it over frames of its own."""

    def __init__(self):
        super().__init__()
        self.fn = primitives.find_primitives
        self.code = self.fn.__code__
        self.parts = primitive_parts(self.fn)

    def install(self):
        fn, mode = self.fn, self

        def split(*args, **kw):
            with mode:
                return fn(*args, **kw)
        primitives.find_primitives = split

    def remove(self):
        primitives.find_primitives = self.fn

    def __torch_function__(self, func, types, args=(), kwargs=None):
        frame = sys._getframe(1)
        while frame is not None and frame.f_code is not self.code:
            frame = frame.f_back
        part = self.parts.get(frame.f_lineno, "other") if frame is not None else "other"
        with torch.profiler.record_function(PRIMITIVE_PREFIX + part):
            return func(*args, **(kwargs or {}))


def primitive_breakdown(prof, n_frames: int) -> dict:
    """Device µs and kernels a frame of each part of ``plane_extract`` from a
    ``torch.profiler`` run under ``PrimitiveRanges``, the port's own kernels
    charged to their parts by name."""
    parts = range_breakdown(prof, n_frames, PRIMITIVE_PREFIX)
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        part = next((p for prefix, p in PRIMITIVE_KERNELS.items()
                     if evt.name.startswith(prefix)), None)
        if part is not None:
            entry = parts.setdefault(part, {"device_us": 0.0, "kernels": 0.0})
            entry["device_us"] += evt.time_range.elapsed_us() / n_frames
            entry["kernels"] += 1 / n_frames
    parts["plane_extract"] = {k: sum(p[k] for p in parts.values())
                              for k in ("device_us", "kernels")}
    return parts


def device_breakdown(prof, n_frames: int):
    """Device time of a ``torch.profiler`` run over ``n_frames`` frames under
    ``StageRanges``.  Returns (device µs a frame by stage, ``other`` for the
    kernels launched outside every stage; device µs a frame in all; FLOPs a
    frame that the profiler counts, which needs ``with_flops=True``; the names
    of the ops whose FLOPs it counts)."""
    stages = defaultdict(float)
    total_us = flops = 0.0
    flop_ops = set()
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            # a range also shows on the device's timeline: it is not a kernel
            if not evt.name.startswith(RANGE_PREFIX):
                total_us += evt.time_range.elapsed_us()
                stage = own_stage(evt.name)
                if stage is not None:
                    stages[stage] += evt.time_range.elapsed_us()
            continue
        if evt.name.startswith(RANGE_PREFIX):
            under = getattr(evt, "device_time_total", None)
            stages[evt.name[len(RANGE_PREFIX):]] += (
                evt.cuda_time_total if under is None else under)
        if evt.flops:
            flops += evt.flops
            flop_ops.add(evt.name)
    per_frame = {k: v / n_frames for k, v in sorted(stages.items(), key=lambda kv: -kv[1])}
    per_frame["other"] = (total_us - sum(stages.values())) / n_frames
    return per_frame, total_us / n_frames, flops / n_frames, sorted(flop_ops)


def _kernels_under(evt) -> int:
    """Kernels launched by a profiler event and everything under it."""
    return len(evt.kernels) + sum(_kernels_under(child) for child in evt.cpu_children)


def range_breakdown(prof, n_frames: int, prefix: str) -> dict:
    """Device µs and kernels a frame under each ``prefix`` range of a
    ``torch.profiler`` run over ``n_frames`` frames (``StageRanges``)."""
    parts = defaultdict(lambda: {"device_us": 0.0, "kernels": 0.0})
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA or not evt.name.startswith(prefix):
            continue
        part = parts[evt.name[len(prefix):]]
        part["device_us"] += evt.device_time_total / n_frames
        part["kernels"] += _kernels_under(evt) / n_frames
    return dict(parts)


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
        "card": _card_line(), "step": EAGER, "tum": args.tum, "frames": n, "ba_every": args.ba_every,
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
    step_graph.stepper = step_graph.EagerStep
    if args.tum:
        return profile_tum(args, device)
    cam = config.TUM_FR1
    cfg = config.SlamConfig()
    cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(
        cfg.mapping, max_tracked_points=args.tracked))
    with_planes = not args.no_planes
    run_kw = dict(with_planes=with_planes, with_lines=args.lines, ba_every=args.ba_every)
    # the sync sites are found over one more group of the backend's cadence,
    # and the parts of plane_extract over PRIMITIVE_FRAMES more
    n_sync = runner.SUMMARY_BATCH
    n_prim = PRIMITIVE_FRAMES if with_planes else 0
    if args.stripe_wall:
        scene = synthetic.StripeWallScene(cam, texture_scale=0.03, stripe_period_z=2400.0)
        poses = synthetic.lateral_trajectory(args.frames + n_sync + n_prim, speed_mm=4.0)
    else:
        scene = synthetic.RoomScene(cam, depth_noise=config.DepthNoiseModel())
        poses = synthetic.orbit_trajectory(args.frames + n_sync + n_prim, speed_mm=4.0)
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
    ranges = [StageRanges({"pose_opt": STAGES["pose_opt"]}),
              StageRanges(POSE_STAGES, prefix=POSE_PREFIX)]
    for r in ranges:
        r.install()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            state, _, _ = runner.run_frames(frames[warm + n_staged:args.frames], cam, cfg,
                                            state=state, device=device, **run_kw)
            torch.cuda.synchronize()
            unstaged_ms = 1e3 * (time.perf_counter() - t0) / n_prof
    finally:
        for r in ranges:
            r.remove()
    pose = range_breakdown(prof, n_prof, RANGE_PREFIX).get(
        "pose_opt", {"device_us": 0.0, "kernels": 0.0})
    pose_parts = range_breakdown(prof, n_prof, POSE_PREFIX)
    pose_parts["pose_opt_other"] = {
        k: pose[k] - sum(p[k] for p in pose_parts.values()) for k in pose}
    kernels, busy_us = 0, 0.0
    own_us = defaultdict(list)
    for evt in prof.events():
        # a range also shows on the device's timeline: it is not a kernel
        if evt.device_type == DeviceType.CUDA \
                and not evt.name.startswith((RANGE_PREFIX, POSE_PREFIX)):
            kernels += 1
            us = evt.time_range.elapsed_us()
            busy_us += us
            if own_stage(evt.name) is not None:
                own_us[evt.name.split("(")[0]].append(us)
    # pose_opt's own launches, which no range sees (OWN_KERNELS), added to
    # their part (OWN_POSE_PARTS) and to pose_opt
    own = {"device_us": 0.0, "kernels": 0.0}
    pose_parts.setdefault("lm_kernels", {"device_us": 0.0, "kernels": 0.0})
    for name, v in own_us.items():
        if own_stage(name) == "pose_opt":
            part = next(p for prefix, p in OWN_POSE_PARTS.items() if name.startswith(prefix))
            add = {"device_us": sum(v) / n_prof, "kernels": len(v) / n_prof}
            row = pose_parts.setdefault(part, {"device_us": 0.0, "kernels": 0.0})
            for k in own:
                row[k] += add[k]
                own[k] += add[k]
    pose_parts["pose_opt"] = {"device_us": pose["device_us"] + own["device_us"],
                              "kernels": pose["kernels"] + own["kernels"]}
    counts = defaultdict(int)
    for avg in prof.key_averages():
        if avg.key in ("cudaStreamSynchronize", "aten::item", "aten::_local_scalar_dense",
                       "cudaMemcpyAsync", "cudaLaunchKernel"):
            counts[avg.key] = avg.count

    sync_sites = _sync_sites(frames[args.frames:args.frames + n_sync], cam, cfg, run_kw,
                             state, device)
    prim_parts = None
    if n_prim:
        split = PrimitiveRanges()
        split.install()
        try:
            with torch.profiler.profile(activities=acts) as prim_prof:
                runner.run_frames(frames[args.frames + n_sync:], cam, cfg, state=state,
                                  device=device, **run_kw)
                torch.cuda.synchronize()
        finally:
            split.remove()
        prim_parts = primitive_breakdown(prim_prof, n_prim)
    stage_ms = {k: timer.ms[k] / n_staged for k in STAGES}
    stage_ms["rest"] = staged_ms - sum(stage_ms.values())
    print(json.dumps({
        "card": _card_line(), "step": EAGER, "with_planes": with_planes, "with_lines": args.lines,
        "scene": "stripe_wall" if args.stripe_wall else "room", "ba_every": args.ba_every,
        "tracked": args.tracked,
        "staged_frames": n_staged, "profiled_frames": n_prof,
        "step_ms_staged": staged_ms, "step_ms_unstaged": unstaged_ms,
        "stage_ms": stage_ms,
        "kernels_per_frame": kernels / n_prof,
        "device_busy_ms_per_frame": busy_us / 1e3 / n_prof,
        "device_idle_share": 1.0 - busy_us / 1e3 / n_prof / unstaged_ms,
        "per_frame": {k: v / n_prof for k, v in counts.items()},
        "own_kernel_us_per_launch": {k: float(np.mean(v)) for k, v in own_us.items()},
        "own_launches_per_frame": {k: len(v) / n_prof for k, v in own_us.items()},
        "pose_opt_per_frame": pose_parts,
        "plane_extract_per_frame": prim_parts,
        "sync_sites_per_frame": sync_sites,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
