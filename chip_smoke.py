"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line of output each (any failure raises, so the last line, the
``{"ok": true, ...}`` object, is printed only when every phase passed):

1. device: a CUDA card must be present (no CPU run); prints
   ``nvidia-smi --query-gpu=name,power.limit``.
2. build: compiles every kernel library the package registers
   (``ops.nvcc.LIBRARIES``: the LK kernels, ``rgbd_slam_tpu_torch/csrc/lk.cu``;
   the components kernel, ``csrc/components.cu``; the plane extraction's cells
   and cylinders kernels, ``csrc/cells.cu``, ``csrc/cylinders.cu``; the LM
   kernel, ``csrc/lm.cu``; the line growth, ``csrc/line_grow.cu``; the RANSAC
   scoring, ``csrc/ransac_score.cu``; the step's stamps, ``csrc/stamps.cu``)
   with nvcc from the sources in this checkout,
   one ``nvcc`` a source, started together; prints the seconds and what ptxas
   says of each kernel's registers and spills.
3. kernels, each against its plain PyTorch version on the card, on a 640x480
   RoomScene frame pair with the default windows and levels:
   * fused forward-backward LK, 128 FAST points;
   * forward-only LK, 99 FAST points (N % 4 != 0);
   * single-level LK at level 0, seeded with the plain pyramid tracker's level-1
     result doubled;
   * the restage path: the single-level kernel with 30 iterations from guesses a
     seeded 9-11 px off on each axis, more than the margin the kernel stages
     around its window, so a window that finds its way back leaves the staged
     tile; at least 32 rows must do so.
   The first three are then timed: ``ms`` and ``plain_ms`` a call (median of 20
   CUDA-event timings after a warm-up; a single call's time includes the host's
   launch overhead), ``device_us`` a launch from 50 launches replayed from one
   CUDA graph (the pyramids warm in L2, as the step finds them right after
   ``build_pyramid``), and ``bound_ms``: what ``lk_cuda.lk_work`` counts these
   inputs to need (iterations really taken), FLOPs over 67 TFLOP/s (f32 outside
   the tensor cores) or bytes over 3.35 TB/s, whichever is larger; both counts
   are upper ones (every sample charged its own taps, whole pyramids), so the
   share of the bound a kernel reaches is an upper estimate.  No PyTorch call
   computes pyramidal LK, so ``library_ms`` is null.  Then the components
   kernel (the plane extraction's connected components, no Pallas port)
   against its plain version on the cell graph of a 640x480 RoomScene depth
   map, a serpentine one-cell-wide component, the grid in one component, a
   spiral cut in two, a random grid whose edges may join non-planar cells and
   the 40x30 cell graph of the same depth map at 16 px cells (more cells than
   a CTA's threads): labels equal; timed on the first, and warm on the
   serpentine (see ``check_components``).
   cells: the per-cell pass's kernel pair (``csrc/cells.cu``: the cloud, cell
   fits, edges, normal bins and cell centres of a depth map) against its
   plain version on the depth of every plane-path frame and of the tunnel
   leg's 30 frames: continuous fields within tolerances that follow float32's
   error and the closed-form eig3's conditioning, discrete fields (planar,
   edges, bins) equal or flipped only where the plain version's margin to the
   gate lies inside those tolerances, each flip printed with its margin
   (``check_cells_frame``, ``CELL_*``); timed (``device_us``) on the three
   ``TIMED_FRAMES`` (a room frame whose cylinder stage holds no live region,
   one that holds two, a tunnel frame that holds one), where its outputs must
   equal the first design's bits on the first design's inputs (``held_bits``:
   it prints null where the inputs moved, and fails where only the outputs
   did).
   cylinders: the cylinder stage's kernel (``csrc/cylinders.cu``: the axis
   gate of the 20 candidate regions, the selection of at most 4, the 3-round
   sub-segment MSAC and the routing back) against its plain version on the
   inputs ``find_primitives`` gives it on the same frames: the axis gate and
   the selection equal (or flipped within the score's tolerance), each live
   region's sub-segments against the plain MSAC run from the kernel's own
   axis, a differing round only where the plain version's own float32 error
   could take the kernel's decision (``subsegment_flip``), the fill values of
   the regions without a slot (``check_cylinder_stage``, ``CYL_*``); timed on
   the three ``TIMED_FRAMES`` (the tunnel frame's is the JSON line's), held to
   the first design's bits there as the cells are.
   large_grids: the main path's kernels on what configuration ``kv2_hd``
   (a Kinect v2's 1920x1080 registered stream) gives them and no 640x480
   phase does: the fused forward-backward LK at the 1920x1080 camera (level
   0's window swept in place) against its plain version, timed as above; the
   cylinder stage's global-memory path (``cylinders_kernel_global``: grids
   past one CTA's shared memory) against its plain version by the cylinders
   phase's rules on the room frames of ``TIMED_FRAMES`` and the tunnel's
   first frame, at 5,184 cells (1920x1080 at 20 px) and 4,800 (640x480 at
   8 px), each frame timed (``ms``, ``plain_ms``, ``device_us``,
   ``bound_ms``; the JSON line's on the 1080p tunnel frame), the tunnel
   frames holding a live region (``check_large_grids``).
   lm: the LM kernel (the pose optimizer's ``lm_solve``, no Pallas port)
   against its plain version on the inputs of both ``lm_solve`` calls (the
   32 RANSAC hypotheses over 6/6/3/6-feature subsets, 10 iterations; the
   refit + 100 Monte-Carlo members over 256/128/32/16 features, 6
   iterations) of three frames: the plane step's second room-orbit frame,
   the striped wall's with lines on, and a hard-scene frame with live
   inverse-depth points.  One linearization's normal equations, then the full
   LM held to the plain version step by step (each linearization, decision
   and trial of the kernel's run), a repeat to the bit, and the members whose
   result differs from the plain version's printed with their accept
   sequences; timed at both shapes on the plane frame (see ``check_lm``); the
   kernel line sums the two calls of a frame.
   ransac_score: the scoring kernel (the pose optimizer's RANSAC scores, best
   hypothesis and inlier masks, no Pallas port) against its plain version run
   on the card, on the inputs of both scoring calls (the 96 hypotheses, the
   refit's pose) of the three frames of the lm phase: every tested value
   (``details``) equal to the bit, decisions, scores, counts, the best
   hypothesis and its masks equal (a decision may differ only where the plain
   value lies within ``SCORE_FLIP_ULPS`` of its limit), a repeat to the bit;
   timed on the plane frame (``ms``, ``plain_ms``, ``device_us`` of each
   call) and inside the plane step's CUDA graph, where it must launch twice
   a frame (see ``check_ransac_score``).
   graph: the plane step over 30 staged frames eagerly and as one CUDA graph
   (``StepGraph``): poses and final states equal to the bit, ms a frame of
   both, the warm-up and capture time, 4 replays under the profiler (kernels
   and device time a frame; the launch counts must be what the profiler
   saw), and ``run_frames`` over the frames under ``set_sync_debug_mode``:
   every host sync must be the recording's; the runner waits for a frame's
   summary on an event, which is no sync (``run_graph_phase``).
   backend_graph: the windowed BA's packed solve at full count (8 keyframes x
   512 landmarks x 8 observations, every slot valid: ``full_window``) and the
   pose graph's (64 nodes, 256 edges: ``full_pose_graph``), each on two
   problems through the one ``solve_graph.SolveGraph`` that
   ``KeyframeWindow.refine`` / ``PoseGraph.solve`` replay, against the eager
   solve on the card: every output equal to the bit; ms a call of both (host
   clock, with the read back), kernels and device µs a call of both under the
   profiler, and the warm-up and capture seconds.
4. plane path: ``runner.run_frames`` over 60 RoomScene orbit frames at 640x480,
   default ``SlamConfig``, planes on (the default step), seed 0; checks one
   fused-kernel launch per frame, no more failed or lost frames than the JAX
   reference, the ATE bound and planes alive in the map at the end.
5. forward-only path: the same step with ``max_tracked_points=99`` over the
   first 30 frames; checks two forward-only launches and no fused launch a
   frame, failed/lost and the ATE bound of that configuration.
6. points-only path: planes off, the first 30 frames; one fused launch a frame,
   failed/lost and its ATE bound.
7. lines path: planes on, lines on, the first 30 frames; one fused launch a
   frame, failed/lost, the ATE bound, lines alive in the map at the end and
   line matches (inliers of the pose) on at least one frame.
8. low-texture lines path: a StripeWallScene whose block texture is crushed
   below FAST's thresholds, 30 frames of a lateral run, planes off, lines on;
   the same checks.  The lines-off ATE of the same frames is printed before
   it and gates nothing.
9. backend path: the 60 frames, planes on, ``ba_every=8``, pose graph on; one
   fused launch a frame, failed/lost, the ATE bound, at least as many
   keyframes, refines and accepted refines as the least JAX seed, every pose
   finite, one copy to the device and one read back per refine and per graph
   solve; prints ms per refine and per graph solve past the first; then the
   first 30 frames twice, which must give the same ATE to the last bit.  The
   refines and graph solves replay CUDA graphs (``solve_graph.SolveGraph``):
   every path with the backend checks that ``ba.ba_solve`` and
   ``pose_graph.solve_pose_graph`` ran in Python twice a run each, to warm up
   and to be captured, and never for a replay (``traced_solves``).
10. the paths that only ``bench.py`` ran before, each over the first 30 frames
    of its leg (``bench_torch.py``'s frame makers), planes on: ``hard``
    (``HardRoomScene`` with depth noise on the orbit: depth holes, a noise burst
    every 17th frame, a hanging sphere in front of the wall, a weak-texture
    band; ``ba_every=8``), ``hard_pred`` (the same with motion-model
    prediction), ``roll`` (the RoomScene rolling +-30 degrees about the optical
    axis over a 120-frame period; ``ba_every=8``), ``tunnel`` (``TunnelScene``
    on the forward flight) and ``tunnel_ba`` (the same, ``ba_every=8``).  Each
    checks one fused launch a frame, failed/lost, the ATE bound and, with the
    backend, the backend path's counts; the tunnel paths check cylinders on
    every frame in place of planes alive.  Each prints the components
    fixpoint's host reads a frame and the frames with a cylinder.
    Then ``kv2_hd``: the plane path over the first 16 RoomScene orbit frames
    (depth noise on) at the 1920x1080 camera, a 5,184-cell grid: the launches
    a frame of the plane path, its cylinder stage on the global-memory path,
    no failed or lost frame; its ATE is printed (no JAX reference runs at
    this size).
11. ``tum_cli``: the 60 frames written as a TUM directory (8-bit RGB and 16-bit
    depth PNGs by this script's own writer, the three list files, a camera YAML
    whose depth camera sits 25 mm off the RGB camera, the depth maps rendered
    from there), then ``python -m rgbd_slam_tpu_torch.cli ... --ba 8
    --stream-map --native-loader`` as a subprocess: exit 0, 60 trajectory lines
    of 8 fields, the printed ATE within its bound and equal to the ATE of the
    trajectory file, 0 failed and lost, one fused launch a frame, a map file
    with as many features as the run says it streamed and wrote at the end, at
    least one of them streamed when it died.
12. ``checkpoint``: 30 frames straight; 15 frames, ``save_state``,
    ``load_state`` into a fresh template, 15 more; both with
    ``torch.use_deterministic_algorithms(True)``; trajectories and final states
    equal to the last bit.
13. ``sharded_ba`` (the sharded solve stays eager: a CUDA graph cannot hold
    its ``gloo`` collectives): ``dryrun.dryrun_multichip(4)``: four ``gloo`` processes that
    share the card, ``dense`` and ``pcg`` against the single-device solve;
    ``dryrun.nccl_single_rank()``; then the backend path over the 30 frames with
    the refines sharded over 2 ranks: the same keyframes, refines and accepted
    counts as one device, the ATE within the backend bound.  Processes that
    share one card take turns on it, so the times printed beside the
    single-device ones measure what the collectives cost, not a speed-up.
14. the kernels' JSON line (launches summed over all paths; every path
    expects two LM launches and two scoring launches a frame, and one components, one cells and one
    cylinders launch a frame with planes on; the ``kv2_hd`` path's cylinder
    launches are the ``cylinders_global`` entry's, the global-memory path's),
    the card line again, and the result line.

Every plane path checks its cylinder section's stamps and, where it found a
cylinder, live cylinder slots counted in its ``RunStats``.

Every path runs through ``runner.run_frames``, which on the card records the
step as one CUDA graph at its first frame (one eager warm-up step, whose
launches count: each path expects its launches a frame times its frames plus
``RunStats.warmup_steps``) and replays it for every frame; no path may read
the components fixpoint on the host.  ``run_frames`` hands each frame over
one replay behind, so the per-frame times a path prints are the host's time
between two hand-overs; ``fps_from_frame_10`` leaves out frame 0 and the next
8 (``runner.SUMMARY_BATCH``), which follow the recording.  The last phase before the JSON lines prints the
script's wall time.

The JAX references come from ``rgbd_slam_tpu.runner.run_frames`` on the same
frames with seeds 0, 1 and 2 (0-4 for the low-texture path, whose seeds spread
by more than 2x), run on a CPU (its XLA LK path) with
``XLA_FLAGS=--xla_cpu_max_isa=AVX2`` by ``tools/jax_reference.py`` (the ``tum`` reference is fed the arrays the PNGs
decode to and the same rig): the worst
ATE-RMSE, the most failed and lost frames and the least keyframe and refine
counts of the runs.  The port draws other random numbers than JAX, so its ATE
is held to 1.5 x the worst JAX seed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import hashlib
import json
import math
import os
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import traceback
import warnings
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from bench_torch import hard_orbit, room_roll, tunnel_flight
from rgbd_slam_tpu_torch import (config, dryrun, engine, profiling, runner, solve_graph,
                                 step_graph, synthetic)
from rgbd_slam_tpu_torch.features import lines, primitives
from rgbd_slam_tpu_torch.geometry import pinhole, se3
from rgbd_slam_tpu_torch.io import checkpoint
from rgbd_slam_tpu_torch.io.trajectory import ate_rmse
from rgbd_slam_tpu_torch.ops import (cells_cuda, components_cuda, cylinders_cuda, fast, image,
                                     line_grow_cuda, lk_cuda, lm_cuda, nvcc,
                                     ransac_score_cuda)
from rgbd_slam_tpu_torch.ops.depth_cloud import depth_to_cloud
from rgbd_slam_tpu_torch.parallel import ba, keyframes, pose_graph
from rgbd_slam_tpu_torch.parallel.pose_graph import _np_quat_rotate

ROOT = os.path.dirname(os.path.abspath(__file__))

SEED = 0
#: |kernel - plain| bound on points both versions track: the two sum the window's
#: products in a different order, which can move one convergence test by one
#: Gauss-Newton iteration, and that iteration moves a point by < eps = 0.03 px
TOL_PX = 0.05
ATE_MARGIN = 1.5
#: the card's published peaks (NVIDIA H100 SXM data sheet): f32 outside the
#: tensor cores, and device memory
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
#: pixels the LK kernels stage around the destination window (LK_MARGIN in
#: csrc/lk.cu); the restage check starts its guesses further off than this
STAGED_MARGIN_PX = 8
#: tracked-set capacity of the forward-only path: the track_forward_backward
#: branch that runs the forward-only kernel twice needs a count that is not a
#: multiple of 4, and 99 is the nearest one under the reference's 100-point
#: per-frame cap (max_point_per_frame), so detection tops the set up every frame
FORWARD_ONLY_TRACKED = 99
#: JAX references (see the module docstring), keyed by path
JAX_REFERENCE = {
    "planes": {"frames": 60, "worst_ate_mm": 22.22586305747491, "failed": 0, "lost": 0},
    "forward_only": {"frames": 30, "worst_ate_mm": 12.58165533125516, "failed": 0,
                     "lost": 0},
    "points": {"frames": 30, "worst_ate_mm": 2.0459552996148145, "failed": 0, "lost": 0},
    "lines": {"frames": 30, "worst_ate_mm": 13.17768539625983, "failed": 0, "lost": 0},
    "lines_lowtex": {"frames": 30, "worst_ate_mm": 42.403517378883954, "failed": 0,
                     "lost": 0},
    "ba": {"frames": 60, "worst_ate_mm": 21.410458774998148, "failed": 0, "lost": 0,
           "keyframes": 16, "ba_runs": 6, "ba_accepted": 6},
    "tum": {"frames": 60, "worst_ate_mm": 11.917487719073332, "failed": 0, "lost": 0,
            "keyframes": 13, "ba_runs": 6, "ba_accepted": 6},
    "hard": {"frames": 30, "worst_ate_mm": 49.63225932905733, "failed": 0, "lost": 0,
             "keyframes": 14, "ba_runs": 3, "ba_accepted": 3},
    "hard_pred": {"frames": 30, "worst_ate_mm": 49.63434038781985, "failed": 0, "lost": 0,
                  "keyframes": 14, "ba_runs": 3, "ba_accepted": 3},
    "roll": {"frames": 30, "worst_ate_mm": 9.115547573074586, "failed": 0, "lost": 0,
             "keyframes": 22, "ba_runs": 3, "ba_accepted": 3},
    "tunnel": {"frames": 30, "worst_ate_mm": 3.252573140666306, "failed": 0, "lost": 0,
               "cylinder_frames": 30},
    "tunnel_ba": {"frames": 30, "worst_ate_mm": 3.641390156742322, "failed": 0, "lost": 0,
                  "keyframes": 10, "ba_runs": 3, "ba_accepted": 3, "cylinder_frames": 30},
}
#: the paths that only ``bench.py`` ran before, each over the first 30 frames of
#: its leg (``bench_torch.py``'s frame makers): path -> (frames, run_frames
#: keywords, motion-model prediction)
BENCH_LEG_PATHS = {
    "hard": ("hard", dict(ba_every=8), False),
    "hard_pred": ("hard", dict(ba_every=8), True),
    "roll": ("roll", dict(ba_every=8), False),
    "tunnel": ("tunnel", dict(), False),
    "tunnel_ba": ("tunnel", dict(ba_every=8), False),
}
#: the Kinect v2's colour camera as ``kinect2_bridge`` publishes it at 1080p
#: (configuration ``kv2_hd``): a 96x54 grid of 20 px cells
KV2_HD = config.CameraIntrinsics(width=1920, height=1080, fx=1081.37, fy=1081.37, cx=959.5,
                                 cy=539.5)
#: frames of the ``kv2_hd`` path
HD_FRAMES = 16
#: a second path of a kernel library in the kernels' JSON line: the cylinder
#: stage's global-memory path, whose launches ``cylinders`` counts
SECOND_PATHS = {"cylinders_global": "cylinders"}
#: frames of the backend path's repeat, of the checkpoint phase's straight run
#: and of the sharded backend run
SHORT_RUN_FRAMES = 30
#: the ``tum_cli`` rig: the depth camera sits this far along the RGB camera's x
RIG_BASELINE_MM = 25.0
#: one fused forward-backward launch a frame (every path but the forward-only
#: one), one components, one cells and one cylinders launch a frame with
#: planes on, two LM launches a frame (the hypothesis batch and the refit +
#: Monte-Carlo batch), two scoring launches a frame (the hypotheses, the
#: refit's pose), and a line growth launch a frame with lines on
#: (``LINE_PATH``)
FUSED_ONLY = {"lk_fwd_bwd": 1, "lk_pyramid": 0, "lk_level": 0, "components": 1,
              "cells": 1, "cylinders": 1, "lm_solve": 2, "line_grow": 0,
              "ransac_score": 2}
LINE_PATH = {**FUSED_ONLY, "line_grow": 1}
#: the kernel the profiler sees for one launch a wrapper counts, by the start
#: of its name (the LM's count covers ``lm_solve_kernel`` and
#: ``lm_solve_kernel_warp``, one a call; the cells' is the fit kernel of the
#: pair ``cells_fit_kernel`` + ``cells_edges_kernel``)
LAUNCH_MARKS = {**{name: name + "_kernel" for name in FUSED_ONLY}, "cells": "cells_fit_kernel"}
#: the kernels a step launches only with planes on
PLANE_KERNELS = ("components", "cells", "cylinders")
#: the Pallas kernel each CUDA kernel replaces; the components, cells,
#: cylinders and LM kernels replace XLA code of the JAX step, no Pallas kernel
REPLACES = {"lk_fwd_bwd": "rgbd_slam_tpu/ops/pallas_lk.py:408",
            "lk_pyramid": "rgbd_slam_tpu/ops/pallas_lk.py:472",
            "lk_level": "rgbd_slam_tpu/ops/pallas_lk.py:514",
            "components": "rgbd_slam_tpu/features/primitives.py:267",
            "cells": "rgbd_slam_tpu/ops/depth_cloud.py:21, rgbd_slam_tpu/features/primitives.py:"
                     "87, :111, :197, :271 (XLA: the jitted find_primitives, :441)",
            "cylinders": "rgbd_slam_tpu/features/primitives.py:301, :319, :496-525 (XLA: the "
                         "jitted find_primitives, :441)",
            "lm_solve": "rgbd_slam_tpu/pose/optimizer.py:50 (XLA: lax.scan over jax.linearize)",
            "line_grow": "rgbd_slam_tpu/features/lines.py:153-170 (XLA: the seed_step loop over "
                         "_propagate's lax.while_loop; the port's dense reach closure before)",
            "ransac_score": "rgbd_slam_tpu/pose/optimizer.py:224, :293-306, :325 and "
                            "rgbd_slam_tpu/pose/residuals.py:171 (XLA: the vmapped _score_pose, "
                            "the rank's argmax, inlier_masks_prepared)"}
SOURCES = {"lk_fwd_bwd": "rgbd_slam_tpu_torch/csrc/lk.cu",
           "lk_pyramid": "rgbd_slam_tpu_torch/csrc/lk.cu",
           "lk_level": "rgbd_slam_tpu_torch/csrc/lk.cu",
           "components": "rgbd_slam_tpu_torch/csrc/components.cu",
           "cells": "rgbd_slam_tpu_torch/csrc/cells.cu",
           "cylinders": "rgbd_slam_tpu_torch/csrc/cylinders.cu",
           "lm_solve": "rgbd_slam_tpu_torch/csrc/lm.cu",
           "line_grow": "rgbd_slam_tpu_torch/csrc/line_grow.cu",
           "ransac_score": "rgbd_slam_tpu_torch/csrc/ransac_score.cu"}
#: the two lm_solve calls of a plane step, in their order
LM_CALLS = ("hypotheses", "refit_mc")
#: the lm phase's tolerances.  A linearization's cost and normal equations
#: against the plain version's at the same point in float64: each entry within
#: LM_LINEARIZATION_RTOL (LM_COST_RTOL for the cost) of the member's largest
#: entry of its kind, plus LM_SPREAD_FACTOR times how far moving every input
#: and the point by an ulp moves that entry (the largest of LM_SPREAD_DRAWS
#: seeded draws of the ulps' signs).  Float32 resolves a Jtr near the optimum,
#: or the direction of an inverse-depth point's short projected segment, no
#: better than that, and a row's value and tangents pass through some 30
#: roundings (the pose, the projection, the distance), each of which may move
#: them as far as an ulp of the inputs does.  A trial against the plain
#: version's damped step from the same state: within LM_POSITION_TOL_MM (mm)
#: and LM_STEREO_TOL.
LM_LINEARIZATION_RTOL = 1e-4
LM_COST_RTOL = 1e-4
LM_POSITION_TOL_MM = 1e-3
LM_STEREO_TOL = 1e-5
LM_SPREAD_FACTOR = 32.0
LM_SPREAD_DRAWS = 3
#: launches of the full LM that must each repeat the first to the bit (a race
#: on the kernel's shared memory would show as a run that differs)
LM_REPEATS = 32
#: the two scoring calls of a step, in their order
SCORE_CALLS = ("hypotheses", "refit")
#: how far from its limit (ulps of the limit) a tested value of the plain
#: version may lie where the kernel's decision differs: the two evaluate the
#: same chain in the same order, so a differing value is an ulp or two off
SCORE_FLIP_ULPS = 8
#: launches of the scoring that must each repeat the first to the bit
SCORE_REPEATS = 16
#: plane frames the graph phase runs eagerly and as a CUDA graph, and the
#: replays it profiles
GRAPH_FRAMES = 30
PROFILED_REPLAYS = 4
#: the runner's default BA and pose-graph iterations, which the backend_graph
#: phase solves with, and the calls it times each way
BA_ITERATIONS = 8
GRAPH_ITERATIONS = 10
BACKEND_REPS = 6


def _say(phase: str, **fields):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _lk_kwargs(cam, det):
    return dict(levels=det.optical_flow_pyramid_depth,
                win_h=cam.height // det.optical_flow_window_height,
                win_w=cam.width // det.optical_flow_window_width,
                iterations=det.optical_flow_iterations, eps=det.optical_flow_eps_px,
                coarse_win=det.optical_flow_coarse_window_px,
                coarse_from_level=det.optical_flow_coarse_from_level)


def _median_ms(fn, reps: int = 20) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_launch_us(fn, launches: int = 50, replays: int = 9) -> float:
    """Device time of one ``fn()`` in microseconds that the host cannot bound:
    ``launches`` calls are captured into one ``torch.cuda.CUDAGraph``, the graph
    is replayed ``replays`` times between two CUDA events, and the median replay
    is divided by ``launches``.  It includes the gap the card leaves between two
    kernels of a graph.  ``fn`` launches on the current stream and reads nothing
    back; its inputs stay in L2 between launches when they fit."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm up off the default stream before capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / launches)
    return statistics.median(times)


def ptxas_usage(log: str):
    """{kernel: registers, spill bytes} from what ``nvcc -Xptxas -v`` printed."""
    usage = {}
    for name, body in re.findall(
            r"Function properties for (\w+)\n(.*?)(?=ptxas info\s*: Compiling|\Z)", log,
            flags=re.S):
        kernel = re.search(r"(?:lk_\w+|components|cells_\w+|cylinders|lm_solve|line_grow)"
                           r"_kernel(?:_warp)?", name)
        regs = re.search(r"Used (\d+) registers", body)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", body)
        if kernel and regs and spills:
            usage[kernel.group(0)] = {"registers": int(regs.group(1)),
                                      "spill_store_bytes": int(spills.group(1)),
                                      "spill_load_bytes": int(spills.group(2))}
    return usage


def _room_pair(cam, device):
    scene = synthetic.RoomScene(cam)
    (g0, _), (g1, _) = [scene.render(q, p)
                        for q, p in synthetic.orbit_trajectory(2, speed_mm=8.0)]
    return torch.as_tensor(g0, device=device), torch.as_tensor(g1, device=device)


def _fast_points(gray, n):
    pts, _, valid = fast.detect_fast_grid(gray, max_points=n)
    if not bool(valid.all()):
        raise RuntimeError(f"FAST gave {int(valid.sum())} of {valid.numel()} points")
    return pts, valid


def _compare(name, k_pts, k_ok, r_pts, r_ok, excused=None, min_both=64):
    """Max |kernel - plain| over rows both mark ok; flags must agree except on
    ``excused`` rows.  Raises on a disagreement."""
    both = k_ok & r_ok
    n_both = int(both.sum())
    err = float((k_pts - r_pts)[both].abs().max()) if n_both else float("nan")
    differ = k_ok != r_ok
    if excused is not None:
        differ = differ & ~excused
    flags_differ = int(differ.sum())
    if not (torch.isfinite(k_pts).all() and n_both >= min_both and err <= TOL_PX
            and flags_differ == 0):
        raise RuntimeError(f"{name} kernel disagrees with its plain version: max |d|={err}"
                           f" px on {n_both} rows, {flags_differ} flags differ")
    return err, n_both


@dataclasses.dataclass
class KernelCase:
    """One kernel at the main path's shapes: how to launch it, its plain
    version, the work these inputs need, the rows excused from flag equality
    (None: none) and, for the restage case, the guesses it starts from."""
    name: str
    points: int
    kernel: Callable
    plain: Callable
    work: Callable
    excused: Callable | None = None
    guesses: torch.Tensor | None = None


def kernel_cases(cam, cfg, device):
    """The three LK kernels at the main path's shapes, and the restage case."""
    g0, g1 = _room_pair(cam, device)
    kw = _lk_kwargs(cam, cfg.detection)
    p0 = image.build_pyramid(g0, kw["levels"])
    p1 = image.build_pyramid(g1, kw["levels"])
    det = cfg.detection
    bwd = dict(max_roundtrip=det.optical_flow_roundtrip_px,
               bwd_levels=(None if det.optical_flow_backward_depth >= kw["levels"]
                           else det.optical_flow_backward_depth))
    # fused forward-backward, 128 points (the default tracked set)
    pts, valid = _fast_points(g0, cfg.mapping.max_tracked_points)

    def near_gate(r_pts):
        rt = lk_cuda.roundtrip_px_reference(p0, p1, pts, r_pts,
                                            bwd_levels=bwd["bwd_levels"], **kw)
        return (rt - bwd["max_roundtrip"]).abs() <= TOL_PX

    cases = [KernelCase(
        "lk_fwd_bwd", pts.shape[0],
        lambda: lk_cuda.lk_fwd_bwd(p0, p1, pts, valid, **kw, **bwd),
        lambda: lk_cuda.lk_fwd_bwd_reference(p0, p1, pts, valid, **kw, **bwd),
        lambda: lk_cuda.lk_work(p0, p1, pts, valid, backward=True,
                                bwd_levels=bwd["bwd_levels"], **kw),
        excused=near_gate)]
    # forward-only, at the forward-only path's tracked count
    pts99, valid99 = _fast_points(g0, FORWARD_ONLY_TRACKED)
    cases.append(KernelCase(
        "lk_pyramid", pts99.shape[0],
        lambda: lk_cuda.lk_pyramid(p0, p1, pts99, valid99, **kw),
        lambda: lk_cuda.lk_pyramid_reference(p0, p1, pts99, valid99, **kw),
        lambda: lk_cuda.lk_work(p0, p1, pts99, valid99, backward=False, **kw)))
    # single level 0 from the plain tracker's level-1 result doubled
    g_flow, _ = lk_cuda.lk_pyramid_reference(p0[1:], p1[1:], (pts99 * 0.5).contiguous(),
                                             valid99, **{**kw, "levels": kw["levels"] - 1})
    guesses = (g_flow * 2.0).contiguous()
    lvl = dict(win_h=kw["win_h"], win_w=kw["win_w"], iterations=kw["iterations"],
               eps=kw["eps"])
    cases.append(KernelCase(
        "lk_level", pts99.shape[0],
        lambda: lk_cuda.lk_level(p0[0], p1[0], pts99, guesses, valid99, **lvl),
        lambda: lk_cuda.lk_level_reference(p0[0], p1[0], pts99, guesses, valid99, **lvl),
        lambda: lk_cuda.lk_level_work(p0[0], p1[0], pts99, guesses, valid99, **lvl)))
    # the same level from guesses 9-11 px off on each axis, signs seeded, with
    # the iterations it takes most rows to come back
    rng = np.random.default_rng(SEED)
    off = (rng.uniform(STAGED_MARGIN_PX + 1, STAGED_MARGIN_PX + 3, guesses.shape)
           * rng.choice([-1.0, 1.0], guesses.shape)).astype(np.float32)
    far = (guesses + torch.as_tensor(off, device=device)).contiguous()
    long = {**lvl, "iterations": 30}
    cases.append(KernelCase(
        "lk_level_restage", pts99.shape[0],
        lambda: lk_cuda.lk_level(p0[0], p1[0], pts99, far, valid99, **long),
        lambda: lk_cuda.lk_level_reference(p0[0], p1[0], pts99, far, valid99, **long),
        lambda: lk_cuda.lk_level_work(p0[0], p1[0], pts99, far, valid99, **long),
        guesses=far))
    return cases


def check_case(case, min_both=64):
    """The kernel against its plain version.  Returns (max_abs_err, rows both
    mark ok, flags that differ (all on excused rows), the plain values)."""
    k_val, k_ok = case.kernel()
    torch.cuda.synchronize()
    r_val, r_ok = case.plain()
    excused = case.excused(r_val) if case.excused else None
    err, n_both = _compare(case.name, k_val, k_ok, r_val, r_ok, excused=excused,
                           min_both=min_both)
    return err, n_both, int((k_ok != r_ok).sum()), r_val


def bound_of(work):
    """(bound_ms, bound_by) of a work count: the larger of its FLOPs over the f32
    peak and its bytes over the memory rate."""
    by_ops = work["flops"] / PEAK_F32_FLOPS * 1e3
    by_bytes = work["bytes"] / PEAK_BYTES_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def check_kernels(cam, cfg, device):
    """Phase 3: each LK kernel against its plain version at the main path's
    shapes, the restage check, then the times and bounds.  Returns {name: dict
    of the kernel line's measured fields}."""
    results = {}
    for case in kernel_cases(cam, cfg, device):
        err, n_both, flag_diffs, r_val = check_case(case)
        if case.guesses is not None:
            # a row whose result lies further down or up from its guess than the
            # margin has left the tile staged around that guess (sideways the
            # tile may be up to 3 px wider: it is copied in 16-byte columns)
            moved = int(((r_val - case.guesses)[:, 1].abs() > STAGED_MARGIN_PX + 1).sum())
            _say("kernel", name=case.name, points=case.points, both_ok=n_both,
                 moved_past_margin=moved, max_abs_err_px=err, tol_px=TOL_PX)
            if moved < 32:
                raise RuntimeError(f"restage check: only {moved} rows left their tile")
            continue
        work = case.work()
        bound_ms, bound_by = bound_of(work)
        results[case.name] = dict(
            max_abs_err=err, ms=_median_ms(case.kernel), plain_ms=_median_ms(case.plain),
            device_us=graph_launch_us(case.kernel), bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None)
        _say("kernel", name=case.name, points=case.points, both_ok=n_both,
             near_gate_flag_diffs=flag_diffs, max_abs_err_px=err, tol_px=TOL_PX,
             iterations=work["iterations"], longest_chain=work["longest_chain"],
             mflop=work["flops"] / 1e6, mbytes=work["bytes"] / 1e6,
             **{k: results[case.name][k] for k in ("ms", "plain_ms", "device_us",
                                                   "bound_ms", "bound_by")})
    return results


def cell_graph(cam, cfg, depth, device):
    """(edges, planar, gh, gw): the cell graph ``find_primitives`` builds from
    a depth map, the components kernel's input."""
    det = cfg.detection
    gh, gw = cam.height // det.depth_patch_size_px, cam.width // det.depth_patch_size_px
    cloud, valid = depth_to_cloud(torch.as_tensor(depth, device=device), cam)
    grid = primitives.fit_cells(cloud, valid, det)
    edges = primitives._edge_maps(grid, gh, gw,
                                  math.cos(math.radians(det.max_plane_merge_angle_d)))
    return edges.contiguous(), grid.planar.contiguous(), gh, gw


def serpentine_grid(gh, gw):
    """(edges [4, gh, gw], planar [C]) numpy bool of one component that snakes
    through the grid a row at a time, every cell planar: the longest chain of
    row runs."""
    snake = np.zeros((4, gh, gw), bool)
    snake[0, :, 1:] = True
    for y in range(gh - 1):
        snake[2, y + 1, gw - 1 if y % 2 == 0 else 0] = True
    return snake, np.ones(gh * gw, bool)


def _join(edges, p, q, k):
    """Set one of the two directed edges that make the symmetric edge between
    neighbouring cells p and q, (y, x) each (the ``k``-th's parity picks)."""
    (y, x), (v, u) = sorted([p, q])
    if v == y:   # q right of p: right (y, x) = e0[y, x+1] or e1[y, x]
        edges[(0, y, u) if k % 2 else (1, y, x)] = True
    else:        # below: down (y, x) = e2[y+1, x] or e3[y, x]
        edges[(2, v, x) if k % 2 else (3, y, x)] = True


def spiral_grid(gh, gw):
    """(edges, planar) of a one-cell-wide path that spirals in from the
    corner through every cell, right, down, left and up by turns, cut in two
    by one non-planar cell half-way: the longest chains a grid holds, over
    runs of both kinds."""
    order, top, bottom, left, right = [], 0, gh - 1, 0, gw - 1
    while top <= bottom and left <= right:
        order += [(top, x) for x in range(left, right + 1)]
        order += [(y, right) for y in range(top + 1, bottom + 1)]
        if top < bottom:
            order += [(bottom, x) for x in range(right - 1, left - 1, -1)]
        if left < right:
            order += [(y, left) for y in range(bottom - 1, top, -1)]
        top, bottom, left, right = top + 1, bottom - 1, left + 1, right - 1
    edges = np.zeros((4, gh, gw), bool)
    for k, (p, q) in enumerate(zip(order, order[1:])):
        _join(edges, p, q, k)
    planar = np.ones(gh * gw, bool)
    y, x = order[len(order) // 2]
    planar[y * gw + x] = False
    return edges, planar


def random_grid(gh, gw, seed, planar_ends=True):
    """(edges, planar) drawn from ``seed``: 70% of the cells planar, 60% of
    the directed edges set; with ``planar_ends`` only those into a planar cell
    (an edge's destination, as ``_edge_maps`` gives), else any (an edge may
    join a non-planar cell at either end, which must join nothing)."""
    rng = np.random.default_rng(seed)
    planar = rng.random(gh * gw) < 0.7
    edges = rng.random((4, gh, gw)) < 0.6
    if planar_ends:
        edges &= planar.reshape(gh, gw)[None]
    return edges, planar


def random_line_graph(gh, gw, seed, density, line_share=0.7, weight_levels=None):
    """(edges [8, gh, gw], is_line [T], weight [T] float32) numpy drawn from
    ``seed``, as ``lines._line_edge_maps`` and ``_tile_stats`` give them: a
    ``line_share`` of the tiles line tiles, a ``density`` share of the
    directed edges between two line tiles set, none across the border; line
    tiles weigh over 0, drawn from ``weight_levels`` whole numbers when given
    (many equal weights), and the other tiles anything."""
    rng = np.random.default_rng(seed)
    is_line = rng.random(gh * gw) < line_share
    ok = is_line.reshape(gh, gw)
    edges = np.zeros((8, gh, gw), bool)
    for s, (dy, dx) in enumerate(line_grow_cuda.SHIFTS):
        e = (rng.random((gh, gw)) < density) & ok & np.roll(ok, (dy, dx), (0, 1))
        e[:, 0] &= dx != 1
        e[:, -1] &= dx != -1
        e[0, :] &= dy != 1
        e[-1, :] &= dy != -1
        edges[s] = e
    if weight_levels:
        weight = rng.integers(1, weight_levels + 1, gh * gw).astype(np.float32)
    else:
        weight = rng.uniform(1.0, 5000.0, gh * gw).astype(np.float32)
    weight[~is_line] = rng.uniform(-5.0, 5000.0, int((~is_line).sum()))
    return edges, is_line, weight


def line_graph(gray, device):
    """(edges, is_line, weight) on ``device``: the tile graph ``detect_lines``
    builds from a gray image with its default gates, the line growth
    kernel's input."""
    grid, gh, gw = lines._tile_stats(torch.as_tensor(gray, device=device), 15.0, 0.06, 0.7)
    edges, _ = lines._line_edge_maps(grid, gh, gw, math.cos(math.radians(25.0)), 6.0)
    return edges, grid.is_line, grid.weight


def grid_tensors(grid, device):
    """(edges, planar, gh, gw) on ``device`` of a numpy (edges, planar)."""
    edges, planar = grid
    return (torch.as_tensor(edges, device=device), torch.as_tensor(planar, device=device),
            *edges.shape[1:])


def components_cases(cam, cfg, device):
    """(name, edges, planar, gh, gw) of the components kernel's checks: the
    cell graph ``find_primitives`` builds from a 640x480 RoomScene depth map
    (the main path's input), a serpentine one-cell-wide component through the
    same grid (the longest chain of row runs), the grid in one component, a
    spiral through it cut in two (long chains with turns every way), a random
    grid whose edges may join non-planar cells at either end (they must join
    nothing), and the cell graph of the same depth map at 16 px cells (40x30:
    more cells than a CTA's threads)."""
    depth = room_frames(cam, 1)[0][0][1]
    edges, planar, gh, gw = cell_graph(cam, cfg, depth, device)
    ones = torch.ones(gh * gw, dtype=torch.bool, device=device)
    cfg16 = dataclasses.replace(cfg, detection=dataclasses.replace(cfg.detection,
                                                                   depth_patch_size_px=16))
    return [("room_frame", edges, planar, gh, gw),
            ("serpentine", *grid_tensors(serpentine_grid(gh, gw), device)),
            ("one_component", torch.ones((4, gh, gw), dtype=torch.bool, device=device), ones,
             gh, gw),
            ("spiral", *grid_tensors(spiral_grid(gh, gw), device)),
            ("random_non_planar_ends",
             *grid_tensors(random_grid(gh, gw, SEED, planar_ends=False), device)),
            ("room_frame_16px", *cell_graph(cam, cfg16, depth, device))]


def check_components(cam, cfg, device, frames):
    """The components kernel against its plain version (labels must be equal)
    on each case; the main path's case is then timed as the LK kernels are.
    The bound counts bytes (edges and planar mask read once, int64 labels
    written once) over 3.35 TB/s and 12 integer operations a planar cell a
    round of the JAX loop, these inputs' rounds, over 67 T/s (the card's rate
    outside the tensor cores; the published table gives no int32 rate).  No
    PyTorch call computes connected components: ``library_ms`` is null.
    Printed beside them: the JAX loop's rounds on the cell graph of each of
    the plane path's ``frames``, the card's floor for one graph node, the
    device time of a kernel that reads the clock once and returns
    (``torch.cuda._sleep(0)``) replayed from a graph of 50, and the kernel's
    device time on the serpentine, whose rows the first design crossed one
    cell a round."""
    rounds = [components_cuda.components_work(*cell_graph(cam, cfg, depth, device))["rounds"]
              for _, depth in frames]
    _say("components", frames=len(rounds), jax_loop_rounds_min=min(rounds),
         jax_loop_rounds_median=statistics.median(rounds), jax_loop_rounds_max=max(rounds),
         empty_kernel_graph_us=graph_launch_us(lambda: torch.cuda._sleep(0)))
    result = None
    for name, edges, planar, gh, gw in components_cases(cam, cfg, device):
        got = components_cuda.connected_components(edges, planar, gh, gw)
        torch.cuda.synchronize()
        want = components_cuda.components_reference(edges, planar, gh, gw)
        differ = int((got != want).sum())
        work = components_cuda.components_work(edges, planar, gh, gw)
        fields = dict(name=name, grid=f"{gw}x{gh}", planar_cells=work["planar_cells"],
                      components=int(torch.unique(want[planar]).numel()),
                      jax_loop_rounds=work["rounds"], labels_that_differ=differ)
        if differ:
            _say("kernel", **fields)
            raise RuntimeError(f"components kernel disagrees with its plain version on {name}")
        if result is None:
            by_ops = work["ops"] / PEAK_F32_FLOPS * 1e3
            by_bytes = work["bytes"] / PEAK_BYTES_PER_S * 1e3
            result = dict(
                max_abs_err=0.0,
                ms=_median_ms(lambda: components_cuda.connected_components(edges, planar, gh,
                                                                           gw)),
                plain_ms=_median_ms(lambda: components_cuda.components_reference(
                    edges, planar, gh, gw)),
                device_us=graph_launch_us(
                    lambda: components_cuda.connected_components(edges, planar, gh, gw)),
                bound_ms=max(by_ops, by_bytes),
                bound_by="operations" if by_ops >= by_bytes else "bytes", library_ms=None)
            fields.update(bytes=work["bytes"], int_ops=work["ops"],
                          **{k: result[k] for k in ("ms", "plain_ms", "device_us", "bound_ms",
                                                    "bound_by")})
        elif name == "serpentine":
            fields["device_us"] = graph_launch_us(
                lambda: components_cuda.connected_components(edges, planar, gh, gw))
        _say("kernel", **fields)
    return result


#: 240x320 images of straight lines drawn on a flat gray (the line tests'
#: images): name -> [(x0, y0), (x1, y1)] of each line
DRAWN_LINES = {"horizontal": [((40, 120), (280, 120))], "diagonal": [((50, 50), (250, 200))],
               "two_lines": [((30, 60), (290, 60)), ((160, 20), (160, 220))], "flat": []}


def drawn_lines_image(name):
    """A 240x320 float32 image of ``DRAWN_LINES[name]``: 2 px lines of value
    200 on 50 (100 for the flat one)."""
    img = np.full((240, 320), 100.0 if name == "flat" else 50.0, np.float32)
    for (x0, y0), (x1, y1) in DRAWN_LINES[name]:
        for t in np.linspace(0, 1, max(int(np.hypot(x1 - x0, y1 - y0)) * 2, 2)):
            xi, yi = int(round(x0 + t * (x1 - x0))), int(round(y0 + t * (y1 - y0)))
            img[max(yi - 1, 0): yi + 2, max(xi - 1, 0): xi + 2] = 200.0
    return img


def stripe_wall_frames(cam, n):
    """The first ``n`` frames of the ``lines_lowtex`` path's low-texture
    striped wall (the cell ``fr1_lines.stripe_wall``'s scene) on the lateral
    run, and their ground-truth positions."""
    wall = synthetic.StripeWallScene(cam, texture_scale=0.03, stripe_period_z=2400.0)
    poses = synthetic.lateral_trajectory(JAX_REFERENCE["lines_lowtex"]["frames"],
                                         speed_mm=4.0)[:n]
    return ([wall.render(q, p) for q, p in poses],
            np.stack([p for _, p in poses]).astype(np.float64))


def line_grow_cases(cam, device):
    """(name, edges, is_line, weight) of the line growth kernel's checks: the
    tile graphs of striped-wall frames 3, 15 and 29 (the main case first) and
    of a room frame, the drawn-lines images and noise at 240x320, and random
    graphs: a maze at 40x30 (long winding paths), the full 40x30 grid (one
    seed takes it all), equal weights, a sparse 7x5, one column of 70 and
    1920x1080's 120x67 (past the 48 KB of shared memory a CTA gets without
    the opt-in, three chunks of 32 rows)."""
    walls = stripe_wall_frames(cam, 30)[0]
    room = room_frames(cam, 1)[0][0][0]
    noise = np.random.default_rng(1000).uniform(0, 255, (240, 320)).astype(np.float32)
    cases = [(f"stripe_wall{i}", *line_graph(walls[i][0], device)) for i in (3, 15, 29)]
    cases.append(("room0", *line_graph(room, device)))
    cases += [(name, *line_graph(drawn_lines_image(name), device)) for name in DRAWN_LINES]
    cases.append(("noise", *line_graph(noise, device)))
    for name, (gh, gw, density, kw) in {
            "maze_40x30": (30, 40, 0.45, {}), "full_40x30": (30, 40, 1.0, {"line_share": 1.0}),
            "equal_weights_40x30": (30, 40, 0.45, {"weight_levels": 3}),
            "sparse_7x5": (5, 7, 0.1, {}), "column_1x70": (70, 1, 0.8, {}),
            "maze_120x67": (67, 120, 0.45, {})}.items():
        graph = random_line_graph(gh, gw, SEED, density, **kw)
        cases.append((name, *(torch.as_tensor(x, device=device) for x in graph)))
    return cases


def _device_ops(fn):
    """The names of the device operations ``fn()`` runs, under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def line_grow_in_graph_us(cam, cfg, device, n_frames=16, profiled=8):
    """The line growth kernel where the main path runs it: inside the points +
    lines step's CUDA graph (``StepGraph``, planes off) over the striped
    wall's first ``n_frames`` frames, the last ``profiled`` under the
    profiler, with the step's other kernels around it (as
    ``tools/profile_plane_kernels.in_graph_step_us`` times the plane
    kernels): its device µs and launches a frame, and the step's matrix
    products a frame (the pose's and the maps' small ones)."""
    staged = runner.stage_frames(stripe_wall_frames(cam, n_frames)[0], device=device)
    graph = step_graph.StepGraph(engine.init_state(cam, cfg, seed=SEED, device=device), cam,
                                 cfg, with_planes=False, with_lines=True)
    try:
        for gray, depth in staged[:-profiled]:
            graph.step(gray, depth)
        torch.cuda.synchronize()
        ops = _device_ops(lambda: [graph.step(gray, depth) for gray, depth in staged[-profiled:]])
    finally:
        graph.close()
    mark = LAUNCH_MARKS["line_grow"]
    return dict(us=sum(us for name, us in ops if name.startswith(mark)) / profiled,
                launches=sum(name.startswith(mark) for name, _ in ops) / profiled,
                step_gemms=sum("gemm" in name for name, _ in ops) / profiled)


def check_line_grow(cam, cfg, device):
    """The line growth kernel against its plain version on each case of
    ``line_grow_cases`` (members and proceed equal, min_tiles 2 and 3, the
    closure rows and the loop), each case's rounds a seed printed; the main
    case (striped-wall frame 3) then timed as the other kernels are, and
    inside the lines step's graph, where it must run once a frame; the matrix
    products ``detect_lines`` runs on its frame are printed (the moments'
    einsum).  The bound
    counts bytes (the eight edge planes, is_line and the weights read once,
    the member rows written once, ``grow_work``) over 3.35 TB/s.  No PyTorch
    call computes it: ``library_ms`` is null."""
    result = None
    for name, edges, is_line, weight in line_grow_cases(cam, device):
        fields = dict(name=name, grid=f"{edges.shape[2]}x{edges.shape[1]}",
                      line_tiles=int(is_line.sum()))
        for min_tiles in (2, 3):
            members, proceed, rounds = line_grow_cuda.grow_seeds_cuda(edges, is_line, weight,
                                                                      min_tiles, details=True)
            torch.cuda.synchronize()
            want_m, want_p = line_grow_cuda.grow_seeds_reference(edges, is_line, weight,
                                                                 min_tiles)
            differ = int((members != want_m).sum()) + int((proceed != want_p).sum())
            fields[f"min_tiles_{min_tiles}"] = dict(
                seeds=int(proceed.sum()), members=members.sum(dim=1).tolist(),
                rounds=rounds.tolist(), differ=differ)
            if differ:
                _say("kernel", **fields)
                raise RuntimeError(f"line growth kernel disagrees with its plain version on "
                                   f"{name}, min_tiles {min_tiles}")
        if result is None:
            gh, gw = edges.shape[1:]
            work = line_grow_cuda.grow_work(gh, gw)

            def grow():
                return line_grow_cuda.grow_seeds_cuda(edges, is_line, weight, 2)

            result = dict(
                max_abs_err=0.0, ms=_median_ms(grow),
                plain_ms=_median_ms(lambda: line_grow_cuda.grow_seeds_reference(
                    edges, is_line, weight, 2)),
                device_us=graph_launch_us(grow),
                bound_ms=work["bytes"] / PEAK_BYTES_PER_S * 1e3, bound_by="bytes",
                library_ms=None)
            in_graph = line_grow_in_graph_us(cam, cfg, device)
            result["in_graph_us_a_frame"] = in_graph["us"]
            gray = torch.as_tensor(stripe_wall_frames(cam, 4)[0][3][0], device=device)
            fields.update(bytes=work["bytes"], in_graph=in_graph, detect_lines_gemms=[
                name for name, _ in _device_ops(lambda: lines.detect_lines(gray))
                if "gemm" in name],
                **{k: result[k] for k in ("ms", "plain_ms", "device_us", "bound_ms")})
            if in_graph["launches"] != 1:
                _say("kernel", **fields)
                raise RuntimeError(f"the lines step's graph ran {in_graph['launches']} line "
                                   "growth launches a frame")
        _say("kernel", **fields)
    return result


#: the cells phase's tolerances, float32 on both sides.  The kernel sums a
#: cell's 400 points in another order than the plain version: a sum of n
#: terms in two orders differs by at most n ulps of their magnitudes, 400 x
#: 6e-8 = 2.4e-5 (CELL_SUM_RTOL: the means, of the cell's largest |mean|; the
#: second moments, of the cell's largest diagonal entry, CELL_M2_RTOL).  The
#: closed-form eig3 takes its angle from acos(r), r = det((A - qI) / p) / 2,
#: which a change dr moves by dr / sqrt(1 - r^2), or sqrt(2 dr) near r = +-1
#: (two equal eigenvalues, as a square plane patch has): an eigenvalue may
#: then move by 2 p / 3 times that.  dr is CELL_R_ULPS ulps (r is some 30
#: roundings from A) plus what the two versions' moment difference moves it,
#: 3 max|dA| / p.  So the eigenvalues (mse x count and score x the smallest)
#: are held to CELL_EIG_RTOL of the largest plus that swing; on cells planar
#: in both, the normal to CELL_NORMAL_TOL plus the smallest eigenvalue's
#: tolerance over its gap to the next (sign included), and d to CELL_D_RTOL
#: |d| + CELL_D_ATOL_MM plus the normal's tolerance times |mean|.  A discrete
#: output may differ only where the plain version's margin to its gate is
#: inside what those errors move: planar (mse against the squared depth
#: quantization) within the mse's tolerance; a normal bin where the plain
#: bin coordinate lies within CELL_BIN_TOL plus what the normal's tolerance
#: moves it of a bin edge; an edge where planar flipped at either end, or its
#: cos within CELL_COS_TOL plus both normals' tolerances of the threshold, or
#: its distance within what the normal, d and mean tolerances move it of the
#: cell's distance tolerance.
CELL_SUM_RTOL = 3e-5
CELL_M2_RTOL = 1e-4
CELL_R_ULPS = 32
CELL_EIG_RTOL = 1e-4
CELL_NORMAL_TOL = 1e-4
CELL_D_RTOL = 1e-4
CELL_D_ATOL_MM = 1e-2
CELL_BIN_TOL = 1e-3
CELL_COS_TOL = 2e-4
#: the cylinders phase's tolerances.  The axis gate's score (the largest
#: over the smallest eigenvalue of a region's normal outer products) to
#: CYL_SCORE_RTOL of the threshold.  The axis of a region that holds a slot
#: (sign included) to CYL_AXIS_TOL plus the smallest eigenvalue's closed-form
#: tolerance (``eig3_tolerance``, the outer products summed in two orders:
#: count^2 ulps) over its gap to the next, or its opposite where the plain
#: eig3's row choice sits within CYL_SCORE_RTOL of a tie.  A region of two
#: or three planes has nearly equal small eigenvalues, and there the axes of
#: the two versions part: so each sub-segment is held to the plain MSAC
#: (``_fit_cylinder``) run from the kernel's own axis.  Its centre and radius
#: to CYL_ATOL_MM + CYL_RTOL x radius / |a|, a = 1 - |sum n|^2 / k^2 the LLS
#: fit's denominator (sums of up to 768 cells in two orders: 768 x 6e-8 =
#: 4.6e-5 of the sums, which the division by a scales up:
#: ``lls_length_tolerance``), and its MSE to what moving the centre and the
#: radius that far moves it.  A round whose valid flag or inliers differ must
#: be one the plain version's float32 error could take (``subsegment_flip``):
#: each distance of its expanded form carries CYL_D2_ULPS ulps of its six
#: terms' magnitudes over r^2, and a score the sum of those; some hypothesis
#: that gives the kernel's inliers (but for cells within their bound of the
#: threshold) must score within the two bounds of the best.  The later rounds
#: of that region start from other cells: printed, not compared.
CYL_SCORE_RTOL = 1e-3
CYL_AXIS_TOL = 1e-4
CYL_ATOL_MM = 1e-2
CYL_RTOL = 5e-5
CYL_D2_ULPS = 16
F32_EPS = float(np.finfo(np.float32).eps)
#: the depth maps the cells and cylinders phases time, by kind: the first
#: RoomScene orbit frame of the plane path whose cylinder stage holds no live
#: region, the first that holds two, and the first frame of the tunnel leg,
#: which holds one (``tools/profile_plane_kernels.py`` times the same)
TIMED_FRAMES = {"room_none": ("room", 0), "room_two": ("room", 15),
                "tunnel_one": ("tunnel", 0)}
#: the first 16 hex digits of the sha256 (``output_digest``) of the two
#: kernels' outputs on those frames as the first design of the kernels (commit
#: adec76e) wrote them, and of their inputs there: the depth map and what
#: ``find_primitives`` gives the cylinder stage (``tools/profile_plane_kernels.py
#: time`` on that commit; NVIDIA H100 80GB HBM3).  Every sum keeps its order in
#: the redesign, so the same inputs must give these bits (``held_bits``)
HELD_BITS = {
    "room_none": {"cells_inputs": "1f4371867413a745", "cells": "9e66dddd490c5501",
                  "cylinders_inputs": "1f8988f5702a5999", "cylinders": "4b30b3ad3923410a"},
    "room_two": {"cells_inputs": "f99a465333480820", "cells": "dfcf108f8eabb4a7",
                 "cylinders_inputs": "d0972cc4135e26ae", "cylinders": "a97aa22a467f4a46"},
    "tunnel_one": {"cells_inputs": "142cac8f5b194c6b", "cells": "34e9c4a3d33df923",
                   "cylinders_inputs": "6b42a260add916b6", "cylinders": "d097ff90e65c69b6"},
}


def output_digest(tensors) -> str:
    """The first 16 hex digits of the sha256 of ``tensors``' bytes, in order."""
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def held_bits(kind, kernel, inputs_bits, bits):
    """Whether ``kernel``'s outputs (digest ``bits``) on the ``kind`` frame of
    ``TIMED_FRAMES`` equal the first design's: True, or None where its inputs
    (digest ``inputs_bits``) are not the ones the first design saw, so there is
    nothing to compare; raises where the inputs are the same and the outputs
    are not."""
    held = HELD_BITS[kind]
    if inputs_bits != held[f"{kernel}_inputs"]:
        return None
    if bits != held[kernel]:
        raise RuntimeError(f"{kernel} on {kind}: outputs {bits} on the first design's inputs, "
                           f"where it wrote {held[kernel]}: the bits moved")
    return True


def timed_depths(frames, tunnel_depths, device):
    """{kind: depth on the card} of ``TIMED_FRAMES``."""
    by_kind = {"room": [d for _, d in frames], "tunnel": tunnel_depths}
    return {kind: torch.as_tensor(by_kind[src][i], device=device)
            for kind, (src, i) in TIMED_FRAMES.items()}


def _tunnel_depths(cam, n):
    """Depth maps of the tunnel leg's first ``n`` frames, where cylinders live."""
    frames, _ = tunnel_flight(cam, n)
    return [depth for _, depth in frames]


def eig3_tolerance(a, da):
    """How far the float32 closed-form eig3 may move the eigenvalues of the
    symmetric [..., 3, 3] float64 matrices ``a`` whose two versions differ by
    ``da`` (max |entry| a matrix): ``CELL_EIG_RTOL`` of the largest plus the
    acos swing of ``CELL_R_ULPS`` ulps and 3 da / p in r (see ``CELL_*``)."""
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    q = a.diagonal(dim1=-2, dim2=-1).sum(-1) / 3.0
    centred = a - q[..., None, None] * eye
    p = torch.sqrt((centred * centred).sum((-2, -1)) / 6.0).clamp_min(1e-30)
    r = (torch.linalg.det(centred / p[..., None, None]) / 2.0).clamp(-1.0, 1.0)
    dr = CELL_R_ULPS * F32_EPS + 3.0 * da / p
    dphi = torch.minimum(dr / torch.sqrt((1.0 - r * r).clamp_min(1e-300)),
                         torch.sqrt(2.0 * dr)) / 3.0
    lam = torch.linalg.eigvalsh(a)
    return CELL_EIG_RTOL * lam.abs().amax(-1) + 2.0 * p * dphi + 1e-9, lam


def check_cells_frame(depth, cam, det, name="frame"):
    """The cells kernel against its plain version on one depth map: every
    continuous field within its tolerance, every discrete one equal or
    flipped inside its gate's margin (``CELL_*``).  Returns (max errors,
    flips: one dict each, printed by the caller); raises on anything else."""
    got = cells_cuda.cell_pass(depth, cam, det)
    want = cells_cuda.cells_reference(depth, cam, det)
    torch.cuda.synchronize()
    gh, gw = cells_cuda.grid_shape(depth, det)
    problems, flips, err = [], [], {}
    g = {k: v.double() if v.dtype == torch.float32 else v for k, v in got._asdict().items()}
    w = {k: v.double() if v.dtype == torch.float32 else v for k, v in want._asdict().items()}

    def held(field, diff, tol, where=None):
        if where is not None:
            diff = diff[where]
            tol = tol[where] if torch.is_tensor(tol) and tol.dim() else tol
        err[field] = float(diff.max()) if diff.numel() else 0.0
        bad = ~(diff <= tol)
        if bool(bad.any()):
            problems.append(f"{field}: {int(bad.sum())} entries out of tolerance, max "
                            f"{err[field]}")

    for field in ("count", "centers_valid"):
        if not torch.equal(got._asdict()[field], want._asdict()[field]):
            problems.append(f"{field} differs")
    held("centers", (g["centers"] - w["centers"]).abs(), 1e-6 * w["centers"].abs() + 1e-4)
    d_mean = (g["mean"] - w["mean"]).abs().amax(-1)
    held("mean", d_mean, CELL_SUM_RTOL * w["mean"].abs().amax(-1) + 1e-4)
    diag = w["m2"].diagonal(dim1=-2, dim2=-1).abs().amax(-1)
    d_m2 = (g["m2"] - w["m2"]).abs().amax((-2, -1))
    held("m2", d_m2, CELL_M2_RTOL * diag + 1e-6)
    tol_lam, lam = eig3_tolerance(0.5 * (w["m2"] + w["m2"].transpose(-1, -2)), d_m2)
    safe = w["count"].clamp_min(1.0)
    held("mse", (g["mse"] - w["mse"]).abs(), tol_lam / safe)
    lam1 = [x["score"] * (x["mse"] * safe).clamp_min(1e-6) for x in (g, w)]
    held("eigenvalue_1", (lam1[0] - lam1[1]).abs(), tol_lam)
    tol_n = CELL_NORMAL_TOL + tol_lam / (lam[:, 1] - lam[:, 0]).clamp_min(1e-30)
    mean_norm = w["mean"].norm(dim=-1)
    tol_d = CELL_D_RTOL * w["d"].abs() + CELL_D_ATOL_MM + tol_n * mean_norm
    both = got.planar & want.planar
    held("normal", (g["normal"] - w["normal"]).abs().amax(-1), tol_n, both)
    held("d", (g["d"] - w["d"]).abs(), tol_d, both)
    held("distance_tol", (g["distance_tol"] - w["distance_tol"]).abs(),
         1e-5 * w["distance_tol"] + 1e-4, both)

    # planar: the gate mse <= q(|z|)^2 at the plain version's values
    q = primitives.get_depth_quantization(w["mean"][:, 2].abs())
    planar_flip = got.planar != want.planar
    for i in torch.nonzero(planar_flip).flatten().tolist():
        margin, tol = abs(float(w["mse"][i] - q[i] ** 2)), float(tol_lam[i] / safe[i])
        flips.append(dict(frame=name, output="planar", cell=i, margin=margin, tol=tol,
                          plain=bool(want.planar[i])))
        if not margin <= tol:
            problems.append(f"planar flipped at cell {i}, {margin} from its gate")

    # bins of the cells planar in both: the plain coordinates' distance to an
    # edge, against what the normal's tolerance moves them
    n = w["normal"]
    bins = primitives.HIST_BINS
    u = torch.arccos((-n[:, 2]).clamp(-1.0, 1.0)) / math.pi * bins
    v = (torch.atan2(n[:, 0], n[:, 1]) + math.pi) / (2 * math.pi) * bins
    du = CELL_BIN_TOL + bins / math.pi * tol_n / torch.sqrt((1 - n[:, 2] ** 2).clamp_min(1e-30))
    dv = CELL_BIN_TOL + bins / (2 * math.pi) * tol_n \
        / torch.sqrt((n[:, 0] ** 2 + n[:, 1] ** 2).clamp_min(1e-30))
    for i in torch.nonzero((got.bins != want.bins) & both).flatten().tolist():
        mu, mv = float((u[i] - u[i].round()).abs()), float((v[i] - v[i].round()).abs())
        flips.append(dict(frame=name, output="bin", cell=i, margin_u=mu, tol_u=float(du[i]),
                          margin_v=mv, tol_v=float(dv[i])))
        if not (mu <= float(du[i]) or mv <= float(dv[i])):
            problems.append(f"bin of cell {i} differs, {mu} and {mv} from a bin edge")

    # edges: explained by a planar flip at either end, or a gate within its margin
    if got.edges.shape != (4, gh, gw) or not got.edges.is_contiguous():
        problems.append(f"edges of shape {tuple(got.edges.shape)}")
    cos_max = cells_cuda.merge_angle_cos(det)
    nn_ = n.reshape(gh, gw, 3)
    cen = w["mean"].reshape(gh, gw, 3)
    d_ = w["d"].reshape(gh, gw)
    tol = w["distance_tol"].reshape(gh, gw)
    pf = planar_flip.reshape(gh, gw)
    tn, td = tol_n.reshape(gh, gw), tol_d.reshape(gh, gw)
    tm = (CELL_SUM_RTOL * w["mean"].abs().amax(-1) + 1e-4).reshape(gh, gw)
    for k, (dy, dx) in enumerate(((0, 1), (0, -1), (1, 0), (-1, 0))):
        def rolled(x):
            return torch.roll(x, (dy, dx), dims=(0, 1))
        n_from = rolled(nn_)
        cos_m = ((n_from * nn_).sum(-1) - cos_max).abs()
        cos_tol = CELL_COS_TOL + tn + rolled(tn)
        dot = (n_from * cen).sum(-1)
        dist_m = ((dot + rolled(d_)).abs() - tol).abs()
        dist_tol = rolled(tn) * cen.norm(dim=-1) + rolled(td) + tm + 1e-5 * tol + 1e-4
        explained = pf | rolled(pf)
        for y, x in torch.nonzero(got.edges[k] != want.edges[k]).tolist():
            ok = bool(explained[y, x]) or float(cos_m[y, x]) <= float(cos_tol[y, x]) \
                or float(dist_m[y, x]) <= float(dist_tol[y, x])
            flips.append(dict(frame=name, output=f"edge{k}", cell=y * gw + x,
                              cos_margin=float(cos_m[y, x]), cos_tol=float(cos_tol[y, x]),
                              dist_margin=float(dist_m[y, x]),
                              dist_tol=float(dist_tol[y, x]),
                              planar_flip_at_an_end=bool(explained[y, x])))
            if not ok:
                problems.append(f"edge {k} at ({y}, {x}) differs outside its margins")
    if problems:
        raise RuntimeError(f"cells kernel against its plain version on {name}: "
                           + "; ".join(problems))
    return err, flips


def check_cells(cam, cfg, device, frames, tunnel_depths):
    """Phase ``cells``: the per-cell pass's kernels (``csrc/cells.cu``) against
    the plain version on every depth map of the plane path's ``frames`` and of
    the tunnel leg (``check_cells_frame``), then timed on each of
    ``TIMED_FRAMES`` as the other kernels are (the JSON line's on the room
    frame without a live region, the plane path's first), where its outputs
    must equal the first design's (``held_bits``); the bound counts
    the depth read once and the outputs written once, and
    ``cells_cuda.cells_work``'s float operations.  No PyTorch call computes the
    pass: ``library_ms`` is null."""
    det = cfg.detection
    worst, all_flips = {}, []
    depths = [("room", d) for _, d in frames] + [("tunnel", d) for d in tunnel_depths]
    for i, (kind, depth) in enumerate(depths):
        dep = torch.as_tensor(depth, device=device)
        err, flips = check_cells_frame(dep, cam, det, name=f"{kind}{i}")
        for k, v in err.items():
            worst[k] = max(worst.get(k, 0.0), v)
        all_flips += flips
    for f in all_flips:
        _say("cells_flip", **f)
    timed = timed_depths(frames, tunnel_depths, device)
    by_kind = {}
    for kind, dep in timed.items():
        in_bits = output_digest([dep])
        bits = output_digest(cells_cuda.cell_pass(dep, cam, det))
        by_kind[kind] = dict(
            device_us=graph_launch_us(lambda: cells_cuda.cell_pass(dep, cam, det)),
            bits_equal_first_design=held_bits(kind, "cells", in_bits, bits))
        _say("cells_frame", kind=kind, frame="%s%d" % TIMED_FRAMES[kind],
             inputs_bits=in_bits, bits=bits, **by_kind[kind])
    depth = timed["room_none"]
    work = cells_cuda.cells_work(*depth.shape, det.depth_patch_size_px)
    bound_ms, bound_by = bound_of(work)
    result = dict(
        max_abs_err=worst["normal"],
        ms=_median_ms(lambda: cells_cuda.cell_pass(depth, cam, det)),
        plain_ms=_median_ms(lambda: cells_cuda.cells_reference(depth, cam, det)),
        device_us=by_kind["room_none"]["device_us"],
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    _say("kernel", name="cells", frames=len(depths), flips=len(all_flips),
         **{f"max_err_{k}": v for k, v in worst.items()},
         mflop=work["flops"] / 1e6, mbytes=work["bytes"] / 1e6,
         **{k: result[k] for k in ("ms", "plain_ms", "device_us", "bound_ms", "bound_by")})
    return result


def cylinder_inputs(cam, det, depth):
    """The inputs of the cylinder stage of ``find_primitives`` on one depth map
    on the card: (grid, member, try_cyl, min_activated)."""
    box = {}
    stage = cylinders_cuda.cylinder_stage

    def record(grid, member, try_cyl, cfg, min_activated):
        box["args"] = (grid, member, try_cyl, min_activated)
        return stage(grid, member, try_cyl, cfg, min_activated)

    cylinders_cuda.cylinder_stage = record
    try:
        primitives.find_primitives(depth, cam, det)
    finally:
        cylinders_cuda.cylinder_stage = stage
    return box["args"]


def _eig_row_gap(m):
    """Relative gap between the largest two cross-product norms that
    ``eigenvector_for`` picks its row from, on [..., 3, 3] float64 matrices
    (its smallest eigenvalue's): a sign flip of the eigenvector needs a tie."""
    vals = torch.linalg.eigvalsh(m)
    a = m / m.abs().amax((-2, -1), keepdim=True).clamp_min(1e-30)
    lam = vals[..., 0] / m.abs().amax((-2, -1)).clamp_min(1e-30)
    a = a - lam[..., None, None] * torch.eye(3, dtype=m.dtype, device=m.device)
    r0, r1, r2 = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    norms = torch.stack([torch.linalg.cross(r0, r1), torch.linalg.cross(r0, r2),
                         torch.linalg.cross(r1, r2)], -2).square().sum(-1)
    top = norms.sort(-1, descending=True).values
    return (top[..., 0] - top[..., 1]) / top[..., 0].clamp_min(1e-300)


def msac_round64(grid, axis, remaining, si, n_hyp, trunc):
    """One MSAC round of ``_fit_cylinder`` in float64 from ``remaining`` [C]
    bool: (scores [B], distances [B, C], their float32 error bounds)."""
    mean, normal = grid.mean.double(), grid.normal.double()
    ax = axis.double()
    pc = mean - (mean @ ax)[:, None] * ax
    pn = normal - (normal @ ax)[:, None] * ax
    pn = pn / torch.linalg.vector_norm(pn, dim=-1, keepdim=True).clamp_min(1e-9)
    idx = torch.nonzero(remaining).flatten()
    na = max(int(idx.numel()), 1)
    base = torch.arange(n_hyp * 3, dtype=torch.int64).reshape(n_hyp, 3)
    tri = (((base + si * 7919) * 2654435761) & 0xFFFFFFFF) % na
    cells = idx[tri.to(idx.device)] if idx.numel() else torch.zeros_like(tri, device=idx.device)
    tn, tc = pn[cells], pc[cells]
    sn, sc, snc = tn.sum(1), tc.sum(1), (tn * tc).sum((1, 2))
    a = 1.0 - (sn * sn).sum(-1) / 9.0
    b = snc / 3.0 - (sn * sc).sum(-1) / 9.0
    r = b / torch.where(a.abs() < 1e-9, torch.full_like(a, 1e-9), a)
    h = (sc - r[:, None] * sn) / 3.0
    r_ = r[:, None]
    terms = [(pc * pc).sum(-1)[None], 2.0 * r_ * (pc * pn).sum(-1)[None], r_ * r_,
             2.0 * (h @ pc.T), 2.0 * r_ * (h @ pn.T), (h * h).sum(-1)[:, None]]
    den = (r_ * r_).clamp_min(1e-12)
    d2 = (terms[0] - terms[1] + terms[2] - terms[3] + terms[4] + terms[5]) / den
    d2_bound = CYL_D2_ULPS * F32_EPS * sum(t.abs() for t in terms) / den
    rw = remaining.double()
    scores = (rw * d2.clamp_max(trunc)).sum(-1)
    score_bound = (rw * torch.where(d2 < trunc, d2_bound, torch.zeros_like(d2))).sum(-1)
    return scores, d2, d2_bound, score_bound


def lls_length_tolerance(grid, axis, inliers, radius: float) -> float:
    """Tolerance of a sub-segment's centre and radius (mm): CYL_ATOL_MM +
    CYL_RTOL radius / |a|, with a = 1 - |sum n|^2 / k^2 over the inliers'
    normals across ``axis``: the LLS radius is b / a, so its error grows as
    1 / |a| where the normals point one way (a region of planes)."""
    ax = axis.double()
    pn = grid.normal.double() - (grid.normal.double() @ ax)[:, None] * ax
    pn = pn / torch.linalg.vector_norm(pn, dim=-1, keepdim=True).clamp_min(1e-9)
    k = float(inliers.sum())
    a = abs(1.0 - float(pn[inliers].sum(0).square().sum()) / max(k, 1.0) ** 2)
    return CYL_ATOL_MM + CYL_RTOL * radius / max(a, 1e-9)


def subsegment_flip(grid, axis, remaining, si, n_hyp, trunc, got_valid, got_inliers):
    """Whether a round whose valid flag or inliers differ from the plain MSAC's
    (from the same ``axis`` and ``remaining`` cells) took a decision the
    plain version takes within float32's error: the hypotheses that can have
    given the kernel's result (its inliers, but for cells whose distance lies
    within its bound of the threshold; or, for an invalid round, fewer than 6
    inliers) must hold one whose score lies within the two scores' bounds of
    the best score (``msac_round64``, in float64)."""
    scores, d2, d2_bound, score_bound = msac_round64(grid, axis, remaining, si, n_hyp, trunc)
    inl = remaining & (d2 < trunc)
    near = remaining & ((d2 - trunc).abs() <= d2_bound)
    if bool(got_valid):
        could = ((inl == got_inliers) | near).all(-1)
    else:
        could = (inl & ~near).sum(-1) < 6
    best = int(scores.argmin())
    margin = scores - scores[best]
    tol = score_bound + score_bound[best]
    within = could & (margin <= tol)
    # the hypothesis the kernel can have taken with the least margin for its bound
    ratio = torch.where(could, margin / tol.clamp_min(1e-300), torch.full_like(margin, math.inf))
    pick = int(ratio.argmin()) if bool(could.any()) else -1
    return dict(best=best, kernel_could_be=pick,
                margin=float(margin[pick]) if pick >= 0 else None,
                tol=float(tol[pick]) if pick >= 0 else None,
                hypotheses_that_could=int(could.sum()), permitted=bool(within.any()))


def check_cylinders_frame(cam, det, depth, name="frame"):
    """The cylinders kernel against its plain version on the cylinder stage's
    inputs of one depth map (``check_cylinder_stage``).  Returns (inputs, live
    slots, max errors, flips)."""
    inputs = cylinder_inputs(cam, det, depth)
    return (inputs, *check_cylinder_stage(inputs, det, name))


def check_cylinder_stage(inputs, det, name="frame"):
    """The cylinders kernel against its plain version on ``inputs`` (grid,
    member, try_cyl, min_activated), by the ``CYL_*`` rules.  Returns (live
    slots, max errors, flips); raises on a difference outside the rules."""
    grid, member, try_cyl, min_activated = inputs
    got = cylinders_cuda.cylinders_cuda(grid, member, try_cyl, det, min_activated)
    want = cylinders_cuda.cylinders_reference(grid, member, try_cyl, det, min_activated)
    torch.cuda.synchronize()
    problems, flips, err = [], [], {}
    # the axis gate, against the plain score's distance to the threshold
    w0 = (member & grid.planar).double()
    nrm = grid.normal.double()
    nn64 = torch.einsum("kc,ci,cj->kij", w0, nrm, nrm)
    ev = torch.linalg.eigvalsh(nn64)
    score = ev[:, 2] / ev[:, 0].clamp_min(1e-12)
    gate_margin = (score / det.cylinder_ransac_min_score - 1.0).abs()
    for r in torch.nonzero(got.axis_ok != want.axis_ok).flatten().tolist():
        flips.append(dict(frame=name, output="axis_ok", region=r,
                          margin=float(gate_margin[r]), tol=CYL_SCORE_RTOL))
        if not float(gate_margin[r]) <= CYL_SCORE_RTOL:
            problems.append(f"axis gate of region {r} flipped, {float(gate_margin[r])} of "
                            "its threshold away")
    # the axis is read only where a region holds a slot (a planar region's
    # normals span one direction, so its smallest eigenvector is arbitrary)
    ok_both = got.selected & want.selected
    d_axis = (got.axis - want.axis).abs().amax(-1)
    d_neg = (got.axis + want.axis).abs().amax(-1)
    gap = _eig_row_gap(nn64)
    tol_lam, lam = eig3_tolerance(nn64, w0.sum(-1) ** 2 * F32_EPS)
    tol_axis = CYL_AXIS_TOL + tol_lam / (lam[:, 1] - lam[:, 0]).clamp_min(1e-30)
    for r in torch.nonzero(ok_both).flatten().tolist():
        if float(d_axis[r]) <= CYL_AXIS_TOL:
            continue
        sign = float(d_neg[r]) < float(d_axis[r])
        flips.append(dict(frame=name, output="axis_sign" if sign else "axis", region=r,
                          off=float(min(d_axis[r], d_neg[r])), tol=float(tol_axis[r]),
                          row_gap=float(gap[r])))
        if not (float(d_axis[r]) <= float(tol_axis[r])
                or (float(d_neg[r]) <= float(tol_axis[r]) and float(gap[r]) <= CYL_SCORE_RTOL)):
            problems.append(f"axis of region {r} off by {float(d_axis[r])}")
    err["axis"] = float(torch.minimum(d_axis, d_neg)[ok_both].max()) if ok_both.any() else 0.0
    gate_flipped = bool((got.axis_ok != want.axis_ok).any())
    if not torch.equal(got.selected, want.selected) and not gate_flipped:
        problems.append("selection differs")
    live = [r for r in torch.nonzero(got.selected & want.selected).flatten().tolist()]
    # the sub-segments of each live region, round by round
    trunc = det.cylinder_ransac_sqrt_max_distance
    n_hyp = primitives._msac_iterations(det)
    err.update(center=0.0, radius=0.0, mse=0.0)
    for r in live:
        # the plain MSAC from the kernel's axis
        ref = primitives._fit_cylinder(grid, member[r:r + 1], got.axis[r:r + 1],
                                       torch.ones(1, dtype=torch.bool, device=member.device),
                                       det, min_activated)
        ref_centers, ref_radii, ref_mses, ref_valids, ref_inliers = [x[0] for x in ref]
        remaining = member[r] & grid.planar
        for si in range(want.valids.shape[1]):
            same = bool(got.valids[r, si] == ref_valids[si]) \
                and torch.equal(got.inliers[r, si], ref_inliers[si])
            if not same:
                f = subsegment_flip(grid, got.axis[r], remaining, si, n_hyp, trunc,
                                    got.valids[r, si], got.inliers[r, si])
                flips.append(dict(frame=name, output="subsegment", region=r, round=si, **f))
                if not f["permitted"]:
                    problems.append(f"region {r} round {si}: {f}")
                break   # the later rounds start from another remaining set
            if bool(ref_valids[si]):
                rad = float(ref_radii[si].abs())
                dc = float((got.centers[r, si] - ref_centers[si]).abs().max())
                dr = float((got.radii[r, si] - ref_radii[si]).abs())
                dm = float((got.mses[r, si] - ref_mses[si]).abs())
                tol_len = lls_length_tolerance(grid, got.axis[r], ref_inliers[si], rad)
                tol_mse = 4.0 * math.sqrt(float(ref_mses[si])) * tol_len + 4.0 * tol_len ** 2
                err.update(center=max(err["center"], dc), radius=max(err["radius"], dr),
                           mse=max(err["mse"], dm))
                if not (dc <= tol_len and dr <= tol_len and dm <= tol_mse):
                    problems.append(f"region {r} round {si}: centre {dc}, radius {dr}, mse {dm}"
                                    f" (tolerances {tol_len}, {tol_len}, {tol_mse})")
            elif not bool(got.mses[r, si].isinf()):
                problems.append(f"region {r} round {si}: an invalid sub-segment's mse is "
                                f"{float(got.mses[r, si])}")
            remaining = remaining & ~ref_inliers[si]
    # every region no slot holds carries the fill values
    idle = ~(got.selected | want.selected)
    if bool(got.valids[idle].any() or got.inliers[idle].any()
            or (got.radii[idle] != 0).any() or (got.centers[idle] != 0).any()
            or ~got.mses[idle].isinf().all()):
        problems.append("a region without a slot holds other than the fill values")
    if problems:
        raise RuntimeError(f"cylinders kernel against its plain version on {name}: "
                           + "; ".join(problems))
    return len(live), err, flips


def check_cylinders(cam, cfg, device, frames, tunnel_depths):
    """Phase ``cylinders``: the cylinder stage's kernel (``csrc/cylinders.cu``)
    against its plain version on the inputs ``find_primitives`` gives it on the
    plane path's room frames (most without a live region: the axis gate and
    the fill values) and the tunnel leg's (``check_cylinders_frame``), then
    timed on each of ``TIMED_FRAMES`` (the JSON line's on the tunnel frame),
    where its outputs must equal the first design's (``held_bits``).  The
    bound counts the inputs read once,
    the outputs written once and ``cylinders_cuda.cylinders_work``'s float
    operations for the frame's live regions.  No PyTorch call computes the
    stage: ``library_ms`` is null."""
    det = cfg.detection
    worst, all_flips, tunnel_live = {}, [], 0
    depths = [("room", d) for _, d in frames] + [("tunnel", d) for d in tunnel_depths]
    for i, (kind, depth) in enumerate(depths):
        dep = torch.as_tensor(depth, device=device)
        _, live, err, flips = check_cylinders_frame(cam, det, dep, name=f"{kind}{i}")
        for k, v in err.items():
            worst[k] = max(worst.get(k, 0.0), v)
        all_flips += flips
        tunnel_live += live if kind == "tunnel" else 0
    for f in all_flips:
        _say("cylinders_flip", **f)
    if tunnel_live == 0:
        raise RuntimeError("cylinders: no live region on the tunnel frames")
    result = None
    n_hyp = primitives._msac_iterations(det)
    for kind, dep in timed_depths(frames, tunnel_depths, device).items():
        grid, member, try_cyl, min_act = cylinder_inputs(cam, det, dep)

        def stage():
            return cylinders_cuda.cylinder_stage(grid, member, try_cyl, det, min_act)

        live = int(stage().selected.sum())
        k, c = member.shape
        work = cylinders_cuda.cylinders_work(c, k, n_hyp, primitives.CYL_SUBSEGMENTS, live)
        bound_ms, bound_by = bound_of(work)
        in_bits = output_digest([grid.normal, grid.mean, grid.planar, member, try_cyl,
                                 torch.tensor(min_act)])
        bits = output_digest(stage())
        fields = dict(
            max_abs_err=worst["axis"], ms=_median_ms(stage),
            plain_ms=_median_ms(lambda: cylinders_cuda.cylinders_reference(
                grid, member, try_cyl, det, min_act)),
            device_us=graph_launch_us(stage), bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None)
        _say("kernel", name="cylinders", kind=kind, frame="%s%d" % TIMED_FRAMES[kind],
             live_regions=live, frames=len(depths), flips=len(all_flips),
             **{f"max_err_{k}": v for k, v in worst.items()},
             mflop=work["flops"] / 1e6, mbytes=work["bytes"] / 1e6,
             **{k: fields[k] for k in ("ms", "plain_ms", "device_us", "bound_ms",
                                       "bound_by")},
             inputs_bits=in_bits, bits=bits,
             bits_equal_first_design=held_bits(kind, "cylinders", in_bits, bits))
        if kind == "tunnel_one":
            result = fields
    return result


def check_large_grids(cfg, device, frames, tunnel_depths):
    """Phase ``large_grids``: the fused LK at the ``KV2_HD`` camera against
    its plain version, timed; the cylinder stage's global-memory path against
    its plain version (``check_cylinders_frame``) on the room frames of
    ``TIMED_FRAMES`` and the tunnel's first frame at 1920x1080 with 20 px cells
    and at 640x480 with 8 px cells (``frames``, ``tunnel_depths``), each
    timed.  Returns the kernel line's fields of the global path on the 1080p
    tunnel frame."""
    case = kernel_cases(KV2_HD, cfg, device)[0]
    err, n_both, flag_diffs, _ = check_case(case)
    work = case.work()
    bound_ms, bound_by = bound_of(work)
    _say("kernel", name=case.name, camera="1920x1080", points=case.points, both_ok=n_both,
         near_gate_flag_diffs=flag_diffs, max_abs_err_px=err, tol_px=TOL_PX,
         iterations=work["iterations"], mflop=work["flops"] / 1e6,
         mbytes=work["bytes"] / 1e6, ms=_median_ms(case.kernel),
         plain_ms=_median_ms(case.plain), device_us=graph_launch_us(case.kernel),
         bound_ms=bound_ms, bound_by=bound_by)

    det = cfg.detection
    scene = synthetic.RoomScene(KV2_HD, depth_noise=config.DepthNoiseModel())
    orbit = synthetic.orbit_trajectory(JAX_REFERENCE["planes"]["frames"], speed_mm=4.0)
    hd_depths = {kind: torch.as_tensor(scene.render(*orbit[i])[1] if leg == "room"
                                       else _tunnel_depths(KV2_HD, i + 1)[i], device=device)
                 for kind, (leg, i) in TIMED_FRAMES.items()}
    grids = {"1080p": (KV2_HD, det, hd_depths),
             "8px": (config.TUM_FR1, dataclasses.replace(det, depth_patch_size_px=8),
                     timed_depths(frames, tunnel_depths, device))}
    n_hyp = primitives._msac_iterations(det)
    result = None
    for grid_name, (cam, det_g, depths) in grids.items():
        for kind, dep in depths.items():
            name = f"{kind}_{grid_name}"
            inputs, _, err, flips = check_cylinders_frame(cam, det_g, dep, name=name)
            grid, member, try_cyl, min_act = inputs
            k, c = member.shape
            if cylinders_cuda.shared_path(c, k):
                raise RuntimeError(f"cylinders on {name}: {c} cells took the shared path")

            def stage():
                return cylinders_cuda.cylinder_stage(grid, member, try_cyl, det_g, min_act)

            live = int(stage().selected.sum())
            if kind.startswith("tunnel") and live == 0:
                raise RuntimeError(f"cylinders on {name}: no live region")
            work = cylinders_cuda.cylinders_work(c, k, n_hyp, primitives.CYL_SUBSEGMENTS,
                                                 live)
            bound_ms, bound_by = bound_of(work)
            fields = dict(
                max_abs_err=err["axis"], ms=_median_ms(stage),
                plain_ms=_median_ms(lambda: cylinders_cuda.cylinders_reference(
                    grid, member, try_cyl, det_g, min_act)),
                device_us=graph_launch_us(stage), bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)
            for f in flips:
                _say("cylinders_flip", frame=name, **f)
            _say("kernel", name="cylinders_global", frame=name, cells=c, live_regions=live,
                 flips=len(flips), **{f"max_err_{k}": v for k, v in err.items()},
                 mflop=work["flops"] / 1e6, mbytes=work["bytes"] / 1e6,
                 **{k: fields[k] for k in ("ms", "plain_ms", "device_us", "bound_ms",
                                           "bound_by")})
            if name == "tunnel_one_1080p":
                result = fields
    return result


def step_calls(module, name, cam, cfg, device, frames, with_planes=True, with_lines=False):
    """The arguments, cloned, of the two calls a step makes of ``module.name``
    in each of ``frames`` but the first, recorded from an eager
    ``engine.step`` on the card: a list, a frame each, of two (args, kwargs)."""
    calls = []
    fn = getattr(module, name)

    def record(*args, **kw):
        args_, kw_ = step_graph.clone_tree((args, tuple(kw.items())))
        calls.append((args_, dict(kw_)))
        return fn(*args, **kw)

    stepper = step_graph.EagerStep(engine.init_state(cam, cfg, seed=SEED, device=device),
                                   cam, cfg, with_planes=with_planes, with_lines=with_lines)
    staged = runner.stage_frames(frames, device=device)
    stepper.step(*staged[0])
    setattr(module, name, record)
    try:
        for frame in staged[1:]:
            stepper.step(*frame)
    finally:
        setattr(module, name, fn)
    torch.cuda.synchronize()
    if len(calls) != 2 * (len(frames) - 1):
        raise RuntimeError(f"{len(frames) - 1} steps called {name} {len(calls)} times")
    return [calls[i:i + 2] for i in range(0, len(calls), 2)]


def phase_frames(cam):
    """The frames of the lm and ransac_score phases beside the room orbit's,
    and the step's switches for each: the low-texture striped wall's first two
    (lines on, planes off: live line rows) and the hard scene's first three
    (depth holes: live inverse-depth points)."""
    wall = synthetic.StripeWallScene(cam, texture_scale=0.03, stripe_period_z=2400.0)
    wall_frames = [wall.render(q, p) for q, p in synthetic.lateral_trajectory(2, speed_mm=4.0)]
    return {"lines": (wall_frames, dict(with_planes=False, with_lines=True)),
            "points2d": (hard_orbit(cam, 3)[0], {})}


def lm_call_sites(cam, cfg, device, frames, with_planes=True, with_lines=False):
    """The inputs of the two ``lm_cuda.lm_solve`` calls (the hypothesis batch,
    then the refit + Monte-Carlo batch) of each of ``frames`` but the first,
    recorded from an eager ``engine.step`` on the card: a list, a frame each,
    of {name: (inputs, coeffs0, iterations, damping0)}."""
    return [{name: args for name, (args, _) in zip(LM_CALLS, calls)}
            for calls in step_calls(lm_cuda, "lm_solve", cam, cfg, device, frames,
                                    with_planes, with_lines)]


def _widened(inputs: lm_cuda.LMInputs, ulps=None) -> lm_cuda.LMInputs:
    """The inputs in float64, each float first moved by an ulp of float32 in a
    direction drawn from the generator ``ulps`` (None: not moved)."""
    def wide(t):
        if not isinstance(t, torch.Tensor) or not t.is_floating_point():
            return t
        return _ulp_moved(t, ulps).double()

    return lm_cuda.LMInputs(*(wide(t) for t in inputs))


def _ulp_moved(t, ulps):
    if ulps is None:
        return t
    up = torch.rand(t.shape, generator=ulps, device=t.device) < 0.5
    return torch.nextafter(t, torch.where(up, math.inf, -math.inf).to(t.dtype))


def normal_equation_errors(inputs: lm_cuda.LMInputs, damping0: float, points, costs, jtjs,
                           jtrs) -> dict:
    """The cost and normal equations of an LM run at its linearization points
    (``points`` [B, L, 6], ``costs`` [B, L], ``jtjs`` [B, L, 6, 6], ``jtrs`` [B,
    L, 6]) against the plain version's at the same points in float64, in units
    of the tolerance (see ``LM_LINEARIZATION_RTOL``): {"jtj", "jtr", "cost":
    the worst over the run [B] (at most 1 passes), and the same as the
    largest error relative to the largest entry, ``*_of_largest``}.  A point
    that is not finite is skipped (the decisions reject it)."""
    b, n_lin = points.shape[:2]
    keys = ("jtj", "jtr", "cost")
    got = dict(zip(keys, (jtjs, jtrs, costs)))
    rtol = dict(jtj=LM_LINEARIZATION_RTOL, jtr=LM_LINEARIZATION_RTOL, cost=LM_COST_RTOL)
    zeros = torch.zeros(b, dtype=torch.float64, device=points.device)
    out = {k: zeros.clone() for k in keys + tuple(f"{k}_of_largest" for k in keys)}
    tiny = torch.finfo(torch.float64).tiny
    exact = _widened(inputs)
    for j in range(n_lin):
        finite = torch.isfinite(points[:, j]).all(-1)
        at = torch.where(finite[:, None], points[:, j], 0.0)
        want = lm_cuda.lm_solve_reference(exact, at.double(), 0, damping0, details=True)
        spread = {k: torch.zeros_like(getattr(want, k)) for k in keys}
        ulps = torch.Generator(device=points.device).manual_seed(j)
        for _ in range(LM_SPREAD_DRAWS):
            moved = lm_cuda.lm_solve_reference(_widened(inputs, ulps),
                                               _ulp_moved(at, ulps).double(), 0, damping0,
                                               details=True)
            for k in keys:
                spread[k] = torch.maximum(spread[k], (getattr(moved, k) - getattr(want, k)).abs())
        for k in keys:
            w = getattr(want, k).reshape(b, -1)
            err = (got[k][:, j].double().reshape(b, -1) - w).abs()
            scale = w.abs().amax(-1, keepdim=True)
            tol = rtol[k] * scale + LM_SPREAD_FACTOR * spread[k].reshape(b, -1)
            for key, e in ((k, (err / tol.clamp_min(tiny)).amax(-1)),
                           (f"{k}_of_largest", (err / scale.clamp_min(tiny)).amax(-1))):
                e = torch.where(finite, torch.nan_to_num(e, nan=math.inf), zeros)
                out[key] = torch.maximum(out[key], e)
    return out


def lm_replay(inputs: lm_cuda.LMInputs, damping0: float, got: lm_cuda.LMResult) -> dict:
    """Hold an LM run ``got`` (``lm_cuda.lm_solve(..., details=True)`` over a
    batch [B]) to the rules of the LM step by step, each step from the run's
    own state, so that a decision that a tie flipped does not carry over:

    1. each linearization (the start, then each finite trial) against the plain
       version's at the same point (:func:`normal_equation_errors`);
    2. each decision from the run's own costs: accept exactly when the trial's
       cost is below the best point's and the trial is finite (past the 63
       accept bits, the decision the costs give is followed);
    3. each trial against ``lm_cuda.damped_step`` from the best point so far,
       its normal equations and the damping that the decisions give, within
       ``LM_POSITION_TOL_MM`` and ``LM_STEREO_TOL``;
    4. the point, cost and normal equations returned are the best point's, to
       the bit.

    Returns {name: [B]}: those of (1), and ``step`` (3) in units of the
    tolerance (at most 1 passes); ``decisions``, the wrong decisions (2);
    ``result``, whether (4) failed; ``step_abs``, the largest |trial - plain
    step| in either unit."""
    b, n_lin = got.points.shape[:2]
    out = normal_equation_errors(inputs, damping0, got.points, got.costs, got.jtjs, got.jtrs)
    zeros = torch.zeros(b, dtype=torch.float64, device=got.points.device)
    out.update(step=zeros.clone(), step_abs=zeros.clone())

    def worst(key, err, where):
        err = torch.where(where, torch.nan_to_num(err.double(), nan=math.inf), zeros)
        out[key] = torch.maximum(out[key], err)

    best, best_cost = got.points[:, 0], got.costs[:, 0]
    jtj, jtr = got.jtjs[:, 0], got.jtrs[:, 0]
    damping = torch.full((b,), damping0, dtype=torch.float32, device=best.device)
    decisions = torch.zeros(b, dtype=torch.int64, device=best.device)
    for j in range(1, n_lin):
        trial, point = lm_cuda.damped_step(best, jtj, jtr, damping), got.points[:, j]
        either = torch.isfinite(trial).all(-1) | torch.isfinite(point).all(-1)
        d_pos = (point[:, :3] - trial[:, :3]).abs().amax(-1)
        d_st = (point[:, 3:] - trial[:, 3:]).abs().amax(-1)
        worst("step", torch.maximum(d_pos / LM_POSITION_TOL_MM, d_st / LM_STEREO_TOL), either)
        worst("step_abs", torch.maximum(d_pos, d_st), either)
        rule = (got.costs[:, j] < best_cost) & torch.isfinite(point).all(-1)
        # past the accept bits the rule stands in for the decision; the result
        # check (4) then holds the run to it
        take = ((got.accepts >> (j - 1)) & 1).bool() if j <= 63 else rule
        decisions += (take != rule).to(torch.int64)
        best = torch.where(take[:, None], point, best)
        best_cost = torch.where(take, got.costs[:, j], best_cost)
        jtj = torch.where(take[:, None, None], got.jtjs[:, j], jtj)
        jtr = torch.where(take[:, None], got.jtrs[:, j], jtr)
        damping = lm_cuda.next_damping(damping, take)
    out["decisions"] = decisions

    def differ(x, y):
        return (x.reshape(b, -1).view(torch.int32) != y.reshape(b, -1).view(torch.int32)).any(-1)

    out["result"] = (differ(got.coeffs, best) | differ(got.cost, best_cost)
                     | differ(got.jtj, jtj) | differ(got.jtr, jtr))
    return out


def lm_failures(replay: dict):
    """The members a replay (:func:`lm_replay`) fails, [B] bool."""
    return ((replay["jtj"] > 1) | (replay["jtr"] > 1) | (replay["cost"] > 1)
            | (replay["step"] > 1) | (replay["decisions"] > 0) | replay["result"])


def lm_sources(cam, cfg, device, frames):
    """The inputs of the lm phase, by source: the plane step's second
    room-orbit frame (the main path's frame, and the one timed); the low-texture
    striped wall's second frame with lines on (live line rows); of the hard
    scene's second and third frames (depth holes), the one with the most live
    inverse-depth points (``phase_frames``).  {source: {name: (inputs, coeffs0,
    iterations, damping0)}}; each source but the first fails unless its rows
    are live."""
    def live(calls, kind):
        return sum(lm_cuda.lm_work(c[0], c[1], 1)["live"][kind] for c in calls.values())

    more = phase_frames(cam)
    sources = {
        "plane": lm_call_sites(cam, cfg, device, frames[:2])[0],
        "lines": lm_call_sites(cam, cfg, device, more["lines"][0], **more["lines"][1])[0],
        "points2d": max(lm_call_sites(cam, cfg, device, more["points2d"][0]),
                        key=lambda calls: live(calls, 1)),
    }
    for source, kind in (("lines", 3), ("points2d", 1)):
        if live(sources[source], kind) == 0:
            raise RuntimeError(f"lm phase: no live {source} rows in its frames")
    return sources


def check_lm(cam, cfg, device, frames):
    """Phase ``lm``: the LM kernel against its plain version on the inputs of
    both ``lm_solve`` calls of three frames (:func:`lm_sources`).

    (a) One linearization (``iterations=0``, ``details=True``: the best point
    is the start, so JtJ, Jtr and the cost are the start's): each within
    ``LM_LINEARIZATION_RTOL`` of the largest entry of the plain ``vmap(jvp)``
    normal equations of its member.  (b) The full LM, held to the plain
    version step by step (:func:`lm_replay`), and ``LM_REPEATS`` more
    launches each equal to the first to the bit.  Then
    the kernel's result beside the plain version's full LM from the same
    start: a member whose cost differs by more than ``LM_COST_RTOL`` or whose
    coefficients by more than ``LM_POSITION_TOL_MM`` and ``LM_STEREO_TOL`` is
    printed with both accept sequences (bit i: iteration i + 1).  That
    comparison gates nothing: a trial whose cost ties the best within rounding
    is decided otherwise by two versions that sum in other orders, and from
    there the two runs follow other paths (the plain version with its rows
    reversed does so too).  Then, on the plane step's inputs, the times:
    ``ms`` and ``plain_ms`` a call, ``device_us`` a launch replayed from a
    CUDA graph, and the bound from ``lm_cuda.lm_work``.  No PyTorch call runs a
    batched damped LM: ``library_ms`` is null.  Returns the kernel line's
    fields, summed over the two calls of a frame, with each call's under
    ``shapes``; ``max_abs_err`` is the largest |kernel trial - plain step| of
    every replayed step (mm or stereographic)."""
    shapes, max_step = {}, 0.0
    for source, calls in lm_sources(cam, cfg, device, frames).items():
        for name, (inputs, coeffs0, iterations, damping0) in calls.items():
            lin = lm_cuda.lm_solve(inputs, coeffs0, 0, damping0, details=True)
            torch.cuda.synchronize()
            lin_err = {k: float(v.max()) for k, v in normal_equation_errors(
                inputs, damping0, lin.points, lin.costs, lin.jtjs, lin.jtrs).items()}
            if not all(lin_err[k] <= 1 for k in ("jtj", "jtr", "cost")):
                raise RuntimeError(f"lm phase, {source} {name}: one linearization differs "
                                   f"from the plain normal equations: {lin_err} (units of "
                                   "the tolerance, and of the largest entry)")

            got = lm_cuda.lm_solve(inputs, coeffs0, iterations, damping0, details=True)
            repeat = all(_bit_equal(got, lm_cuda.lm_solve(inputs, coeffs0, iterations,
                                                          damping0, details=True))
                         for _ in range(LM_REPEATS))
            replay = lm_replay(inputs, damping0, got)
            failing = lm_failures(replay)
            max_step = max(max_step, float(replay["step_abs"].max()))
            want = lm_cuda.lm_solve_reference(inputs, coeffs0, iterations, damping0,
                                              details=True)
            d_pos = (got.coeffs[:, :3] - want.coeffs[:, :3]).abs().amax(-1)
            d_st = (got.coeffs[:, 3:] - want.coeffs[:, 3:]).abs().amax(-1)
            d_cost = (got.cost - want.cost) / want.cost.abs()
            outside = ((d_pos > LM_POSITION_TOL_MM) | (d_st > LM_STEREO_TOL)
                       | (d_cost.abs() > LM_COST_RTOL))
            finite = bool(torch.isfinite(got.coeffs).all() and torch.isfinite(got.cost).all())
            work = lm_cuda.lm_work(inputs, coeffs0, iterations + 1)
            fields = dict(
                batch=work["batch"], capacities=list(inputs.capacities),
                iterations=iterations, live_features=work["live"], rows=work["rows"],
                linearization_err=lin_err,
                replay_worst_of_tolerance={k: float(replay[k].max())
                                           for k in ("jtj", "jtr", "cost", "step")},
                replay_worst_of_largest={k: float(replay[f"{k}_of_largest"].max())
                                         for k in ("jtj", "jtr", "cost")},
                replay_wrong_decisions=int(replay["decisions"].sum()),
                replay_results_off_their_best=int(replay["result"].sum()),
                replay_failing_members=int(failing.sum()),
                max_step_abs_err=float(replay["step_abs"].max()),
                repeat_bit_equal=repeat, all_finite=finite,
                members_outside_tolerance=int(outside.sum()),
                members_differing_accepts=int((got.accepts != want.accepts).sum()),
                max_d_position_mm=float(d_pos.max()),
                max_cost_above_plain_rel=float(d_cost.max()),
                max_cost_below_plain_rel=float(-d_cost.min()))
            if source == "plane":
                bound_ms, bound_by = bound_of(work)
                fields.update(
                    mflop=work["flops"] / 1e6, kbytes=work["bytes"] / 1e3,
                    ms=_median_ms(lambda: lm_cuda.lm_solve(inputs, coeffs0, iterations,
                                                           damping0)),
                    plain_ms=_median_ms(lambda: lm_cuda.lm_solve_reference(
                        inputs, coeffs0, iterations, damping0), reps=5),
                    device_us=graph_launch_us(
                        lambda: lm_cuda.lm_solve(inputs, coeffs0, iterations, damping0)),
                    bound_ms=bound_ms, bound_by=bound_by, flops=work["flops"],
                    bytes=work["bytes"])
                shapes[name] = fields
            _say("lm", source=source, shape=name, **fields)
            for m in torch.nonzero(outside | failing).flatten().tolist():
                _say("lm", source=source, shape=name, member=m,
                     kernel_accepts=f"{int(got.accepts[m]):0{iterations}b}",
                     plain_accepts=f"{int(want.accepts[m]):0{iterations}b}",
                     d_position_mm=float(d_pos[m]), d_stereo=float(d_st[m]),
                     d_cost_rel=float(d_cost[m]), replay_fails=bool(failing[m]),
                     **{f"replay_{k}": float(replay[k][m])
                        for k in ("jtj", "jtr", "cost", "step", "decisions")})
            if not (repeat and finite) or bool(failing.any()):
                raise RuntimeError(
                    f"lm phase, {source} {name}: repeat bit-equal {repeat}, finite {finite}, "
                    f"{int(failing.sum())} members off the plain version's steps")
    total = {k: sum(s[k] for s in shapes.values())
             for k in ("ms", "plain_ms", "device_us", "flops", "bytes")}
    bound_ms, bound_by = bound_of(total)
    return dict(max_abs_err=max_step,
                ms=total["ms"], plain_ms=total["plain_ms"], device_us=total["device_us"],
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                shapes={name: {k: s[k] for k in ("batch", "iterations", "ms", "plain_ms",
                                                 "device_us", "bound_ms", "bound_by")}
                        for name, s in shapes.items()})


def score_call_sites(cam, cfg, device, frames, with_planes=True, with_lines=False):
    """The inputs of the two ``ransac_score_cuda.score`` calls (the hypotheses,
    then the refit's pose) of each of ``frames`` but the first, recorded from
    an eager ``engine.step`` on the card: a list, a frame each, of {name:
    (coeffs, prepared features, ok, caps)}."""
    return [{name: (args[0], args[1], kw.get("ok"), kw.get("caps"))
             for name, (args, kw) in zip(SCORE_CALLS, calls)}
            for calls in step_calls(ransac_score_cuda, "score", cam, cfg, device, frames,
                                    with_planes, with_lines)]


def score_sources(cam, cfg, device, frames):
    """The inputs of the ransac_score phase, by source, from the lm phase's
    frames: the plane step's second room-orbit frame (timed), the striped
    wall's second frame with lines on, the hard scene's frame (of its second
    and third) with the most live inverse-depth points.  Each source but the
    first fails unless its rows are live."""
    def live(calls, field):
        return int(getattr(calls["refit"][1], field).sum())

    more = phase_frames(cam)
    sources = {
        "plane": score_call_sites(cam, cfg, device, frames[:2])[0],
        "lines": score_call_sites(cam, cfg, device, more["lines"][0], **more["lines"][1])[0],
        "points2d": max(score_call_sites(cam, cfg, device, more["points2d"][0]),
                        key=lambda calls: live(calls, "point2d_mask")),
    }
    for source, field in (("lines", "line_mask"), ("points2d", "point2d_mask")):
        if live(sources[source], field) == 0:
            raise RuntimeError(f"ransac_score phase: no live {source} rows in its frames")
    return sources


def limit_ulps(values, caps, ransac=config.RansacConfig()):
    """How far each row's nearest tested value lies from its limit, in ulps of
    the limit (float32), by type as ``ransac_score_cuda.value_tests`` gives the tests: a
    decision that two roundings of the same chain take differently lies
    within a few (``ransac_score_cuda.tested_values``' rows)."""
    pt, q2, pl, ln = ransac_score_cuda.split_values(values, caps)
    lim = ransac_score_cuda.limits(ransac)

    def ulps(v, limit):
        return ((v.abs() - limit).abs() / (torch.finfo(torch.float32).eps * limit)
                ).nan_to_num(float("inf"))

    return (ulps(pt, lim[0]), ulps(q2, lim[1]).amin(-1),
            torch.minimum(ulps(pl[..., :3], lim[2]).amin(-1), ulps(pl[..., 3], lim[3])),
            ulps(ln, lim[4]).amin(-1))


def score_agreement(got, got_values, want, want_values, caps, name):
    """The kernel's scoring (``got``) against the plain version's (``want``),
    both with ``details``: the tested values' bit-equal share and largest
    relative difference; the decisions that differ and, of those, the ones
    whose plain value lies farther than ``SCORE_FLIP_ULPS`` from its limit
    (``unexplained``); whether the outputs are equal.  Raises where a decision
    differs unexplained, or where every decision agrees and an output does
    not."""
    same = (got_values == want_values) | (got_values.isnan() & want_values.isnan())
    diff = (got_values - want_values).abs() / want_values.abs().clamp_min(1e-30)
    tests_got = ransac_score_cuda.value_tests(got_values, caps)
    tests_want = ransac_score_cuda.value_tests(want_values, caps)
    near = limit_ulps(want_values, caps)
    flips = sum(int((a != b).sum()) for a, b in zip(tests_got, tests_want))
    unexplained = sum(int(((a != b) & (u > SCORE_FLIP_ULPS)).sum())
                      for a, b, u in zip(tests_got, tests_want, near))
    outputs_equal = (
        torch.equal(got.best, want.best)   # the coefficients copied bit for bit, NaN too
        and torch.equal(got.coeffs.view(torch.int32), want.coeffs.view(torch.int32))
        and torch.equal(got.score, want.score.float())
        and torch.equal(got.scores, want.scores.float())
        and torch.equal(got.counts.long(), want.counts.long())
        and all(torch.equal(a, b) for a, b in zip(got.masks, want.masks)))
    fields = dict(values_bit_equal=float(same.double().mean()),
                  max_value_rel_diff=float(diff[~same].max()) if bool((~same).any()) else 0.0,
                  decision_flips=flips, unexplained_flips=unexplained,
                  outputs_equal=outputs_equal, best=int(got.best))
    if unexplained or (flips == 0 and not outputs_equal):
        _say("ransac_score", shape=name, **fields)
        raise RuntimeError(f"ransac_score phase, {name}: the kernel disagrees with its plain "
                           f"version: {fields}")
    return fields


def score_in_graph_us(cam, cfg, device, frames, profiled=8):
    """The scoring kernel where the main path runs it: inside the plane step's
    CUDA graph (``StepGraph``) over ``frames``, the last ``profiled`` under the
    profiler: its device µs and launches a frame."""
    staged = runner.stage_frames(frames, device=device)
    graph = step_graph.StepGraph(engine.init_state(cam, cfg, seed=SEED, device=device), cam,
                                 cfg)
    try:
        for gray, depth in staged[:-profiled]:
            graph.step(gray, depth)
        torch.cuda.synchronize()
        ops = _device_ops(lambda: [graph.step(gray, depth) for gray, depth in staged[-profiled:]])
    finally:
        graph.close()
    mark = LAUNCH_MARKS["ransac_score"]
    return dict(us=sum(us for name, us in ops if name.startswith(mark)) / profiled,
                launches=sum(name.startswith(mark) for name, _ in ops) / profiled)


def check_ransac_score(cam, cfg, device, frames):
    """Phase ``ransac_score``: the scoring kernel against its plain version
    (``score_reference`` on the card) on the inputs of both scoring calls of
    three frames (:func:`score_sources`), held by :func:`score_agreement`,
    and ``SCORE_REPEATS`` more launches each equal to the first to the bit.
    Then, on the plane frame, the times: ``ms`` and ``plain_ms`` a call,
    ``device_us`` a launch replayed from a CUDA graph, the bound from
    ``score_work`` (every row live), and µs a frame inside the plane step's
    graph, where the kernel must launch twice a frame.  No PyTorch call
    scores RANSAC hypotheses: ``library_ms`` is null.  Returns the kernel
    line's fields, summed over the two calls of a frame."""
    shapes = {}
    for source, calls in score_sources(cam, cfg, device, frames).items():
        for name, (coeffs, prep, ok, caps) in calls.items():
            run = functools.partial(ransac_score_cuda.score_cuda, coeffs, prep, cam,
                                    cfg.ransac, ok, caps)
            got, got_values = run(details=True)
            torch.cuda.synchronize()
            want, want_values = ransac_score_cuda.score_reference(
                coeffs, prep, cam, cfg.ransac, ok, caps, details=True)
            repeat = all(_bit_equal(got, run()) for _ in range(SCORE_REPEATS))
            fields = dict(hypotheses=1 if coeffs.dim() == 1 else coeffs.shape[0],
                          capacities=list(ransac_score_cuda.capacities(prep)),
                          live=[int(m.sum()) for m in (prep.point_mask, prep.point2d_mask,
                                                       prep.plane_mask, prep.line_mask)],
                          inliers=[int(m.sum()) for m in got.masks], repeat_bit_equal=repeat,
                          **score_agreement(got, got_values, want, want_values,
                                            ransac_score_cuda.capacities(prep),
                                            f"{source} {name}"))
            if source == "plane":
                work = ransac_score_cuda.score_work(fields["capacities"], fields["hypotheses"],
                                                    batched=coeffs.dim() == 2)
                bound_ms, bound_by = bound_of(work)
                fields.update(
                    ms=_median_ms(run),
                    plain_ms=_median_ms(lambda: ransac_score_cuda.score_reference(
                        coeffs, prep, cam, cfg.ransac, ok, caps), reps=5),
                    device_us=graph_launch_us(run), bound_ms=bound_ms, bound_by=bound_by,
                    flops=work["flops"], bytes=work["bytes"])
                shapes[name] = fields
            _say("ransac_score", source=source, shape=name, **fields)
            if not repeat:
                raise RuntimeError(f"ransac_score phase, {source} {name}: a launch differs "
                                   "from the first")
    in_graph = score_in_graph_us(cam, cfg, device, frames[:16])
    _say("ransac_score", in_graph=in_graph)
    if in_graph["launches"] != 2:
        raise RuntimeError(f"the plane step's graph ran {in_graph['launches']} scoring "
                           "launches a frame")
    total = {k: sum(s[k] for s in shapes.values())
             for k in ("ms", "plain_ms", "device_us", "flops", "bytes")}
    bound_ms, bound_by = bound_of(total)
    return dict(max_abs_err=max(s["max_value_rel_diff"] for s in shapes.values()),
                ms=total["ms"], plain_ms=total["plain_ms"], device_us=total["device_us"],
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                in_graph_us_a_frame=in_graph["us"],
                shapes={name: {k: s[k] for k in ("hypotheses", "ms", "plain_ms", "device_us",
                                                 "bound_ms", "bound_by")}
                        for name, s in shapes.items()})


def host_sync_sites(fn):
    """{``file:line`` of the innermost frame of the package: count} of the host
    syncs ``fn()`` makes, by ``torch.cuda.set_sync_debug_mode("warn")``; a sync
    with no frame of the package on the stack counts as ``"elsewhere"``."""
    package = str(Path(runner.__file__).parent)
    sites = {}
    inside = [False]

    def record(message, *_args, **_kw):
        # a warning the mode's own switch raises is not ``fn``'s
        if not inside[0] or "synchroniz" not in str(message):
            return
        ours = [f for f in traceback.extract_stack() if f.filename.startswith(package)]
        where = f"{Path(ours[-1].filename).name}:{ours[-1].lineno}" if ours else "elsewhere"
        sites[where] = sites.get(where, 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            inside[0] = True
            fn()
        finally:
            inside[0] = False
            torch.cuda.set_sync_debug_mode("default")
    return sites


def _bit_equal(a, b) -> bool:
    return all(torch.equal(x.contiguous().view(-1).view(torch.uint8),
                           y.contiguous().view(-1).view(torch.uint8))
               for x, y in zip(step_graph.tensor_leaves(a), step_graph.tensor_leaves(b),
                               strict=True))


def profile_replays(graph, frames):
    """``graph.step`` over ``frames`` under ``torch.profiler``: kernels and
    device µs a frame, and each kernel's launches as the profiler saw them
    beside the launch counts the wrappers kept (the graph adds what it
    recorded on each replay)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    before = nvcc.launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for gray, depth in frames:
            graph.step(gray, depth)
        torch.cuda.synchronize()
    counted = {k: v - before[k] for k, v in nvcc.launch_counts().items()}
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    seen = {k: sum(e.name.startswith(LAUNCH_MARKS[k]) for e in on_card)
            for k in counted}
    return dict(kernels_per_frame=len(on_card) / len(frames),
                device_us_per_frame=sum(e.time_range.elapsed_us() for e in on_card)
                / len(frames), launches_counted=counted, launches_profiled=seen)


def run_graph_phase(cam, cfg, device, frames, card):
    """The plane step over the first ``GRAPH_FRAMES`` frames, staged on the
    card: eagerly (``engine.step`` in a loop) and as one CUDA graph
    (``StepGraph``), with equal poses and final states to the bit; ms a frame
    of both past frame 0 (host clock, one sync at the end) and the graph's
    warm-up and capture time; ``PROFILED_REPLAYS`` replays under the profiler
    (kernels and device µs a frame, the busy share; the kernels' launches as
    the profiler sees them must equal the wrappers' counts); then
    ``run_frames`` over the same frames under ``set_sync_debug_mode``: every
    host sync must be the recording's (the runner waits for its summaries on
    events, which are no syncs).  Returns the frames/s of both."""
    staged = runner.stage_frames(frames[:GRAPH_FRAMES], device=device)

    def timed(step):
        poses = []
        for i, (gray, depth) in enumerate(staged):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, out = step(gray, depth)
            poses.append(torch.cat([out.position, out.quat]))
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / (len(staged) - 1), torch.stack(poses), state

    eager = step_graph.EagerStep(engine.init_state(cam, cfg, seed=SEED, device=device), cam,
                                 cfg)
    eager_ms, eager_poses, eager_final = timed(eager.step)
    graph = step_graph.StepGraph(engine.init_state(cam, cfg, seed=SEED, device=device), cam,
                                 cfg)
    try:
        graph_ms, graph_poses, graph_final = timed(graph.step)
        states_equal = _bit_equal(graph_final, eager_final)
        replays = profile_replays(graph, staged[:PROFILED_REPLAYS])
    finally:
        graph.close()
    poses_equal = torch.equal(eager_poses, graph_poses)

    primitives.FIXPOINT_READS["components"] = 0
    gc.collect()   # no garbage of the runs above may be freed inside the watch
    torch.cuda.synchronize()
    sites = host_sync_sites(lambda: runner.run_frames(staged, cam, cfg, seed=SEED,
                                                      device=device))
    recording = {k: v for k, v in sites.items() if k.startswith("step_graph.py")}
    others = {k: v for k, v in sites.items() if k not in recording}
    _say("graph", card=card, frames=len(staged), eager_ms_per_frame=eager_ms,
         graph_ms_per_frame=graph_ms, eager_fps=1e3 / eager_ms, graph_fps=1e3 / graph_ms,
         device_busy_share=replays["device_us_per_frame"] / (1e3 * graph_ms), **replays,
         warmup_and_capture_s=graph.record_s, poses_equal_to_the_bit=poses_equal,
         final_states_equal_to_the_bit=states_equal,
         recording_syncs=recording, other_host_syncs=others,
         fixpoint_reads=primitives.FIXPOINT_READS["components"])
    problems = []
    if not (poses_equal and states_equal):
        problems.append("the graph's poses or state differ from the eager step's")
    if replays["launches_counted"] != replays["launches_profiled"] \
            or replays["launches_counted"]["lk_fwd_bwd"] != PROFILED_REPLAYS:
        problems.append(f"launches counted {replays['launches_counted']}, profiled "
                        f"{replays['launches_profiled']} over {PROFILED_REPLAYS} replays")
    if others or primitives.FIXPOINT_READS["components"]:
        problems.append(f"host syncs outside the recording: {others}, fixpoint reads "
                        f"{primitives.FIXPOINT_READS['components']}")
    if problems:
        raise RuntimeError("graph phase: " + "; ".join(problems))
    return 1e3 / eager_ms, 1e3 / graph_ms


def full_window(cam, seed: int, device) -> keyframes.KeyframeWindow:
    """A keyframe window at the runner's capacities, filled to full count: 8
    keyframes of a lateral run with a slow yaw, each observing the same 512
    landmarks (8 x 512 x 8 observations, every slot valid), 0.3 px of pixel
    noise, 80% of the depths measured, and map positions 15 mm off."""
    rng = np.random.default_rng(seed)
    window = keyframes.KeyframeWindow(device=device)
    k, l = window.max_keyframes, window.max_landmarks
    kfs = []
    for i in range(k):
        quat = se3.quat_from_axis_angle(torch.tensor([0.0, 0.0, 1.0]),
                                        torch.tensor(0.004 * i + 0.001 * seed))
        kfs.append((quat, torch.tensor([20.0 * i, 30.0 * i, 5.0 * i])))
    world = np.concatenate([rng.uniform(2000, 4000, (2 * l, 1)),
                            rng.uniform(-900, 900, (2 * l, 2))], 1).astype(np.float32)
    screens = []
    for quat, pos in kfs:
        screen, ok = pinhole.world_to_screen(torch.from_numpy(world),
                                             se3.world_to_camera(quat, pos), cam)
        screens.append((screen.numpy(), ok.numpy()))
    seen = np.nonzero(np.all([ok for _, ok in screens], axis=0))[0][:l]
    if len(seen) < l:
        raise RuntimeError(f"backend_graph: {len(seen)} landmarks seen in every keyframe")
    fids = np.arange(l, dtype=np.int32)
    for i, ((quat, pos), (screen, _)) in enumerate(zip(kfs, screens)):
        uv = screen[seen, :2] + rng.normal(0, 0.3, (l, 2))
        z = np.where(rng.uniform(size=l) < 0.8, screen[seen, 2], 0.0)
        lm = world[seen] + rng.normal(0, 15.0, (l, 3))
        fobs = np.concatenate([np.ones((l, 1)), uv, z[:, None], lm], 1).astype(np.float32)
        window.add_keyframe_packed(quat.numpy(), pos.numpy(), fobs, fids, frame_id=8 * i)
    return window


def full_pose_graph(seed: int, device) -> pose_graph.PoseGraph:
    """A pose graph at the runner's capacities, filled to full count: 64
    keyframe nodes on a drifting odometry chain (63 odometry edges) and
    near-true relative poses between nodes 1 to 13 apart, as BA windows give
    them, of which the newest make the 256 edges."""
    rng = np.random.default_rng(seed)
    graph = pose_graph.PoseGraph(device=device)
    n = graph.max_nodes
    quats, positions = [np.array([1.0, 0.0, 0.0, 0.0])], [np.zeros(3)]
    for _ in range(n - 1):
        ang = 0.02 * (1 + 0.3 * rng.standard_normal())
        dq = np.array([np.cos(ang / 2), 0.0, 0.0, np.sin(ang / 2)])
        q, p = pose_graph.np_compose(quats[-1], positions[-1], dq,
                          np.array([25.0, 7.5, 0.0]) + rng.standard_normal(3) * 2.0)
        quats.append(q / np.linalg.norm(q))
        positions.append(p)
    odo_q, odo_p = [quats[0]], [positions[0]]
    for i in range(1, n):
        q_rel, p_rel = pose_graph.np_relative(quats[i - 1], positions[i - 1], quats[i],
                                              positions[i])
        q, p = pose_graph.np_compose(odo_q[-1], odo_p[-1], q_rel,
                          p_rel + np.array([1.2, 0.8, 0.3]) + rng.standard_normal(3) * 0.5)
        odo_q.append(q)
        odo_p.append(p)
    for i in range(n):
        graph.add_keyframe(5 * i, odo_q[i], odo_p[i])
    for stride in range(1, 14):
        nodes = range(0, n, stride)
        graph.add_ba_window([5 * i for i in nodes],
                            [(quats[i], positions[i] + rng.standard_normal(3) * 0.2)
                             for i in nodes])
    return graph


@contextlib.contextmanager
def traced_solves():
    """Counts the calls of ``ba.ba_solve`` and ``pose_graph.solve_pose_graph``
    in the block, by name (``ba``, ``pose_graph``): Python runs them only when a
    solve runs eagerly or is captured, never for a replay."""
    calls = {"ba": 0, "pose_graph": 0}

    def counted(name, fn):
        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return call

    real = ba.ba_solve, pose_graph.solve_pose_graph
    ba.ba_solve = counted("ba", real[0])
    pose_graph.solve_pose_graph = counted("pose_graph", real[1])
    try:
        yield calls
    finally:
        ba.ba_solve, pose_graph.solve_pose_graph = real


def _ms_a_call(fn, args, reps: int = BACKEND_REPS) -> float:
    """Median host ms of ``fn(args[r % len(args)])`` and its read back."""
    times = []
    for r in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_graph.tensor_leaves(fn(args[r % len(args)]))[0].cpu()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def profile_solves(fn, args):
    """Kernels and device µs a call of ``fn`` over ``args`` under
    ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for a in args:
            fn(a)
        torch.cuda.synchronize()
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return dict(kernels=len(on_card) / len(args),
                device_us=sum(e.time_range.elapsed_us() for e in on_card) / len(args))


def check_backend_solve(what, graph, eager, bufs, card):
    """One backend solve's graph (``SolveGraph``) against its eager solve on
    the card: every output equal to the bit on each buffer, all through the
    one graph; ms a call of both (host clock, with the read back), kernels and
    device µs a call of both, and the warm-up and capture seconds."""
    if not isinstance(graph, solve_graph.SolveGraph):
        raise RuntimeError(f"backend_graph, {what}: the solver is {type(graph).__name__}, "
                           "not a CUDA graph")
    equal = []
    for buf in bufs:
        want = eager(buf)
        got = graph(buf)
        equal.append(_bit_equal(got, want))
        if not all(torch.isfinite(step_graph.tensor_leaves(t)[0]).all() for t in (got, want)):
            raise RuntimeError(f"backend_graph, {what}: a result is not finite")
    record_s = graph.record_s
    graph_ms, eager_ms = _ms_a_call(graph, bufs), _ms_a_call(eager, bufs)
    replays, eagerly = profile_solves(graph, bufs), profile_solves(eager, bufs)
    _say("backend_graph", what=what, card=card, equal_to_the_bit=equal,
         warmup_and_capture_s=record_s, eager_ms=eager_ms, graph_ms=graph_ms,
         replay_kernels=replays["kernels"], replay_device_us=replays["device_us"],
         eager_kernels=eagerly["kernels"], eager_device_us=eagerly["device_us"])
    if not all(equal):
        raise RuntimeError(f"backend_graph, {what}: the replay differs from the eager solve "
                           f"({equal})")


def run_backend_graph_phase(cam, device, card):
    """The windowed BA refine and the pose-graph solve at full count, each
    as the CUDA graph ``refine`` and ``PoseGraph.solve`` replay, against the
    eager solve on the same card, on two problems through one graph."""
    windows = [full_window(cam, seed, device) for seed in (0, 1)]
    bufs = [torch.from_numpy(keyframes._pack_problem(w.build_problem())) for w in windows]
    solve = windows[0]._get_solver(cam, BA_ITERATIONS, None)
    try:
        check_backend_solve("ba 8x512x8", solve, solve_graph.EagerSolve(
            functools.partial(windows[0]._solve, cam=cam, iterations=BA_ITERATIONS), device),
            bufs, card)
    finally:
        windows[0].close()
    graphs = [full_pose_graph(seed, device) for seed in (0, 1)]
    bufs = [torch.from_numpy(g._pack()) for g in graphs]
    if graphs[0].dropped_edges == 0 or len(graphs[0].frame_ids) != graphs[0].max_nodes:
        raise RuntimeError("backend_graph: the pose graph is not full")
    solve = graphs[0]._get_solver(GRAPH_ITERATIONS)
    try:
        check_backend_solve("pose_graph 64x256", solve, solve_graph.EagerSolve(
            functools.partial(pose_graph._solve_packed, max_nodes=graphs[0].max_nodes,
                              max_edges=graphs[0].max_edges, iterations=GRAPH_ITERATIONS),
            device), bufs, card)
    finally:
        graphs[0].close()


def replay_order_problems(events, frames: int) -> list[str]:
    """The run's event log against its frames: one device entry
    (``("device", stages, stamps)``, ``profiling.StageTimer.device_stages``) a
    frame, each replay's first stamp no earlier than the last of the replay
    before it.  Returns the problems found."""
    replays = [event[2] for event in events if event[0] == "device"]
    if len(replays) != frames or any(b[0] < a[-1] for a, b in zip(replays, replays[1:])):
        return [f"{len(replays)} replays' stamps handed over for {frames} frames, or a "
                "replay's stamps before the replay's before it"]
    return []


def run_path(name, cam, cfg, device, frames, gt, expect_launches, with_planes=True,
             with_lines=False, ba_every=None, reference=None):
    """Drive ``runner.run_frames`` over ``frames`` with the launch counts set to 0
    just before; check the launches per frame (the step's CUDA graph replays one
    launch a frame and its warm-up step launches once more), no components
    fixpoint read on the host, failed/lost frames and the ATE
    against the path's JAX reference (``reference=None``: print only), lines
    alive and matched when lines are on, the backend's counts when it is, and
    the step graph's stamps (ten a replay, the stages summing to its span, and
    every frame's own replay's stamps handed over with the frame: each replay
    starts after the one before it ended).  Returns (launch counts, ATE,
    RunStats)."""
    ref = JAX_REFERENCE.get(reference)
    step_s, line_matches, cylinders = [], [], []

    def on_frame(i, state, out, dt):
        step_s.append(dt)
        line_matches.append(out.n_line_matches)
        cylinders.append(out.n_cylinders)

    nvcc.reset_launches()
    primitives.FIXPOINT_READS["components"] = 0
    timer = profiling.StageTimer(log=True)
    with traced_solves() as traced:
        state, traj, stats = runner.run_frames(
            frames, cam, cfg, with_planes=with_planes, with_lines=with_lines,
            ba_every=ba_every, seed=SEED, device=device, on_frame=on_frame, trace=timer)
    launches = nvcc.launch_counts()
    fixpoint_reads = primitives.FIXPOINT_READS["components"]

    ate = runner.evaluate_against_ground_truth(traj, gt)["ate_rmse_mm"]
    failed = stats.frame_count - stats.success_count
    planes_alive = int((state.planes.fid >= 0).sum())
    lines_alive = int((state.lines.fid >= 0).sum())
    frames_with_line_matches = int((torch.stack(line_matches) > 0).sum())
    frames_with_cylinders = int((torch.stack(cylinders) > 0).sum())
    steady_ms = np.array(step_s[1 + runner.SUMMARY_BATCH:]) * 1e3   # past the warm-up
    fields = dict(
        frames=stats.frame_count, warmup_steps=stats.warmup_steps, launches=launches,
        failed=failed, lost=stats.lost_count,
        ate_rmse_mm=ate, ate_bound_mm=ATE_MARGIN * ref["worst_ate_mm"] if ref else None,
        fps_from_frame_10=1e3 * len(steady_ms) / steady_ms.sum(),
        summary_waits=stats.counters.get("summary_waits", 0),
        step_ms_median=float(np.median(steady_ms)),
        step_ms_p80=float(np.percentile(steady_ms, 80)), first_frame_s=step_s[0],
        points_alive=int((state.points.fid >= 0).sum()), planes_alive=planes_alive)
    if with_planes:
        fields.update(frames_with_cylinders=frames_with_cylinders,
                      cylinders_live=stats.cylinders_live,
                      cylinders_us=stats.stage_device_us.get("cylinders"),
                      fixpoint_reads_per_frame=fixpoint_reads / stats.frame_count)
    if with_lines:
        fields.update(lines_alive=lines_alive,
                      frames_with_line_matches=frames_with_line_matches)
    if ba_every:
        fields.update(
            keyframes=stats.keyframe_count, ba_runs=stats.ba_runs,
            ba_accepted=stats.ba_accepted, graph_solves=stats.graph_solves,
            **stats.backend_ms(), solves_traced=traced,
            ba_dropped_landmarks=stats.ba_dropped_landmarks,
            ba_dropped_obs=stats.ba_dropped_obs, backend_uploads=stats.backend_uploads,
            backend_readbacks=stats.backend_readbacks)
    _say(name, **fields)
    problems = []
    if not with_planes:
        expect_launches = {**expect_launches, **{k: 0 for k in PLANE_KERNELS}}
    want = {k: v * (stats.frame_count + stats.warmup_steps)
            for k, v in expect_launches.items()}
    if launches != want:
        problems.append(f"launches {launches}, expected {want}")
    if fixpoint_reads:
        problems.append(f"{fixpoint_reads} components fixpoint reads on the host")
    # the run's trace: the stamp kernel recorded into the step graph, ten
    # stamps a replay past the first frame, its stages summing to its span
    if stats.stamped_frames != stats.frame_count - 1:
        problems.append(f"{stats.stamped_frames} stamped replays of {stats.frame_count} "
                        "frames")
    problems += replay_order_problems(timer.events, stats.frame_count)
    # a nested section (the cylinders, inside plane_extract) is not a stage of the span
    stages_us = sum(v for k, v in stats.stage_device_us.items()
                    if k not in profiling.PLANE_SECTIONS)
    if not (min(stats.stage_device_us.values(), default=-1) >= 0
            and math.isclose(stages_us, stats.graph_span_us, rel_tol=1e-9)):
        problems.append(f"the step's stages {stats.stage_device_us} do not sum to its "
                        f"span {stats.graph_span_us} us")
    if with_planes and "cylinders" not in stats.stage_device_us:
        problems.append("no cylinder section among the stamped stages")
    if frames_with_cylinders and not stats.cylinders_live:
        problems.append(f"cylinders on {frames_with_cylinders} frames, no live slot counted")
    if not np.isfinite(traj.positions_array()).all() \
            or not np.isfinite(np.array(traj.quaternions)).all():
        problems.append("a pose is not finite")
    if ref is not None:
        if failed > ref["failed"] or stats.lost_count > ref["lost"]:
            problems.append(f"failed/lost {failed}/{stats.lost_count} > JAX reference "
                            f"{ref['failed']}/{ref['lost']}")
        if not ate <= ATE_MARGIN * ref["worst_ate_mm"]:
            problems.append(f"ATE {ate} mm over the {ATE_MARGIN * ref['worst_ate_mm']} mm "
                            "bound")
    if with_planes and planes_alive == 0 and not (ref and "cylinder_frames" in ref):
        problems.append("no plane alive in the map")
    if ref and frames_with_cylinders < ref.get("cylinder_frames", 0):
        problems.append(f"cylinders on {frames_with_cylinders} frames, the JAX reference "
                        f"on {ref['cylinder_frames']}")
    if with_lines and (lines_alive == 0 or frames_with_line_matches == 0):
        problems.append(f"{lines_alive} lines alive, {frames_with_line_matches} frames "
                        "with line matches")
    if ba_every:
        solves = stats.ba_runs + stats.graph_solves
        if (stats.backend_uploads, stats.backend_readbacks) != (solves, solves):
            problems.append(f"{stats.backend_uploads} copies to the device and "
                            f"{stats.backend_readbacks} reads back for {solves} solves")
        # each solver runs its solve twice, to warm up and to be captured, and
        # replays it for every refine or graph solve
        recorded = {"ba": 2 * (stats.ba_runs > 0), "pose_graph": 2 * (stats.graph_solves > 0)}
        if traced != recorded:
            problems.append(f"solves traced {traced}, expected {recorded} for "
                            f"{stats.ba_runs} refines and {stats.graph_solves} graph solves")
    if ba_every and ref is not None:
        for key, got in (("keyframes", stats.keyframe_count), ("ba_runs", stats.ba_runs),
                         ("ba_accepted", stats.ba_accepted)):
            if got < ref[key]:
                problems.append(f"{key} {got} < the least JAX seed's {ref[key]}")
    if problems:
        raise RuntimeError(f"{name} path: " + "; ".join(problems))
    return launches, ate, stats


def write_png(path: str, pixels: np.ndarray):
    """An 8-bit RGB ([H, W, 3] uint8) or 16-bit gray ([H, W] uint16) image as a
    PNG file: one IDAT chunk, every scanline with filter 0."""
    h, w = pixels.shape[:2]
    if pixels.dtype == np.uint8 and pixels.ndim == 3 and pixels.shape[2] == 3:
        bit_depth, color_type, rows = 8, 2, pixels.reshape(h, w * 3)
    elif pixels.dtype == np.uint16 and pixels.ndim == 2:
        bit_depth, color_type = 16, 0
        rows = pixels.astype(">u2").view(np.uint8).reshape(h, w * 2)   # big-endian samples
    else:
        raise ValueError(f"no PNG form for {pixels.dtype} {pixels.shape}")
    scanlines = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    header = struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(scanlines, 1)) + chunk(b"IEND", b""))


def write_tum_directory(root: str, cam, grays, poses):
    """Write a sequence in TUM's on-disk format under ``root`` and a camera YAML
    beside it.  ``grays`` are the RGB camera's images at ``poses``; the depth
    maps are rendered here from the depth camera, ``RIG_BASELINE_MM`` along the
    RGB camera's x, by a RoomScene of their own (depth noise on), so the YAML's
    depth-to-RGB extrinsic is not the identity.  8-bit RGB, 16-bit depth at 5
    units a millimetre, ground truth in metres, quaternions as qx qy qz qw.
    Returns (dataset directory, YAML path)."""
    dataset = os.path.join(root, "rgbd_dataset_synth")
    os.makedirs(os.path.join(dataset, "rgb"))
    os.makedirs(os.path.join(dataset, "depth"))
    depth_scene = synthetic.RoomScene(cam, depth_noise=config.DepthNoiseModel())
    rgb_lines, depth_lines, gt_lines = ["# rgb"], ["# depth"], ["# gt"]
    for i, (gray, (quat, pos)) in enumerate(zip(grays, poses)):
        ts = 1300000000.0 + 0.05 * i
        g8 = np.clip(gray, 0, 255).astype(np.uint8)
        write_png(os.path.join(dataset, "rgb", f"{ts:.4f}.png"), np.stack([g8] * 3, -1))
        depth_pos = np.asarray(pos) + _np_quat_rotate(quat, [RIG_BASELINE_MM, 0.0, 0.0])
        depth_mm = depth_scene.render(quat, depth_pos)[1]
        d16 = np.clip(depth_mm * 5.0, 0, 65535).astype(np.uint16)
        write_png(os.path.join(dataset, "depth", f"{ts + 0.002:.4f}.png"), d16)
        rgb_lines.append(f"{ts:.4f} rgb/{ts:.4f}.png")
        depth_lines.append(f"{ts + 0.002:.4f} depth/{ts + 0.002:.4f}.png")
        w, x, y, z = quat
        gt_lines.append(f"{ts:.4f} {pos[0] / 1000} {pos[1] / 1000} {pos[2] / 1000} "
                        f"{x} {y} {z} {w}")
    for name, rows in (("rgb.txt", rgb_lines), ("depth.txt", depth_lines),
                       ("groundtruth.txt", gt_lines)):
        with open(os.path.join(dataset, name), "w") as f:
            f.write("\n".join(rows))
    yaml = os.path.join(root, "camera.yaml")
    with open(yaml, "w") as f:
        for n in (1, 2):
            f.write(f"camera_{n}_size_x: {cam.width}\ncamera_{n}_size_y: {cam.height}\n"
                    f"camera_{n}_focal_x: {cam.fx}\ncamera_{n}_focal_y: {cam.fy}\n"
                    f"camera_{n}_center_x: {cam.cx}\ncamera_{n}_center_y: {cam.cy}\n")
        f.write(f"camera_2_translation_offset_x: {RIG_BASELINE_MM}\n")
    return dataset, yaml


def run_tum_cli(cam, frames, poses, gt):
    """Phase 10: the frames through PNGs on disk and the command-line entry
    point in a process of its own.  Returns the launch counts of that process."""
    ref = JAX_REFERENCE["tum"]
    n = len(frames)
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        dataset, yaml = write_tum_directory(work, cam, [g for g, _ in frames], poses)
        write_s = time.perf_counter() - t0
        traj_out, map_out = os.path.join(work, "traj.txt"), os.path.join(work, "map.obj")
        report_path = os.path.join(work, "report.json")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "rgbd_slam_tpu_torch.cli", "-d", dataset, "--camera-yaml",
             yaml, "--ba", "8", "--stream-map", "-m", map_out, "-o", traj_out,
             "--native-loader"],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
            env={**os.environ, "RGBD_SLAM_RUN_REPORT": report_path,
                 "PYTHONPATH": os.pathsep.join(
                     [ROOT, *filter(None, [os.environ.get("PYTHONPATH")])])})
        cli_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"tum_cli: exit {proc.returncode}\n{proc.stdout[-2000:]}\n"
                               f"{proc.stderr[-4000:]}")
        printed = re.search(r"ATE-RMSE: ([0-9.]+) mm over (\d+) frames", proc.stdout)
        traj = np.loadtxt(traj_out, ndmin=2)
        with open(map_out) as f:
            map_lines = f.read().splitlines()
        with open(report_path) as f:
            report = json.load(f)
    stats = report["stats"]
    launches = {name: n for key, counts in report.items() if key.endswith("_launches")
                for name, n in counts.items()}
    ate_file = ate_rmse(traj[:, 1:4], gt)
    vertices = sum(ln.startswith("v ") for ln in map_lines)
    features = sum(ln.startswith(("p ", "l ", "f ")) for ln in map_lines)
    failed = stats["frame_count"] - stats["success_count"]
    _say("tum_cli", frames=stats["frame_count"], launches=launches, failed=failed,
         lost=stats["lost_count"], ate_printed_mm=printed and printed.group(1),
         ate_of_trajectory_file_mm=ate_file, ate_bound_mm=ATE_MARGIN * ref["worst_ate_mm"],
         keyframes=stats["keyframe_count"], ba_runs=stats["ba_runs"],
         ba_accepted=stats["ba_accepted"], map_vertices=vertices, map_features=features,
         streamed_at_death=stats["map_streamed"], written_at_end=stats["map_alive_at_end"],
         write_dataset_s=write_s, cli_process_s=cli_s,
         step_ms_mean=1e3 * (stats["total_step_s"] - stats["compile_s"]) / (n - 1))
    problems = []
    for line in (f"{n} frames in {dataset}", "frame 0: success=True", "frame 40: ",
                 "BA: runs=", f"trajectory -> {traj_out}", f"map -> {map_out}"):
        if line not in proc.stdout:
            problems.append(f"no line {line!r} printed")
    if printed is None or int(printed.group(2)) != n \
            or abs(float(printed.group(1)) - ate_file) > 0.051:
        problems.append(f"printed ATE {printed and printed.group(0)!r}, the trajectory "
                        f"file gives {ate_file} mm")
    if traj.shape != (n, 8) or not np.isfinite(traj).all():
        problems.append(f"trajectory file of shape {traj.shape}")
    if not ate_file <= ATE_MARGIN * ref["worst_ate_mm"]:
        problems.append(f"ATE {ate_file} mm over the bound")
    if failed > ref["failed"] or stats["lost_count"] > ref["lost"]:
        problems.append(f"failed/lost {failed}/{stats['lost_count']}")
    if launches != {k: v * (n + stats["warmup_steps"]) for k, v in FUSED_ONLY.items()}:
        problems.append(f"launches {launches}")
    for key in ("ba_runs", "ba_accepted"):
        if stats[key] < ref[key]:
            problems.append(f"{key} {stats[key]} < the least JAX seed's {ref[key]}")
    if vertices == 0 or stats["map_streamed"] < 1 \
            or features != stats["map_streamed"] + stats["map_alive_at_end"]:
        problems.append(f"map file: {vertices} vertices, {features} features, streamed "
                        f"{stats['map_streamed']}, at the end {stats['map_alive_at_end']}")
    if problems:
        raise RuntimeError("tum_cli: " + "; ".join(problems))
    return launches


def run_checkpoint(cam, cfg, device, frames):
    """Phase 11: a run resumed from a checkpoint repeats the straight run to the
    last bit.  Returns the launch counts."""
    n, half = len(frames), len(frames) // 2
    timed = [(g, d, float(i)) for i, (g, d) in enumerate(frames)]
    nvcc.reset_launches()
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as work:
            straight, traj_a, stats_a = runner.run_frames(timed, cam, cfg, seed=SEED,
                                                          device=device)
            first, traj_b, stats_b = runner.run_frames(timed[:half], cam, cfg, seed=SEED,
                                                       device=device)
            path = os.path.join(work, "state.npz")
            t0 = time.perf_counter()
            checkpoint.save_state(first, path)
            save_s = time.perf_counter() - t0
            file_bytes = os.path.getsize(path)
            template = engine.init_state(cam, cfg, seed=SEED + 1, device=device)
            t0 = time.perf_counter()
            loaded = checkpoint.load_state(path, template)
            load_s = time.perf_counter() - t0
            resumed, traj_c, stats_c = runner.run_frames(timed[half:], cam, cfg,
                                                         state=loaded, device=device)
            finals = []
            for name, state in (("straight", straight), ("resumed", resumed)):
                checkpoint.save_state(state, os.path.join(work, name + ".npz"))
                with np.load(os.path.join(work, name + ".npz")) as data:
                    finals.append({k: data[k] for k in data.files})
    finally:
        torch.use_deterministic_algorithms(False)
    launches = nvcc.launch_counts()
    warmups = stats_a.warmup_steps + stats_b.warmup_steps + stats_c.warmup_steps
    a = np.concatenate([traj_a.positions_array(), np.array(traj_a.quaternions)], axis=1)
    b = np.concatenate([np.concatenate([traj_b.positions_array(), traj_c.positions_array()]),
                        np.array(traj_b.quaternions + traj_c.quaternions)], axis=1)
    leaves_differ = [k for k in finals[0] if not np.array_equal(finals[0][k], finals[1][k],
                                                               equal_nan=True)]
    _say("checkpoint", frames=n, resumed_after=half, leaves=len(finals[0]) - 1,
         file_bytes=file_bytes, save_ms=1e3 * save_s, load_ms=1e3 * load_s,
         trajectories_equal=bool(np.array_equal(a, b)), leaves_that_differ=leaves_differ,
         launches=launches)
    if not np.array_equal(a, b) or leaves_differ or finals[0].keys() != finals[1].keys():
        raise RuntimeError("checkpoint: the resumed run differs from the straight run: max "
                           f"|d pose| {np.abs(a - b).max()}, leaves {leaves_differ}")
    if launches != {k: v * (2 * n + warmups) for k, v in FUSED_ONLY.items()}:
        raise RuntimeError(f"checkpoint: launches {launches}")
    return launches


def _sharded_backend_rank(rank, world_size, init_method, out_path, n_frames):
    """One rank of the sharded backend run: rank 0 runs the frames on the card
    and the others serve its refines, all through the same ``run_frames``."""
    dryrun.join_group(rank, world_size, init_method)
    try:
        cam, cfg = config.TUM_FR1, config.SlamConfig()
        frames, gt = [], None
        if rank == 0:
            frames, gt = room_frames(cam, n_frames)
        nvcc.reset_launches()
        _, traj, stats = runner.run_frames(frames, cam, cfg, seed=SEED, ba_every=8,
                                           ba_mesh=dist.group.WORLD, device="cuda")
        if rank == 0:
            report = dataclasses.asdict(stats)
            report.update(ate_rmse_mm=runner.evaluate_against_ground_truth(
                traj, gt)["ate_rmse_mm"], launches=nvcc.launch_counts())
            with open(out_path, "w") as f:
                json.dump(report, f)
        else:
            with open(f"{out_path}.rank{rank}", "w") as f:
                json.dump({"served": stats.ba_runs}, f)
    finally:
        dist.destroy_process_group()


def run_sharded_ba(one_device_stats, one_device_ate, n_frames):
    """Phase 12: the sharded bundle adjustment.  Returns the launch counts of
    the sharded backend run."""
    dry = dryrun.dryrun_multichip(4, device="cuda")
    nccl = dryrun.nccl_single_rank()
    _say("sharded_ba", what="dry run, a solve of 4 iterations, ms",
         gloo_ranks_sharing_the_card=4, single_device=dry["single_device_ms"],
         dense=dry["dense_ms"], pcg=dry["pcg_ms"], nccl_ranks=1,
         nccl_single_device=nccl["single_device_ms"], nccl_dense=nccl["dense_ms"],
         nccl_pcg=nccl["pcg_ms"],
         note="ranks that share one card take turns: this is the collectives' overhead, "
              "not a speed-up")
    with tempfile.TemporaryDirectory() as work:
        out_path = os.path.join(work, "rank0.json")
        dryrun.run_ranks(_sharded_backend_rank, 2, args=(out_path, n_frames), timeout=600)
        with open(out_path) as f:
            got = json.load(f)
        with open(out_path + ".rank1") as f:
            served = json.load(f)["served"]
    ref = JAX_REFERENCE["ba"]
    one = one_device_stats
    later = max(got["ba_runs"] - 1, 1)
    _say("sharded_ba", what="backend path, refines sharded over 2 gloo ranks on the card",
         frames=got["frame_count"], launches=got["launches"],
         failed=got["frame_count"] - got["success_count"], lost=got["lost_count"],
         ate_rmse_mm=got["ate_rmse_mm"], one_device_ate_rmse_mm=one_device_ate,
         ate_bound_mm=ATE_MARGIN * ref["worst_ate_mm"], keyframes=got["keyframe_count"],
         ba_runs=got["ba_runs"], ba_accepted=got["ba_accepted"], served_by_rank_1=served,
         refine_ms=1e3 * (got["ba_total_s"] - got["ba_compile_s"]) / later,
         one_device_refine_ms=1e3 * (one.ba_total_s - one.ba_compile_s)
         / max(one.ba_runs - 1, 1))
    problems = []
    for key in ("keyframe_count", "ba_runs", "ba_accepted", "frame_count", "success_count",
                "lost_count"):
        if got[key] != getattr(one, key):
            problems.append(f"{key} {got[key]}, one device {getattr(one, key)}")
    if served != got["ba_runs"] or got["ba_runs"] < 1:
        problems.append(f"rank 1 served {served} of {got['ba_runs']} refines")
    if not got["ate_rmse_mm"] <= ATE_MARGIN * ref["worst_ate_mm"]:
        problems.append(f"ATE {got['ate_rmse_mm']} mm over the bound")
    if got["launches"] != {k: v * (n_frames + got["warmup_steps"])
                           for k, v in FUSED_ONLY.items()}:
        problems.append(f"launches {got['launches']}")
    if problems:
        raise RuntimeError("sharded_ba: " + "; ".join(problems))
    return got["launches"]


def room_frames(cam, n):
    """The first ``n`` RoomScene orbit frames (depth noise on), their poses and
    their ground-truth positions."""
    scene = synthetic.RoomScene(cam, depth_noise=config.DepthNoiseModel())
    poses = synthetic.orbit_trajectory(JAX_REFERENCE["planes"]["frames"], speed_mm=4.0)[:n]
    frames = [scene.render(q, p) for q, p in poses]
    return frames, np.stack([p for _, p in poses]).astype(np.float64)


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA card",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = _card_line()
    _say("device", card=card, torch=torch.__version__, cuda=torch.version.cuda)

    # one nvcc a source, started together
    with ThreadPoolExecutor(len(nvcc.LIBRARIES)) as pool:
        builds = {f"csrc/{library.source}": pool.submit(library.build)
                  for library in nvcc.LIBRARIES}
        _say("build", **{src: f"{job.result():.1f} s" for src, job in builds.items()})
    for library in nvcc.LIBRARIES:
        for kernel, usage in ptxas_usage(library.log).items():
            _say("ptxas", kernel=kernel, **usage)

    cam = config.TUM_FR1
    cfg = config.SlamConfig()
    poses = synthetic.orbit_trajectory(JAX_REFERENCE["planes"]["frames"], speed_mm=4.0)
    frames, gt = room_frames(cam, len(poses))
    kernels = check_kernels(cam, cfg, device)
    kernels["components"] = check_components(cam, cfg, device, frames)
    tunnel_depths = _tunnel_depths(cam, JAX_REFERENCE["tunnel"]["frames"])
    kernels["cells"] = check_cells(cam, cfg, device, frames, tunnel_depths)
    kernels["cylinders"] = check_cylinders(cam, cfg, device, frames, tunnel_depths)
    kernels["cylinders_global"] = check_large_grids(cfg, device, frames, tunnel_depths)
    kernels["lm_solve"] = check_lm(cam, cfg, device, frames)
    kernels["line_grow"] = check_line_grow(cam, cfg, device)
    kernels["ransac_score"] = check_ransac_score(cam, cfg, device, frames)
    run_graph_phase(cam, cfg, device, frames, card)
    run_backend_graph_phase(cam, device, card)
    cfg_fwd = dataclasses.replace(cfg, mapping=dataclasses.replace(
        cfg.mapping, max_tracked_points=FORWARD_ONLY_TRACKED))
    n_fwd = JAX_REFERENCE["forward_only"]["frames"]
    n_pts = JAX_REFERENCE["points"]["frames"]
    paths = [
        run_path("planes", cam, cfg, device, frames, gt, FUSED_ONLY, reference="planes"),
        run_path("forward_only", cam, cfg_fwd, device, frames[:n_fwd], gt[:n_fwd],
                 {**FUSED_ONLY, "lk_fwd_bwd": 0, "lk_pyramid": 2},
                 reference="forward_only"),
        run_path("points", cam, cfg, device, frames[:n_pts], gt[:n_pts], FUSED_ONLY,
                 with_planes=False, reference="points"),
    ]
    n_lines = JAX_REFERENCE["lines"]["frames"]
    paths.append(run_path("lines", cam, cfg, device, frames[:n_lines], gt[:n_lines],
                          LINE_PATH, with_lines=True, reference="lines"))
    wall_frames, wall_gt = stripe_wall_frames(cam, JAX_REFERENCE["lines_lowtex"]["frames"])
    # lines off on the same wall gates nothing: half the frames show the gap
    paths.append(run_path("lines_lowtex_off", cam, cfg, device, wall_frames[:15],
                          wall_gt[:15], FUSED_ONLY, with_planes=False))
    paths.append(run_path("lines_lowtex", cam, cfg, device, wall_frames, wall_gt, LINE_PATH,
                          with_planes=False, with_lines=True, reference="lines_lowtex"))
    paths.append(run_path("ba", cam, cfg, device, frames, gt, FUSED_ONLY, ba_every=8,
                          reference="ba"))
    n_short = SHORT_RUN_FRAMES
    ba_short = [run_path(name, cam, cfg, device, frames[:n_short], gt[:n_short], FUSED_ONLY,
                         ba_every=8) for name in ("ba_short", "ba_again")]
    if ba_short[0][1] != ba_short[1][1]:
        raise RuntimeError(f"backend path: ATE {ba_short[0][1]!r} mm, then "
                           f"{ba_short[1][1]!r} mm on the same frames")
    paths += ba_short
    n_leg = JAX_REFERENCE["hard"]["frames"]
    legs = {"hard": hard_orbit(cam, n_leg), "roll": room_roll(cam, n_leg),
            "tunnel": tunnel_flight(cam, n_leg)}
    cfg_pred = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, use_motion_model_prediction=True))
    for name, (leg, kw, prediction) in BENCH_LEG_PATHS.items():
        paths.append(run_path(name, cam, cfg_pred if prediction else cfg, device, *legs[leg],
                              FUSED_ONLY, reference=name, **kw))
    hd_frames, hd_gt = room_frames(KV2_HD, HD_FRAMES)
    hd_counts, _, hd_stats = run_path("kv2_hd", KV2_HD, cfg, device, hd_frames, hd_gt,
                                      FUSED_ONLY)
    if hd_stats.success_count != hd_stats.frame_count or hd_stats.lost_count:
        raise RuntimeError(f"kv2_hd path: {hd_stats.success_count} of {hd_stats.frame_count} "
                           f"frames tracked, {hd_stats.lost_count} lost")
    counts = [p[0] for p in paths]
    counts.append(run_tum_cli(cam, frames, poses, gt))
    counts.append(run_checkpoint(cam, cfg, device, frames[:n_short]))
    counts.append(run_sharded_ba(ba_short[0][2], ba_short[0][1], n_short))
    launches = {name: sum(c[name] for c in counts) for name in FUSED_ONLY}
    for name in FUSED_ONLY:
        launches[name] += hd_counts[name] if name != "cylinders" else 0
    launches["cylinders_global"] = hd_counts["cylinders"]

    _say("wall", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[SECOND_PATHS.get(name, name)],
         "replaces": REPLACES[SECOND_PATHS.get(name, name)], "launches": launches[name],
         **measured}
        for name, measured in kernels.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
