"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line of output each (any failure raises, so the last line, the
``{"ok": true, ...}`` object, is printed only when every phase passed):

1. device: a CUDA card must be present (no CPU run); prints
   ``nvidia-smi --query-gpu=name,power.limit``.
2. build: compiles the LK kernels (``rgbd_slam_tpu_torch/csrc/lk.cu``) with nvcc
   from the sources in this checkout; prints the seconds and what ptxas says of
   each kernel's registers and spills.
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
   computes pyramidal LK, so ``library_ms`` is null.
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
   first 30 frames twice, which must give the same ATE to the last bit.
10. ``tum_cli``: the 60 frames written as a TUM directory (8-bit RGB and 16-bit
    depth PNGs by this script's own writer, the three list files, a camera YAML
    whose depth camera sits 25 mm off the RGB camera, the depth maps rendered
    from there), then ``python -m rgbd_slam_tpu_torch.cli ... --ba 8
    --stream-map --native-loader`` as a subprocess: exit 0, 60 trajectory lines
    of 8 fields, the printed ATE within its bound and equal to the ATE of the
    trajectory file, 0 failed and lost, one fused launch a frame, a map file
    with as many features as the run says it streamed and wrote at the end, at
    least one of them streamed when it died.
11. ``checkpoint``: 30 frames straight; 15 frames, ``save_state``,
    ``load_state`` into a fresh template, 15 more; both with
    ``torch.use_deterministic_algorithms(True)``; trajectories and final states
    equal to the last bit.
12. ``sharded_ba``: ``dryrun.dryrun_multichip(4)``: four ``gloo`` processes that
    share the card, ``dense`` and ``pcg`` against the single-device solve;
    ``dryrun.nccl_single_rank()``; then the backend path over the 30 frames with
    the refines sharded over 2 ranks: the same keyframes, refines and accepted
    counts as one device, the ATE within the backend bound.  Processes that
    share one card take turns on it, so the times printed beside the
    single-device ones measure what the collectives cost, not a speed-up.
13. the kernels' JSON line (launches summed over all paths), the card line
    again, and the result line.

``run_frames`` reads the frames' summaries in batches of 8, so the per-frame
times a path prints are means over a batch; ``fps_from_frame_10`` leaves out
frame 0 and the first batch, which hold the warm-up.

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

import dataclasses
import json
import os
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from rgbd_slam_tpu_torch import config, dryrun, engine, runner, synthetic
from rgbd_slam_tpu_torch.io import checkpoint
from rgbd_slam_tpu_torch.io.trajectory import ate_rmse
from rgbd_slam_tpu_torch.ops import fast, image, lk_cuda
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
}
#: frames of the backend path's repeat, of the checkpoint phase's straight run
#: and of the sharded backend run
SHORT_RUN_FRAMES = 30
#: the ``tum_cli`` rig: the depth camera sits this far along the RGB camera's x
RIG_BASELINE_MM = 25.0
#: one fused forward-backward launch a frame: every path but the forward-only one
FUSED_ONLY = {"lk_fwd_bwd": 1, "lk_pyramid": 0, "lk_level": 0}
#: the Pallas kernel each CUDA kernel replaces
REPLACES = {"lk_fwd_bwd": "rgbd_slam_tpu/ops/pallas_lk.py:408",
            "lk_pyramid": "rgbd_slam_tpu/ops/pallas_lk.py:472",
            "lk_level": "rgbd_slam_tpu/ops/pallas_lk.py:514"}


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
        kernel = re.search(r"lk_\w+_kernel", name)
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


def run_path(name, cam, cfg, device, frames, gt, expect_launches, with_planes=True,
             with_lines=False, ba_every=None, reference=None):
    """Drive ``runner.run_frames`` over ``frames`` with the launch counts set to 0
    just before; check the launches per frame, failed/lost frames and the ATE
    against the path's JAX reference (``reference=None``: print only), lines
    alive and matched when lines are on, and the backend's counts when it is.
    Returns (launch counts, ATE, RunStats)."""
    ref = JAX_REFERENCE.get(reference)
    step_s, line_matches = [], []

    def on_frame(i, state, out, dt):
        step_s.append(dt)
        line_matches.append(out.n_line_matches)

    lk_cuda.reset_launches()
    state, traj, stats = runner.run_frames(
        frames, cam, cfg, with_planes=with_planes, with_lines=with_lines,
        ba_every=ba_every, seed=SEED, device=device, on_frame=on_frame)
    launches = dict(lk_cuda.LAUNCHES)

    ate = runner.evaluate_against_ground_truth(traj, gt)["ate_rmse_mm"]
    failed = stats.frame_count - stats.success_count
    planes_alive = int((state.planes.fid >= 0).sum())
    lines_alive = int((state.lines.fid >= 0).sum())
    frames_with_line_matches = int((torch.stack(line_matches) > 0).sum())
    steady_ms = np.array(step_s[1 + runner.SUMMARY_BATCH:]) * 1e3   # past the warm-up
    fields = dict(
        frames=stats.frame_count, launches=launches, failed=failed, lost=stats.lost_count,
        ate_rmse_mm=ate, ate_bound_mm=ATE_MARGIN * ref["worst_ate_mm"] if ref else None,
        fps_from_frame_10=1e3 * len(steady_ms) / steady_ms.sum(),
        step_ms_median=float(np.median(steady_ms)),
        step_ms_p80=float(np.percentile(steady_ms, 80)), first_frame_s=step_s[0],
        points_alive=int((state.points.fid >= 0).sum()), planes_alive=planes_alive)
    if with_lines:
        fields.update(lines_alive=lines_alive,
                      frames_with_line_matches=frames_with_line_matches)
    if ba_every:
        later_refines = max(stats.ba_runs - 1, 1)
        later_solves = max(stats.graph_solves - 1, 1)
        fields.update(
            keyframes=stats.keyframe_count, ba_runs=stats.ba_runs,
            ba_accepted=stats.ba_accepted, graph_solves=stats.graph_solves,
            first_refine_ms=1e3 * stats.ba_compile_s,
            refine_ms=1e3 * (stats.ba_total_s - stats.ba_compile_s) / later_refines,
            first_graph_solve_ms=1e3 * stats.graph_first_s,
            graph_solve_ms=1e3 * (stats.graph_total_s - stats.graph_first_s) / later_solves,
            ba_dropped_landmarks=stats.ba_dropped_landmarks,
            ba_dropped_obs=stats.ba_dropped_obs, backend_uploads=stats.backend_uploads,
            backend_readbacks=stats.backend_readbacks)
    _say(name, **fields)
    problems = []
    want = {k: v * stats.frame_count for k, v in expect_launches.items()}
    if launches != want:
        problems.append(f"launches {launches}, expected {want}")
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
    if with_planes and planes_alive == 0:
        problems.append("no plane alive in the map")
    if with_lines and (lines_alive == 0 or frames_with_line_matches == 0):
        problems.append(f"{lines_alive} lines alive, {frames_with_line_matches} frames "
                        "with line matches")
    if ba_every:
        solves = stats.ba_runs + stats.graph_solves
        if (stats.backend_uploads, stats.backend_readbacks) != (solves, solves):
            problems.append(f"{stats.backend_uploads} copies to the device and "
                            f"{stats.backend_readbacks} reads back for {solves} solves")
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
    for name, lines in (("rgb.txt", rgb_lines), ("depth.txt", depth_lines),
                        ("groundtruth.txt", gt_lines)):
        with open(os.path.join(dataset, name), "w") as f:
            f.write("\n".join(lines))
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
    stats, launches = report["stats"], report["lk_launches"]
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
    if launches != {k: v * n for k, v in FUSED_ONLY.items()}:
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
    lk_cuda.reset_launches()
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as work:
            straight, traj_a, _ = runner.run_frames(timed, cam, cfg, seed=SEED, device=device)
            first, traj_b, _ = runner.run_frames(timed[:half], cam, cfg, seed=SEED,
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
            resumed, traj_c, _ = runner.run_frames(timed[half:], cam, cfg, state=loaded,
                                                   device=device)
            finals = []
            for name, state in (("straight", straight), ("resumed", resumed)):
                checkpoint.save_state(state, os.path.join(work, name + ".npz"))
                with np.load(os.path.join(work, name + ".npz")) as data:
                    finals.append({k: data[k] for k in data.files})
    finally:
        torch.use_deterministic_algorithms(False)
    launches = dict(lk_cuda.LAUNCHES)
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
    if launches != {k: v * 2 * n for k, v in FUSED_ONLY.items()}:
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
        lk_cuda.reset_launches()
        _, traj, stats = runner.run_frames(frames, cam, cfg, seed=SEED, ba_every=8,
                                           ba_mesh=dist.group.WORLD, device="cuda")
        if rank == 0:
            report = dataclasses.asdict(stats)
            report.update(ate_rmse_mm=runner.evaluate_against_ground_truth(
                traj, gt)["ate_rmse_mm"], launches=dict(lk_cuda.LAUNCHES))
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
    if got["launches"] != {k: v * n_frames for k, v in FUSED_ONLY.items()}:
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
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA card",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = _card_line()
    _say("device", card=card, torch=torch.__version__, cuda=torch.version.cuda)

    _say("build", source="csrc/lk.cu", nvcc_s=lk_cuda.build())
    for kernel, usage in ptxas_usage(lk_cuda.BUILD_LOG).items():
        _say("ptxas", kernel=kernel, **usage)

    cam = config.TUM_FR1
    cfg = config.SlamConfig()
    kernels = check_kernels(cam, cfg, device)

    poses = synthetic.orbit_trajectory(JAX_REFERENCE["planes"]["frames"], speed_mm=4.0)
    frames, gt = room_frames(cam, len(poses))
    cfg_fwd = dataclasses.replace(cfg, mapping=dataclasses.replace(
        cfg.mapping, max_tracked_points=FORWARD_ONLY_TRACKED))
    n_fwd = JAX_REFERENCE["forward_only"]["frames"]
    n_pts = JAX_REFERENCE["points"]["frames"]
    paths = [
        run_path("planes", cam, cfg, device, frames, gt, FUSED_ONLY, reference="planes"),
        run_path("forward_only", cam, cfg_fwd, device, frames[:n_fwd], gt[:n_fwd],
                 {"lk_fwd_bwd": 0, "lk_pyramid": 2, "lk_level": 0}, reference="forward_only"),
        run_path("points", cam, cfg, device, frames[:n_pts], gt[:n_pts], FUSED_ONLY,
                 with_planes=False, reference="points"),
    ]
    n_lines = JAX_REFERENCE["lines"]["frames"]
    paths.append(run_path("lines", cam, cfg, device, frames[:n_lines], gt[:n_lines],
                          FUSED_ONLY, with_lines=True, reference="lines"))
    wall = synthetic.StripeWallScene(cam, texture_scale=0.03, stripe_period_z=2400.0)
    wall_poses = synthetic.lateral_trajectory(JAX_REFERENCE["lines_lowtex"]["frames"],
                                              speed_mm=4.0)
    wall_frames = [wall.render(q, p) for q, p in wall_poses]
    wall_gt = np.stack([p for _, p in wall_poses]).astype(np.float64)
    # lines off on the same wall gates nothing: half the frames show the gap
    paths.append(run_path("lines_lowtex_off", cam, cfg, device, wall_frames[:15],
                          wall_gt[:15], FUSED_ONLY, with_planes=False))
    paths.append(run_path("lines_lowtex", cam, cfg, device, wall_frames, wall_gt, FUSED_ONLY,
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
    counts = [p[0] for p in paths]
    counts.append(run_tum_cli(cam, frames, poses, gt))
    counts.append(run_checkpoint(cam, cfg, device, frames[:n_short]))
    counts.append(run_sharded_ba(ba_short[0][2], ba_short[0][1], n_short))
    launches = {name: sum(c[name] for c in counts) for name in kernels}

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": "rgbd_slam_tpu_torch/csrc/lk.cu",
         "replaces": REPLACES[name], "launches": launches[name], **measured}
        for name, measured in kernels.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
