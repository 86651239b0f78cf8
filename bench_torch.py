"""Benchmark of the PyTorch + CUDA port on one NVIDIA card: ``bench.py``'s legs.

    python bench_torch.py [--full]

Runs the legs of ``bench.py`` through ``rgbd_slam_tpu_torch`` at 640x480 with
``TUM_FR1`` and the default ``SlamConfig``, every frame staged on the card by
``runner.stage_frames``.  Prints the card's name and power limit (``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader``), one line a leg, and as
its last line one JSON object with ``bench.py``'s keys.  Without a CUDA card it
exits 1 and prints no result.

Legs (``bench.py``'s, in its order):

1. throughput: RoomScene orbit frames (4 mm a frame, depth noise on) through
   the step as one CUDA graph (``step_graph.StepGraph``, as ``run_frames``
   runs it) from a fresh state: the first 10 frames warm up (the first records
   the graph), the rest are timed on the host clock with one final
   ``torch.cuda.synchronize()``.  The leg runs twice, each from a fresh state
   and graph, and ``value`` is the first run; then 4 replays under
   ``torch.profiler`` give the graph's kernels and device µs a frame, and the
   device's busy share of a frame at the first run's rate.
2. stage breakdown of the eager step (the stages cannot be told apart inside
   a graph): 4 frames of a second state (after 6 of warm-up) under
   ``torch.profiler`` with ``with_flops=True``, each stage function of
   ``tools/profile_torch_step.py`` in a profiler range: device µs a frame by
   stage, and the FLOPs the profiler counts over 67 TFLOP/s (``chip_smoke.PEAK_F32_FLOPS``,
   f32 outside the tensor cores); ``utilization_flops_ops`` names the ops those
   FLOPs come from (the profiler counts matrix products, convolutions and a few
   elementwise ops, nothing else).
3. accuracy: ``runner.run_frames`` over the same frames with ``ba_every=8`` and
   without the backend: ATE-RMSE of each, the backend's counts and its ms
   (``RunStats.backend_ms``: the first refine and graph solve, which record
   their CUDA graphs, and the mean of the later ones); the median and
   p80 of the host's time between two frames' hand-overs (``on_frame``'s
   ``dt``; the runner hands each frame over one replay behind) from frame 10
   of the run without the backend.
4. hard scene: ``HardRoomScene`` on the orbit, ``ba_every=8``, seeds 0, 1, 2,
   without and with motion-model prediction: ATE per seed (sorted, as
   ``bench.py`` lists them, and in seed order), lost frames per seed.
5. roll: the RoomScene on ``roll_trajectory`` over ``bench.py``'s 120-frame
   period (the first ``ate_frames`` frames of it), ``ba_every=8``.
6. lines: planes and lines on over the first ``lines_frames`` room frames: the
   runner's ATE, then the graph step loop's frames/s as in leg 1.
7. low-texture lines: ``StripeWallScene(texture_scale=0.03,
   stripe_period_z=2400.0)`` on a lateral run, planes off, lines on and off,
   seeds 0-4 (the JAX reference spreads 3.7x over seeds): median and per seed.
8. tunnel: ``TunnelScene`` on ``tunnel_trajectory``, planes on, with and
   without ``ba_every=8``.

Frame counts: by default 60 (``ate_frames``, also the roll leg), 60
(``hard_frames``), 30 (``lines_frames``, also the low-texture leg) and 60
(``tunnel_frames``), about 1,100 frames; ``--full`` runs ``bench.py``'s 120 /
300 / 80 / 100 (and the roll leg's 120), about 3,500.  ``vs_baseline`` is
frames/s over 400, as ``bench.py`` computes it; it is no bound.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time

import numpy as np
import torch

from rgbd_slam_tpu_torch import config, engine, runner, step_graph, synthetic
from rgbd_slam_tpu_torch.ops import nvcc
from rgbd_slam_tpu_torch.synthetic import _quat_from_euler

#: (ate_frames, hard_frames, lines_frames, tunnel_frames): the default, and
#: ``bench.py``'s with ``--full``
DEFAULT_FRAMES = (60, 60, 30, 60)
FULL_FRAMES = (120, 300, 80, 100)
#: frames of ``bench.py``'s roll trajectory: one roll period
ROLL_PERIOD_FRAMES = 120
#: frames before the throughput legs start their clock
WARMUP_FRAMES = 10
#: frames under the profiler, after their state's warm-up
PROFILED_FRAMES, PROFILE_WARMUP = 4, 6
HARD_SEEDS = (0, 1, 2)
LOWTEX_SEEDS = (0, 1, 2, 3, 4)


def tunnel_trajectory(n_frames):
    """Forward flight along the tunnel axis (world x) with slow yaw: the
    trajectory of ``bench.py``'s tunnel leg."""
    poses = []
    for i in range(n_frames):
        quat = _quat_from_euler(np.radians(0.03) * i, 0.0, 0.0)
        pos = np.array([8.0 * i, 0.3 * i, 0.2 * i], np.float32)
        poses.append((quat, pos))
    return poses


def _render(scene, poses):
    return [scene.render(q, p) for q, p in poses], \
        np.stack([p for _, p in poses]).astype(np.float64)


def room_orbit(cam, n):
    """(frames, ground-truth positions) of the room orbit."""
    return _render(synthetic.RoomScene(cam, depth_noise=config.DepthNoiseModel()),
                   synthetic.orbit_trajectory(n, speed_mm=4.0))


def hard_orbit(cam, n):
    """The hard scene on the orbit; a scene object of its own per sequence (its
    holes and noise bursts follow its frame counter)."""
    return _render(synthetic.HardRoomScene(cam, depth_noise=config.DepthNoiseModel()),
                   synthetic.orbit_trajectory(n, speed_mm=4.0))


def room_roll(cam, n):
    """The room on the first ``n`` frames of the 120-frame roll period."""
    return _render(synthetic.RoomScene(cam, depth_noise=config.DepthNoiseModel()),
                   synthetic.roll_trajectory(ROLL_PERIOD_FRAMES)[:n])


def tunnel_flight(cam, n):
    return _render(synthetic.TunnelScene(cam), tunnel_trajectory(n))


def stripe_wall(cam, n):
    return _render(synthetic.StripeWallScene(cam, texture_scale=0.03,
                                             stripe_period_z=2400.0),
                   synthetic.lateral_trajectory(n, speed_mm=4.0))


def _say(leg: str, **fields):
    print(f"[{leg}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def _ate(traj, gt):
    return runner.evaluate_against_ground_truth(traj, gt)["ate_rmse_mm"]


def step_loop_fps(frames, cam, cfg, device, with_lines=False):
    """Frames/s of the bare loop of the graph step past ``WARMUP_FRAMES``: host
    clock, one device sync at the end.  Returns (fps, the last output, copied
    out of the graph's buffers)."""
    graph = step_graph.StepGraph(engine.init_state(cam, cfg, seed=0, device=device), cam,
                                 cfg, with_lines=with_lines)
    try:
        for gray, depth in frames[:WARMUP_FRAMES]:
            graph.step(gray, depth)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for gray, depth in frames[WARMUP_FRAMES:]:
            _, out = graph.step(gray, depth)
        torch.cuda.synchronize()
        fps = (len(frames) - WARMUP_FRAMES) / (time.perf_counter() - t0)
        return fps, step_graph.clone_tree(out)
    finally:
        graph.close()


def graph_device_profile(frames, cam, cfg, device):
    """Kernels and device µs a frame of the graph step: ``PROFILED_FRAMES``
    replays under ``torch.profiler`` after ``PROFILE_WARMUP`` frames
    (``chip_smoke.profile_replays``)."""
    from chip_smoke import profile_replays

    graph = step_graph.StepGraph(engine.init_state(cam, cfg, seed=0, device=device), cam,
                                 cfg)
    try:
        for gray, depth in frames[:PROFILE_WARMUP]:
            graph.step(gray, depth)
        torch.cuda.synchronize()
        got = profile_replays(graph, frames[PROFILE_WARMUP:PROFILE_WARMUP + PROFILED_FRAMES])
    finally:
        graph.close()
    return got["kernels_per_frame"], got["device_us_per_frame"]


def stage_breakdown(frames, cam, cfg, device):
    """Device µs a frame by stage, in all, and the FLOPs the profiler counts,
    over ``PROFILED_FRAMES`` frames of a warmed state."""
    from torch.profiler import ProfilerActivity, profile

    from tools.profile_torch_step import StageRanges, device_breakdown

    state = engine.init_state(cam, cfg, seed=0, device=device)
    for gray, depth in frames[:PROFILE_WARMUP]:
        state, _ = engine.step(state, gray, depth, cam, cfg)
    torch.cuda.synchronize()
    ranges = StageRanges()
    ranges.install()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     with_flops=True) as prof:
            for gray, depth in frames[PROFILE_WARMUP:PROFILE_WARMUP + PROFILED_FRAMES]:
                state, _ = engine.step(state, gray, depth, cam, cfg)
            torch.cuda.synchronize()
    finally:
        ranges.remove()
    return device_breakdown(prof, PROFILED_FRAMES)


def run(frames, gt, cam, cfg, device, seed=0, **kw):
    """``runner.run_frames`` over staged frames.  Returns (ATE, RunStats, the
    per-frame times the runner reports)."""
    step_s = []
    _, traj, stats = runner.run_frames(frames, cam, cfg, seed=seed, device=device,
                                       on_frame=lambda i, s, o, dt: step_s.append(dt), **kw)
    return _ate(traj, gt), stats, step_s


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true", help="bench.py's frame counts")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device; this script runs only on an NVIDIA card",
              file=sys.stderr)
        return 1
    from chip_smoke import PEAK_F32_FLOPS, _card_line

    device = torch.device("cuda", 0)
    card = _card_line()
    print(card, flush=True)
    n_ate, n_hard, n_lines, n_tunnel = FULL_FRAMES if args.full else DEFAULT_FRAMES
    cam, cfg = config.TUM_FR1, config.SlamConfig()
    cfg_pred = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, use_motion_model_prediction=True))
    nvcc.reset_launches()
    t_start = time.perf_counter()

    frames_np, gt = room_orbit(cam, n_ate)
    frames = runner.stage_frames(frames_np, device=device)
    t0 = time.perf_counter()
    fps, last = step_loop_fps(frames, cam, cfg, device)
    fps_again, _ = step_loop_fps(frames, cam, cfg, device)
    final_err = float(torch.linalg.vector_norm(
        last.position.double().cpu() - torch.as_tensor(gt[-1])))
    graph_kernels, device_us = graph_device_profile(frames, cam, cfg, device)
    stages, eager_device_us, flops, flop_ops = stage_breakdown(frames, cam, cfg, device)
    wall_us = 1e6 / fps
    _say("throughput", fps=fps, fps_second_run=fps_again, device_us_per_frame=device_us,
         kernels_per_frame=graph_kernels, device_busy_fraction=device_us / wall_us,
         eager_device_us_per_frame=eager_device_us, eager_stage_us=stages,
         leg_s=time.perf_counter() - t0)

    t0 = time.perf_counter()
    ate_on, stats, _ = run(frames, gt, cam, cfg, device, ba_every=8)
    ate_off, stats_off, step_s = run(frames, gt, cam, cfg, device)
    steady_ms = np.array(step_s[1 + runner.SUMMARY_BATCH:]) * 1e3   # past the warm-up
    _say("accuracy", ate_ba_on_mm=ate_on, ate_ba_off_mm=ate_off, keyframes=stats.keyframe_count,
         ba_runs=stats.ba_runs, ba_accepted=stats.ba_accepted,
         failed=stats.frame_count - stats.success_count, lost=stats.lost_count,
         failed_ba_off=stats_off.frame_count - stats_off.success_count,
         **stats.backend_ms(), leg_s=time.perf_counter() - t0)

    t0 = time.perf_counter()
    hard_np, hard_gt = hard_orbit(cam, n_hard)
    hard = runner.stage_frames(hard_np, device=device)
    hard_runs = {}
    for name, run_cfg in (("off", cfg), ("pred", cfg_pred)):
        hard_runs[name] = [run(hard, hard_gt, cam, run_cfg, device, seed=seed, ba_every=8)[:2]
                           for seed in HARD_SEEDS]
        _say("hard", prediction=name == "pred",
             ate_mm=[a for a, _ in hard_runs[name]],
             lost=[s.lost_count for _, s in hard_runs[name]],
             failed=[s.frame_count - s.success_count for _, s in hard_runs[name]],
             keyframes=[s.keyframe_count for _, s in hard_runs[name]],
             ba_runs=[s.ba_runs for _, s in hard_runs[name]],
             ba_dropped_landmarks=[s.ba_dropped_landmarks for _, s in hard_runs[name]])
    _say("hard", leg_s=time.perf_counter() - t0)

    t0 = time.perf_counter()
    roll_np, roll_gt = room_roll(cam, ROLL_PERIOD_FRAMES if args.full else n_ate)
    roll_ate, roll_stats, _ = run(runner.stage_frames(roll_np, device=device), roll_gt, cam,
                                  cfg, device, ba_every=8)
    _say("roll", ate_mm=roll_ate, lost=roll_stats.lost_count,
         failed=roll_stats.frame_count - roll_stats.success_count, leg_s=time.perf_counter() - t0)

    t0 = time.perf_counter()
    lines_ate, lines_stats, _ = run(frames[:n_lines], gt[:n_lines], cam, cfg, device,
                                    with_lines=True)
    lines_fps, _ = step_loop_fps(frames[:n_lines], cam, cfg, device, with_lines=True)
    _say("lines", ate_mm=lines_ate, fps=lines_fps, lost=lines_stats.lost_count,
         leg_s=time.perf_counter() - t0)

    t0 = time.perf_counter()
    wall_np, wall_gt = stripe_wall(cam, n_lines)
    wall = runner.stage_frames(wall_np, device=device)
    lowtex = {on: [run(wall, wall_gt, cam, cfg, device, seed=seed, with_planes=False,
                       with_lines=on)[0] for seed in LOWTEX_SEEDS] for on in (True, False)}
    _say("lowtex", lines_on_mm=lowtex[True], lines_off_mm=lowtex[False],
         leg_s=time.perf_counter() - t0)

    t0 = time.perf_counter()
    tun_np, tun_gt = tunnel_flight(cam, n_tunnel)
    tun = runner.stage_frames(tun_np, device=device)
    tunnel_off, tunnel_off_stats, _ = run(tun, tun_gt, cam, cfg, device)
    tunnel_on, tunnel_on_stats, _ = run(tun, tun_gt, cam, cfg, device, ba_every=8)
    _say("tunnel", ate_ba_on_mm=tunnel_on, ate_ba_off_mm=tunnel_off,
         lost=[tunnel_on_stats.lost_count, tunnel_off_stats.lost_count],
         leg_s=time.perf_counter() - t0)

    def ates(name):
        return [a for a, _ in hard_runs[name]]

    def lost(name):
        return [s.lost_count for _, s in hard_runs[name]]

    result = {
        "metric": "frames_per_second_per_chip",
        "value": fps,
        "unit": "fps@640x480",
        "vs_baseline": fps / 400.0,
        "value_second_run": fps_again,
        "stage_us_per_frame": stages,
        "device_us_per_frame": device_us,
        "kernels_per_frame": graph_kernels,
        "eager_device_us_per_frame": eager_device_us,
        "device_busy_fraction": device_us / wall_us,
        "device_utilization_vs_peak": flops / (eager_device_us * 1e-6) / PEAK_F32_FLOPS,
        "utilization_flops_ops": flop_ops,
        "utilization_peak_flops": PEAK_F32_FLOPS,
        "step_ms_batch_median": float(np.median(steady_ms)),
        "step_ms_batch_p80": float(np.percentile(steady_ms, 80)),
        "ate_rmse_mm": ate_on,
        "ate_ba_off_mm": ate_off,
        "ate_frames": n_ate,
        "ate_hard_mm": statistics.median(ates("off")),
        "ate_hard_seeds_mm": sorted(ates("off")),
        "ate_hard_by_seed_mm": ates("off"),
        "ate_hard_pred_mm": statistics.median(ates("pred")),
        "ate_hard_pred_seeds_mm": sorted(ates("pred")),
        "ate_hard_pred_by_seed_mm": ates("pred"),
        "hard_seeds": list(HARD_SEEDS),
        "hard_frames": n_hard,
        "hard_lost_frames": max(lost("off")),
        "hard_lost_frames_seeds": lost("off"),
        "hard_lost_frames_pred": max(lost("pred")),
        "hard_lost_frames_pred_seeds": lost("pred"),
        "ate_roll_mm": roll_ate,
        "roll_lost_frames": roll_stats.lost_count,
        "roll_frames": len(roll_np),
        "ate_lines_mm": lines_ate,
        "lines_fps": lines_fps,
        "lines_frames": n_lines,
        "ate_lowtex_lines_mm": statistics.median(lowtex[True]),
        "ate_lowtex_lines_seeds_mm": lowtex[True],
        "ate_lowtex_nolines_mm": statistics.median(lowtex[False]),
        "ate_lowtex_nolines_seeds_mm": lowtex[False],
        "lowtex_seeds": list(LOWTEX_SEEDS),
        "ate_tunnel_mm": tunnel_on,
        "ate_tunnel_ba_off_mm": tunnel_off,
        "tunnel_frames": n_tunnel,
        "final_pose_error_mm": final_err,
        "tracking_success": bool(last.success),
        "ba_iters_per_s": stats.ba_iters_per_s,
        "ba_runs": stats.ba_runs,
        "ba_accepted": stats.ba_accepted,
        **stats.backend_ms(),
        **{f"{library.stem}_launches": dict(library.launches)
           for library in nvcc.LIBRARIES if library.launches},
        "card": card,
        "torch": torch.__version__,
        "total_s": time.perf_counter() - t_start,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
