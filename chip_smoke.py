"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line of output each (any failure raises, so the last line, the
``{"ok": true, ...}`` object, is printed only when every phase passed):

1. device: a CUDA card must be present (no CPU run); prints
   ``nvidia-smi --query-gpu=name,power.limit``.
2. build: compiles the LK kernels (``rgbd_slam_tpu_torch/csrc/lk.cu``) with nvcc
   from the sources in this checkout.
3. kernels, each against its plain PyTorch version on the card, then both timed
   (median of 20 CUDA-event timings after a warm-up), on a 640x480 RoomScene
   frame pair with the default windows and levels:
   * fused forward-backward LK, 128 FAST points;
   * forward-only LK, 99 FAST points (N % 4 != 0);
   * single-level LK at level 0, seeded with the plain pyramid tracker's level-1
     result doubled.
4. plane path: ``runner.run_frames`` over 60 RoomScene orbit frames at 640x480,
   default ``SlamConfig``, planes on (the default step), seed 0; checks one
   fused-kernel launch per frame, no more failed or lost frames than the JAX
   reference, the ATE bound and planes alive in the map at the end.
5. forward-only path: the same step with ``max_tracked_points=99`` over the
   first 30 frames; checks two forward-only launches and no fused launch a
   frame, failed/lost and the ATE bound of that configuration.
6. points-only path: planes off, the first 30 frames; one fused launch a frame,
   failed/lost and its ATE bound.
7. the kernels' JSON line, the card line again, and the result line.

The JAX references come from ``rgbd_slam_tpu.runner.run_frames`` on the same
frames with seeds 0, 1 and 2, run on a CPU (its XLA LK path) with
``XLA_FLAGS=--xla_cpu_max_isa=AVX2``: the worst ATE-RMSE and the most failed and
lost frames of the three runs.  The port draws other random numbers than JAX,
so its ATE is held to 1.5 x the worst JAX seed.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from rgbd_slam_tpu_torch import config, runner, synthetic
from rgbd_slam_tpu_torch.ops import fast, image, lk_cuda

SEED = 0
#: |kernel - plain| bound on points both versions track: the two sum the window's
#: products in a different order, which can move one convergence test by one
#: Gauss-Newton iteration, and that iteration moves a point by < eps = 0.03 px
TOL_PX = 0.05
ATE_MARGIN = 1.5
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
}
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


def check_kernels(cam, cfg, device):
    """Phase 3: each LK kernel against its plain version at the main path's
    shapes.  Returns {name: (max_abs_err, ms, plain_ms)}."""
    g0, g1 = _room_pair(cam, device)
    kw = _lk_kwargs(cam, cfg.detection)
    p0 = image.build_pyramid(g0, kw["levels"])
    p1 = image.build_pyramid(g1, kw["levels"])
    det = cfg.detection
    bwd = dict(max_roundtrip=det.optical_flow_roundtrip_px,
               bwd_levels=(None if det.optical_flow_backward_depth >= kw["levels"]
                           else det.optical_flow_backward_depth))
    results = {}

    # fused forward-backward, 128 points (the default tracked set)
    pts, valid = _fast_points(g0, cfg.mapping.max_tracked_points)
    k_pts, k_ok = lk_cuda.lk_fwd_bwd(p0, p1, pts, valid, **kw, **bwd)
    torch.cuda.synchronize()
    r_pts, r_ok = lk_cuda.lk_fwd_bwd_reference(p0, p1, pts, valid, **kw, **bwd)
    rt = lk_cuda.roundtrip_px_reference(p0, p1, pts, r_pts, bwd_levels=bwd["bwd_levels"],
                                        **kw)
    near_gate = (rt - bwd["max_roundtrip"]).abs() <= TOL_PX
    err, n_both = _compare("lk_fwd_bwd", k_pts, k_ok, r_pts, r_ok, excused=near_gate)
    results["lk_fwd_bwd"] = (
        err, _median_ms(lambda: lk_cuda.lk_fwd_bwd(p0, p1, pts, valid, **kw, **bwd)),
        _median_ms(lambda: lk_cuda.lk_fwd_bwd_reference(p0, p1, pts, valid, **kw, **bwd)))
    _say("kernel", name="lk_fwd_bwd", points=pts.shape[0], both_ok=n_both,
         near_gate_flag_diffs=int((k_ok != r_ok).sum()), max_abs_err_px=err,
         tol_px=TOL_PX, ms=results["lk_fwd_bwd"][1], plain_ms=results["lk_fwd_bwd"][2])

    # forward-only, at the forward-only path's tracked count
    pts, valid = _fast_points(g0, FORWARD_ONLY_TRACKED)
    k_flow, k_ok = lk_cuda.lk_pyramid(p0, p1, pts, valid, **kw)
    torch.cuda.synchronize()
    r_flow, r_ok = lk_cuda.lk_pyramid_reference(p0, p1, pts, valid, **kw)
    err, n_both = _compare("lk_pyramid", k_flow, k_ok, r_flow, r_ok)
    results["lk_pyramid"] = (
        err, _median_ms(lambda: lk_cuda.lk_pyramid(p0, p1, pts, valid, **kw)),
        _median_ms(lambda: lk_cuda.lk_pyramid_reference(p0, p1, pts, valid, **kw)))
    _say("kernel", name="lk_pyramid", points=pts.shape[0], both_ok=n_both,
         max_abs_err_px=err, tol_px=TOL_PX, ms=results["lk_pyramid"][1],
         plain_ms=results["lk_pyramid"][2])

    # single level 0 from the plain tracker's level-1 result doubled
    g_flow, _ = lk_cuda.lk_pyramid_reference(p0[1:], p1[1:], (pts * 0.5).contiguous(), valid,
                                             **{**kw, "levels": kw["levels"] - 1})
    guesses = (g_flow * 2.0).contiguous()
    lvl = dict(win_h=kw["win_h"], win_w=kw["win_w"], iterations=kw["iterations"],
               eps=kw["eps"])
    k_g, k_ok = lk_cuda.lk_level(p0[0], p1[0], pts, guesses, valid, **lvl)
    torch.cuda.synchronize()
    r_g, r_ok = lk_cuda.lk_level_reference(p0[0], p1[0], pts, guesses, valid, **lvl)
    err, n_both = _compare("lk_level", k_g, k_ok, r_g, r_ok)
    results["lk_level"] = (
        err, _median_ms(lambda: lk_cuda.lk_level(p0[0], p1[0], pts, guesses, valid, **lvl)),
        _median_ms(lambda: lk_cuda.lk_level_reference(p0[0], p1[0], pts, guesses, valid,
                                                      **lvl)))
    _say("kernel", name="lk_level", points=pts.shape[0], both_ok=n_both,
         max_abs_err_px=err, tol_px=TOL_PX, ms=results["lk_level"][1],
         plain_ms=results["lk_level"][2])
    return results


def run_path(name, cam, cfg, device, with_planes, frames, gt, expect_launches):
    """Drive ``runner.run_frames`` over ``frames`` with the launch counts set to 0
    just before; check the launches per frame, failed/lost frames and the ATE
    against the path's JAX reference.  Returns the launch counts."""
    ref = JAX_REFERENCE[name]
    ate_bound = ATE_MARGIN * ref["worst_ate_mm"]
    step_s = []
    lk_cuda.reset_launches()
    state, traj, stats = runner.run_frames(
        frames, cam, cfg, with_planes=with_planes, seed=SEED, device=device,
        on_frame=lambda i, s, o, dt: step_s.append(dt))
    launches = dict(lk_cuda.LAUNCHES)

    ate = runner.evaluate_against_ground_truth(traj, gt)["ate_rmse_mm"]
    failed = stats.frame_count - stats.success_count
    planes_alive = int((state.planes.fid >= 0).sum())
    steady_ms = np.array(step_s[2:]) * 1e3   # past the warm-up
    _say(name, frames=stats.frame_count, launches=launches, failed=failed,
         lost=stats.lost_count, ate_rmse_mm=ate, ate_bound_mm=ate_bound,
         fps_from_frame_3=1e3 * len(steady_ms) / steady_ms.sum(),
         step_ms_median=float(np.median(steady_ms)),
         step_ms_p80=float(np.percentile(steady_ms, 80)), first_frame_s=step_s[0],
         points_alive=int((state.points.fid >= 0).sum()), planes_alive=planes_alive)
    problems = []
    want = {k: v * stats.frame_count for k, v in expect_launches.items()}
    if launches != want:
        problems.append(f"launches {launches}, expected {want}")
    if failed > ref["failed"] or stats.lost_count > ref["lost"]:
        problems.append(f"failed/lost {failed}/{stats.lost_count} > JAX reference "
                        f"{ref['failed']}/{ref['lost']}")
    if not (np.isfinite(traj.positions_array()).all() and ate <= ate_bound):
        problems.append(f"ATE {ate} mm over the {ate_bound} mm bound")
    if with_planes and planes_alive == 0:
        problems.append("no plane alive in the map")
    if problems:
        raise RuntimeError(f"{name} path: " + "; ".join(problems))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on an NVIDIA card",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = _card_line()
    _say("device", card=card, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    lk_cuda.build()
    _say("build", source="csrc/lk.cu", nvcc_s=time.perf_counter() - t0)

    cam = config.TUM_FR1
    cfg = config.SlamConfig()
    kernels = check_kernels(cam, cfg, device)

    scene = synthetic.RoomScene(cam, depth_noise=config.DepthNoiseModel())
    poses = synthetic.orbit_trajectory(JAX_REFERENCE["planes"]["frames"], speed_mm=4.0)
    frames = [scene.render(q, p) for q, p in poses]
    gt = np.stack([p for _, p in poses]).astype(np.float64)
    cfg_fwd = dataclasses.replace(cfg, mapping=dataclasses.replace(
        cfg.mapping, max_tracked_points=FORWARD_ONLY_TRACKED))
    n_fwd = JAX_REFERENCE["forward_only"]["frames"]
    n_pts = JAX_REFERENCE["points"]["frames"]
    launches = run_path("planes", cam, cfg, device, True, frames, gt,
                        {"lk_fwd_bwd": 1, "lk_pyramid": 0, "lk_level": 0})
    fwd_launches = run_path("forward_only", cam, cfg_fwd, device, True, frames[:n_fwd],
                            gt[:n_fwd], {"lk_fwd_bwd": 0, "lk_pyramid": 2, "lk_level": 0})
    run_path("points", cam, cfg, device, False, frames[:n_pts], gt[:n_pts],
             {"lk_fwd_bwd": 1, "lk_pyramid": 0, "lk_level": 0})
    launches["lk_pyramid"] = fwd_launches["lk_pyramid"]

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": "rgbd_slam_tpu_torch/csrc/lk.cu",
         "replaces": REPLACES[name], "launches": launches[name], "max_abs_err": err,
         "ms": ms, "plain_ms": plain_ms}
        for name, (err, ms, plain_ms) in kernels.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
