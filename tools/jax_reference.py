"""The JAX reference runs behind ``chip_smoke.py``'s ``JAX_REFERENCE`` table.

    python tools/jax_reference.py [--paths lines lines_lowtex ba tum] [--seeds 0 1 2]

Runs ``rgbd_slam_tpu.runner.run_frames`` on a CPU (XLA's code capped at AVX2, as
the repo's tests run it) over the frames ``chip_smoke.py`` renders for each
path, at 640x480 with ``TUM_FR1`` and the default ``SlamConfig``, once per seed,
and prints one JSON line per run and one summary line per path: the worst
ATE-RMSE, the most failed and lost frames and, for the backend path, the least
keyframe, refine and accepted-refine counts over the seeds.  A seed spread of
more than 2x in ATE is flagged (``spread_over_2x``): take 5 seeds then.  The
``tum`` path is the backend path on a calibrated rig: the arrays a TUM directory
of the same frames decodes to, with a depth camera off the RGB camera's axis, so
that the runner rectifies every depth map.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from pathlib import Path

if "xla_cpu_max_isa" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX2"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from rgbd_slam_tpu import runner, synthetic  # noqa: E402
from rgbd_slam_tpu.config import (TUM_FR1, CameraSetup, DepthNoiseModel,  # noqa: E402
                                  SlamConfig)

#: tracked-set capacity of chip_smoke's forward-only path
FORWARD_ONLY_TRACKED = 99


def _room(cam, n):
    scene = synthetic.RoomScene(cam, depth_noise=DepthNoiseModel())
    poses = synthetic.orbit_trajectory(60, speed_mm=4.0)[:n]
    return [scene.render(q, p) for q, p in poses], poses


def _stripe_wall(cam, n):
    scene = synthetic.StripeWallScene(cam, texture_scale=0.03, stripe_period_z=2400.0)
    poses = synthetic.lateral_trajectory(n, speed_mm=4.0)
    return [scene.render(q, p) for q, p in poses], poses


#: the ``tum`` path's rig: the depth camera sits 25 mm along the RGB camera's x
RIG_BASELINE_MM = 25.0
TUM_RIG = CameraSetup(rgb=TUM_FR1, depth=TUM_FR1, depth_to_rgb=(
    (1.0, 0.0, 0.0, RIG_BASELINE_MM), (0.0, 1.0, 0.0, 0.0), (0.0, 0.0, 1.0, 0.0),
    (0.0, 0.0, 0.0, 1.0)))


def _tum_rig(cam, n):
    """The room orbit as ``chip_smoke.py``'s ``tum_cli`` phase writes and decodes
    it: gray from the RGB camera's pose, cut to 8 bits; depth from the depth
    camera's pose (``RIG_BASELINE_MM`` along the RGB camera's x, a scene object of
    its own for the noise), cut to the 0.2 mm steps of a 16-bit TUM depth PNG."""
    rgb_scene = synthetic.RoomScene(cam)
    depth_scene = synthetic.RoomScene(cam, depth_noise=DepthNoiseModel())
    poses = synthetic.orbit_trajectory(60, speed_mm=4.0)[:n]
    frames = []
    for q, p in poses:
        gray = np.clip(rgb_scene.render(q, p)[0], 0, 255).astype(np.uint8)
        p_depth = np.asarray(p) + runner._np_quat_rotate(q, [RIG_BASELINE_MM, 0.0, 0.0])
        d16 = np.clip(depth_scene.render(q, p_depth)[1] * 5.0, 0, 65535).astype(np.uint16)
        frames.append((gray.astype(np.float32), d16.astype(np.float32) / 5.0))
    return frames, poses


#: path -> (frames maker, frame count, run_frames keywords, tracked-set cap or None)
PATHS = {
    "planes": (_room, 60, dict(with_planes=True), None),
    "forward_only": (_room, 30, dict(with_planes=True), FORWARD_ONLY_TRACKED),
    "points": (_room, 30, dict(with_planes=False), None),
    "lines": (_room, 30, dict(with_planes=True, with_lines=True), None),
    "lines_lowtex": (_stripe_wall, 30, dict(with_planes=False, with_lines=True), None),
    "lines_lowtex_off": (_stripe_wall, 30, dict(with_planes=False), None),
    "ba": (_room, 60, dict(with_planes=True, ba_every=8), None),
    "tum": (_tum_rig, 60, dict(with_planes=True, ba_every=8, camera_setup=TUM_RIG), None),
}


def run(path: str, seed: int):
    make, n, kw, tracked = PATHS[path]
    cam, cfg = TUM_FR1, SlamConfig()
    if tracked is not None:
        cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(
            cfg.mapping, max_tracked_points=tracked))
    frames, poses = make(cam, n)
    gt = np.stack([p for _, p in poses]).astype(np.float64)
    line_matches = []
    state, traj, stats = runner.run_frames(
        frames, cam, cfg, seed=seed,
        on_frame=lambda i, s, o, dt: line_matches.append(int(o.n_line_matches)), **kw)
    ate = runner.evaluate_against_ground_truth(traj, gt)["ate_rmse_mm"]
    return {"path": path, "seed": seed, "frames": stats.frame_count, "ate_rmse_mm": ate,
            "failed": stats.frame_count - stats.success_count, "lost": stats.lost_count,
            "lines_alive": int((np.asarray(state.lines.fid) >= 0).sum()),
            "max_line_matches": max(line_matches),
            "frames_with_line_matches": int(sum(m > 0 for m in line_matches)),
            "keyframes": stats.keyframe_count, "ba_runs": stats.ba_runs,
            "ba_accepted": stats.ba_accepted}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", nargs="+", default=["lines", "lines_lowtex", "ba"],
                    choices=sorted(PATHS))
    ap.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2])
    args = ap.parse_args()
    for path in args.paths:
        runs = [run(path, seed) for seed in args.seeds]
        for r in runs:
            print(json.dumps(r), flush=True)
        ates = [r["ate_rmse_mm"] for r in runs]
        print(json.dumps({
            "path": path, "seeds": args.seeds, "frames": runs[0]["frames"],
            "worst_ate_mm": max(ates), "spread_over_2x": max(ates) > 2.0 * min(ates),
            "failed": max(r["failed"] for r in runs), "lost": max(r["lost"] for r in runs),
            "keyframes": min(r["keyframes"] for r in runs),
            "ba_runs": min(r["ba_runs"] for r in runs),
            "ba_accepted": min(r["ba_accepted"] for r in runs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
