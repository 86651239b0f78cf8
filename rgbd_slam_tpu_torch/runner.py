"""Sequence runner: drive the engine over frames and record the trajectory and
timings (port of ``run_frames`` in ``rgbd_slam_tpu/runner.py``, without the BA
backend and the map writer).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from . import engine
from .config import CameraIntrinsics, SlamConfig
from .io.trajectory import Trajectory, ate_rmse


@dataclass
class RunStats:
    """Wall-clock accounting.  ``compile_s`` is the first frame's time, which
    includes the kernel build and device warm-up."""
    frame_count: int = 0
    success_count: int = 0
    lost_count: int = 0
    total_step_s: float = 0.0
    compile_s: float = 0.0

    @property
    def mean_step_ms(self):
        n = max(self.frame_count - 1, 1)  # exclude the first frame
        return 1000.0 * (self.total_step_s - self.compile_s) / n

    @property
    def fps(self):
        ms = self.mean_step_ms
        return 1000.0 / ms if ms > 0 else 0.0

    def summary(self) -> str:
        return (f"frames={self.frame_count} success={self.success_count} "
                f"lost={self.lost_count} mean_step={self.mean_step_ms:.1f}ms "
                f"fps={self.fps:.1f}")


def _pack_summary(out: engine.StepOutput):
    """Everything the frame loop reads every frame, as one small tensor (one
    device-to-host copy per frame)."""
    f32 = torch.float32
    return torch.cat([out.position.to(f32), out.quat.to(f32),
                      torch.stack([out.success.to(f32), out.is_lost.to(f32)])])


def run_frames(frames, cam: CameraIntrinsics, cfg: SlamConfig,
               with_planes: bool = True, with_lines: bool = False, seed: int = 0,
               state: engine.SlamState | None = None, on_frame=None,
               ba_every: int | None = None, device="cpu"):
    """Run the engine over an iterable of (gray, depth[, timestamp]) frames (numpy
    or tensors), on ``device``.  ``on_frame(i, state, out, dt)`` is called after
    each frame.  Returns (final_state, Trajectory, RunStats)."""
    if ba_every:
        raise NotImplementedError(
            "ba_every: the keyframe/BA backend (ROADMAP queue 1 #11) is not ported yet")
    if state is None:
        state = engine.init_state(cam, cfg, seed=seed, device=device)
    traj = Trajectory()
    stats = RunStats()
    for i, frame in enumerate(frames):
        t0 = time.perf_counter()
        if len(frame) == 3:
            gray, depth, ts = frame
        else:
            (gray, depth), ts = frame, float(i)
        gray = torch.as_tensor(gray, dtype=torch.float32, device=device)
        depth = torch.as_tensor(depth, dtype=torch.float32, device=device)
        state, out = engine.step(state, gray, depth, cam, cfg, with_planes=with_planes,
                                 with_lines=with_lines)
        summary = _pack_summary(out).cpu().numpy().astype(np.float64)
        dt = time.perf_counter() - t0

        stats.frame_count += 1
        stats.total_step_s += dt
        if i == 0:
            stats.compile_s = dt
        stats.success_count += int(summary[7] > 0.5)
        stats.lost_count += int(summary[8] > 0.5)
        traj.append(ts, summary[0:3], summary[3:7])
        if on_frame is not None:
            on_frame(i, state, out, dt)
    return state, traj, stats


def evaluate_against_ground_truth(traj: Trajectory, gt_positions_mm) -> dict:
    """ATE metrics for a run."""
    est = traj.positions_array()
    gt = np.asarray(gt_positions_mm, dtype=np.float64)
    n = min(len(est), len(gt))
    return {"ate_rmse_mm": ate_rmse(est[:n], gt[:n], align=True), "frames": n}
