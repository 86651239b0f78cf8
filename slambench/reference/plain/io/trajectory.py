"""Trajectory recording and ATE-RMSE evaluation.

The reference only prints per-frame pose error against ground truth
(examples/main_TUM.cpp:264-270, 306-308) and optionally writes a trajectory CSV
(main_TUM.cpp:184-195).  The north-star metric is ATE RMSE (SURVEY.md §6), so this
module adds the standard evaluation: SE(3) (optionally Sim(3)) Umeyama alignment of
the estimated trajectory to ground truth, then RMSE over translational residuals.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Trajectory:
    timestamps: list = field(default_factory=list)
    positions: list = field(default_factory=list)   # [3] each
    quaternions: list = field(default_factory=list) # [4] wxyz each

    def append(self, timestamp, position, quaternion):
        self.timestamps.append(float(timestamp))
        self.positions.append(np.asarray(position, dtype=np.float64))
        self.quaternions.append(np.asarray(quaternion, dtype=np.float64))

    def positions_array(self):
        return np.stack(self.positions) if self.positions else np.zeros((0, 3))

    def save_tum_format(self, path: str):
        """TUM trajectory format: 'timestamp tx ty tz qx qy qz qw' (compatible with
        the standard TUM evaluation tooling; replaces main_TUM.cpp:286-293 CSV)."""
        with open(path, "w") as f:
            for ts, p, q in zip(self.timestamps, self.positions, self.quaternions):
                f.write(f"{ts:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                        f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")


def umeyama_alignment(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (or similarity) alignment est -> gt.

    Returns (rotation 3x3, translation 3, scale)."""
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    e = est - mu_e
    g = gt - mu_g
    cov = g.T @ e / est.shape[0]
    u, d, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1.0
    r = u @ s @ vt
    scale = 1.0
    if with_scale:
        var_e = (e ** 2).sum() / est.shape[0]
        scale = np.trace(np.diag(d) @ s) / var_e
    t = mu_g - scale * r @ mu_e
    return r, t, scale


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray,
             align: bool = True, with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE after alignment (the north-star metric)."""
    est = np.asarray(est_positions, dtype=np.float64)
    gt = np.asarray(gt_positions, dtype=np.float64)
    assert est.shape == gt.shape and est.ndim == 2
    if est.shape[0] == 0:
        return float("nan")
    if align and est.shape[0] >= 3:
        r, t, s = umeyama_alignment(est, gt, with_scale)
        est = (s * (r @ est.T)).T + t
    err = est - gt
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def relative_pose_error(est_positions: np.ndarray, gt_positions: np.ndarray,
                        delta: int = 1) -> float:
    """Translational RPE RMSE over frame pairs ``delta`` apart."""
    est = np.asarray(est_positions, dtype=np.float64)
    gt = np.asarray(gt_positions, dtype=np.float64)
    d_est = est[delta:] - est[:-delta]
    d_gt = gt[delta:] - gt[:-delta]
    err = d_est - d_gt
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))
