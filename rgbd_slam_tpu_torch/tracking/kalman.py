"""Batched Kalman filtering (port of ``rgbd_slam_tpu/tracking/kalman.py``).

The engine's filters all have identity dynamics and output, so the step is
written for that case: predict ``P + Q``, gain from the SPD innovation ``S``
(Tikhonov 1e-9, unrolled Cholesky), symmetrized covariance update.
"""

from __future__ import annotations

import torch

from ..pose.linalg6 import solve_spd

#: process noise for 3D map points
POINT_PROCESS_NOISE = 1e-3
#: process noise for plane states
PLANE_PROCESS_NOISE = 1e-6


def kalman_step(state, cov, measurement, meas_cov, process_noise=None):
    """One predict+update step with identity dynamics and output.  Shapes: state
    [..., N], cov [..., N, N], measurement [..., N], meas_cov [..., N, N];
    ``process_noise`` an [N, N] matrix (default zero).  Returns (new_state,
    new_cov)."""
    n = state.shape[-1]
    eye = torch.eye(n, dtype=state.dtype, device=state.device)
    p_pred = cov if process_noise is None else cov + process_noise
    s = p_pred + meas_cov
    s = 0.5 * (s + s.transpose(-1, -2))
    gain = solve_spd(s + 1e-9 * eye, p_pred.transpose(-1, -2)).transpose(-1, -2)
    innovation = measurement - state
    new_state = state + (gain @ innovation[..., None])[..., 0]
    new_cov = (eye - gain) @ p_pred
    new_cov = 0.5 * (new_cov + new_cov.transpose(-1, -2))
    return new_state, new_cov


def track_points(positions, covariances, observations, obs_covariances,
                 process_noise: float = POINT_PROCESS_NOISE):
    """Batched 3x3 static-identity KF update of world points.  Returns
    (new_positions, new_covariances, score, is_moving): score is the displacement
    norm, is_moving flags motion above the observation sigma."""
    pn = process_noise * torch.eye(3, dtype=positions.dtype, device=positions.device)
    new_pos, new_cov = kalman_step(positions, covariances, observations,
                                   obs_covariances, process_noise=pn)
    score = torch.linalg.vector_norm(positions - new_pos, dim=-1)
    obs_sigma = torch.sqrt(torch.abs(torch.diagonal(obs_covariances, dim1=-2, dim2=-1)))
    is_moving = torch.any(torch.abs(positions - observations) > obs_sigma, dim=-1)
    return new_pos, new_cov, score, is_moving


def track_planes(plane_states, covariances, observations, obs_covariances,
                 process_noise: float = PLANE_PROCESS_NOISE):
    """Batched 4x4 static-identity KF update of hessian plane parameters; the
    caller renormalizes the normal."""
    pn = process_noise * torch.eye(4, dtype=plane_states.dtype, device=plane_states.device)
    return kalman_step(plane_states, covariances, observations, obs_covariances,
                       process_noise=pn)
