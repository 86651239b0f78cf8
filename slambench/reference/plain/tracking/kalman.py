"""Batched Kalman filtering (port of ``rgbd_slam_tpu/tracking/kalman.py``).

Predict, gain from the SPD innovation ``S`` (Tikhonov 1e-9, unrolled Cholesky),
symmetrized covariance update.  The engine's filters all have identity dynamics
and output; for them the step skips the products with the identity, which give
the same values.
"""

from __future__ import annotations

import torch

from ..pose.linalg6 import solve_spd

#: process noise for 3D map points
POINT_PROCESS_NOISE = 1e-3
#: process noise for plane states
PLANE_PROCESS_NOISE = 1e-6


def kalman_step(state, cov, measurement, meas_cov, dynamics=None, output=None,
                process_noise=None):
    """One predict+update step.  Shapes: state [..., N], cov [..., N, N],
    measurement [..., M], meas_cov [..., M, M]; ``dynamics`` [N, N], ``output``
    [M, N] and ``process_noise`` [N, N] broadcast (defaults: identity dynamics
    and output, zero process noise).  Returns (new_state, new_cov)."""
    n = state.shape[-1]
    m = measurement.shape[-1]
    dt, dev = state.dtype, state.device
    eye = torch.eye(n, dtype=dt, device=dev)
    if dynamics is None and output is None and m == n:
        h = None
        x_pred = state
        p_pred = cov if process_noise is None else cov + process_noise
        pht = p_pred
        s = p_pred + meas_cov
        innovation = measurement - state
    else:
        f = eye if dynamics is None else dynamics
        h = torch.eye(m, n, dtype=dt, device=dev) if output is None else output
        x_pred = (f @ state[..., None])[..., 0]
        p_pred = f @ cov @ f.transpose(-1, -2)
        if process_noise is not None:
            p_pred = p_pred + process_noise
        pht = p_pred @ h.transpose(-1, -2)
        s = h @ pht + meas_cov
        innovation = measurement - (h @ x_pred[..., None])[..., 0]
    s = 0.5 * (s + s.transpose(-1, -2))
    gain = solve_spd(s + 1e-9 * torch.eye(m, dtype=dt, device=dev),
                     pht.transpose(-1, -2)).transpose(-1, -2)
    new_state = x_pred + (gain @ innovation[..., None])[..., 0]
    new_cov = (eye - (gain if h is None else gain @ h)) @ p_pred
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


def kalman_step_vectorized(state, cov, measurement, meas_cov):
    """:func:`kalman_step` with default matrices over batch shapes that only
    broadcast against each other."""
    batch = torch.broadcast_shapes(state.shape[:-1], cov.shape[:-2], measurement.shape[:-1],
                                   meas_cov.shape[:-2])
    return kalman_step(state.expand(batch + state.shape[-1:]),
                       cov.expand(batch + cov.shape[-2:]),
                       measurement.expand(batch + measurement.shape[-1:]),
                       meas_cov.expand(batch + meas_cov.shape[-2:]))
