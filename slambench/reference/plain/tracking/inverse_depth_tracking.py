"""Batched inverse-depth point state estimation (port of
``rgbd_slam_tpu/tracking/inverse_depth_tracking.py``): the 6-param state is fused
in cartesian space through a 3x3 Kalman filter and mapped back with analytic
Jacobians.
"""

from __future__ import annotations

import math

import torch

from ..config import CameraIntrinsics, DetectionConfig
from ..geometry import covariances as cov_mod
from ..geometry import inverse_depth as idp
from ..geometry import pinhole
from .kalman import kalman_step

#: process noise of the cartesian fusion filter
INVERSE_DEPTH_PROCESS_NOISE = 1e-4


def initial_covariance(pose_cov33, det: DetectionConfig = DetectionConfig(),
                       dtype=torch.float32):
    """Covariance of a new inverse-depth observation: pose covariance on the
    origin block, (baseline/4)^2 on rho, (0.5 deg)^2 on the angles."""
    batch = pose_cov33.shape[:-2]
    ang_var = (det.inverse_depth_angle_baseline_d * math.pi / 180.0) ** 2
    cov = torch.zeros(batch + (6, 6), dtype=dtype, device=pose_cov33.device)
    cov[..., :3, :3] = pose_cov33.to(dtype)
    cov[..., 3, 3].fill_((det.inverse_depth_baseline / 4.0) ** 2)
    cov[..., 4, 4].fill_(ang_var)
    cov[..., 5, 5].fill_(ang_var)
    return cov


def cartesian_covariance(state, cov66):
    """World-space 3x3 covariance of the cartesian projection of the state."""
    return cov_mod.propagate_covariance(cov66, idp.to_world_jacobian(state))


def inverse_depth_covariance_from_cartesian(point_cov33, first_pose_cov33, from_cart_jac):
    """Cartesian 3x3 covariance -> 6x6 inverse-depth covariance, with the origin
    block overwritten by the stored first-pose covariance."""
    cov = cov_mod.propagate_covariance(point_cov33, from_cart_jac).clone()
    cov[..., :3, :3] = first_pose_cov33
    return cov


def fuse_cartesian(state, cov66, obs_world, obs_cov33,
                   process_noise: float = INVERSE_DEPTH_PROCESS_NOISE):
    """Fuse a cartesian world observation into the inverse-depth state.  Returns
    (new_state, new_cov66, is_moving)."""
    cart = idp.to_world(state)
    cart_cov = cartesian_covariance(state, cov66)
    pn = process_noise * torch.eye(3, dtype=state.dtype, device=state.device)
    new_cart, new_cart_cov = kalman_step(cart, cart_cov, obs_world, obs_cov33,
                                         process_noise=pn)
    obs_sigma = torch.sqrt(torch.abs(torch.diagonal(obs_cov33, dim1=-2, dim2=-1)))
    is_moving = torch.any(torch.abs(cart - obs_world) > obs_sigma, dim=-1)
    origin = state[..., :3]
    new_state = idp.from_cartesian(new_cart, origin)
    jac = idp.from_cartesian_jacobian(new_cart, origin)
    new_cov = inverse_depth_covariance_from_cartesian(new_cart_cov, cov66[..., :3, :3],
                                                      jac)
    return new_state, new_cov, is_moving


def fuse_screen_observation_2d(state, cov66, obs_uv, c2w, pose_cov33,
                               cam: CameraIntrinsics,
                               det: DetectionConfig = DetectionConfig()):
    """Fuse a depth-less 2D observation through a new inverse-depth observation
    built from its ray."""
    obs_state = idp.from_screen_observation(obs_uv, c2w, cam,
                                            baseline_rho=det.inverse_depth_baseline / 2.0)
    obs_cov66 = initial_covariance(pose_cov33, det, dtype=state.dtype)
    return fuse_cartesian(state, cov66, idp.to_world(obs_state),
                          cartesian_covariance(obs_state, obs_cov66))


def fuse_screen_observation_3d(state, cov66, obs_screen, c2w, pose_cov33,
                               cam: CameraIntrinsics):
    """Fuse a depth-valid screen observation."""
    obs_world = pinhole.screen_to_world(obs_screen, c2w, cam)
    obs_cov33 = cov_mod.screen_point_to_world_covariance(obs_screen, c2w, cam, pose_cov33)
    return fuse_cartesian(state, cov66, obs_world, obs_cov33)


def linearity_score(state, cov66, c2w):
    """Civera-style linearity index gating the 2D->3D upgrade (below ~0.1 the
    cartesian approximation is accurate enough to promote)."""
    cart = idp.to_world(state)
    hc = cart - c2w[..., :3, 3]
    hc_norm = torch.clamp_min(torch.linalg.vector_norm(hc, dim=-1), 1e-9)
    cos_alpha = torch.sum(idp.bearing_vector(state) * hc, dim=-1) / hc_norm
    rho = torch.clamp_min(state[..., idp.INVERSE_DEPTH_IDX], 1e-12)
    rho_var = torch.abs(cov66[..., idp.INVERSE_DEPTH_IDX, idp.INVERSE_DEPTH_IDX])
    thetad_m = (torch.sqrt(rho_var) / (rho * rho)) / 1000.0
    d1_m = hc_norm / 1000.0
    return 4.0 * thetad_m / d1_m * torch.abs(cos_alpha)
