"""Inverse-depth point parametrization (port of
``rgbd_slam_tpu/geometry/inverse_depth.py``).

State layout ``[x0, y0, z0, rho, theta, phi]``: world position of the first
observation, inverse depth (1/mm) along the bearing and the bearing's spherical
angles.  Batched over leading axes.
"""

from __future__ import annotations

import torch

from ..config import CameraIntrinsics
from . import basis, lines, pinhole

FIRST_POSE_IDX = 0
INVERSE_DEPTH_IDX = 3
THETA_IDX = 4
PHI_IDX = 5


def bearing_vector(state):
    """Unit bearing from (theta, phi)."""
    theta, phi = state[..., THETA_IDX], state[..., PHI_IDX]
    return basis.spherical_to_cartesian(
        torch.stack([torch.ones_like(theta), theta, phi], dim=-1))


def from_cartesian(point_world, origin_world):
    """World point + observation origin -> 6-dof inverse-depth state."""
    v = point_world - origin_world
    sph = basis.cartesian_to_spherical(v)
    rho = 1.0 / torch.clamp_min(sph[..., 0], 1e-12)
    origin_b = origin_world.expand(v.shape)
    return torch.cat([origin_b, rho[..., None], sph[..., 1:2], sph[..., 2:3]], dim=-1)


def from_cartesian_jacobian(point_world, origin_world):
    """6x3 Jacobian of the state w.r.t. the observed world point."""
    v = point_world - origin_world
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    t1 = torch.clamp_min(x * x + y * y, 1e-12)
    t5 = t1 + z * z
    t4 = 1.0 / t5 ** 1.5
    inv_t1 = 1.0 / t1
    sqrt_t1 = torch.sqrt(t1)
    inv_t1_t5 = 1.0 / (sqrt_t1 * t5)
    zero = torch.zeros_like(x)
    jac_low = torch.stack([
        torch.stack([-x * t4, -y * t4, -z * t4], dim=-1),
        torch.stack([x * z * inv_t1_t5, y * z * inv_t1_t5, -sqrt_t1 / t5], dim=-1),
        torch.stack([-y * inv_t1, x * inv_t1, zero], dim=-1),
    ], dim=-2)
    top = torch.zeros(v.shape[:-1] + (3, 3), dtype=v.dtype, device=v.device)
    return torch.cat([top, jac_low], dim=-2)


def to_world(state):
    """State -> cartesian world point: ``origin + bearing / rho``."""
    rho = torch.clamp_min(state[..., INVERSE_DEPTH_IDX:INVERSE_DEPTH_IDX + 1], 1e-12)
    return state[..., :3] + bearing_vector(state) / rho


def to_world_jacobian(state):
    """3x6 Jacobian of the cartesian point w.r.t. the state."""
    rho = torch.clamp_min(state[..., INVERSE_DEPTH_IDX], 1e-12)
    theta, phi = state[..., THETA_IDX], state[..., PHI_IDX]
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    d = 1.0 / rho
    d_sqr = 1.0 / (rho * rho)
    t1 = sp * st
    t2 = cp * st
    ct_over_d = ct * d
    zero = torch.zeros_like(rho)
    reduced = torch.stack([
        torch.stack([-t2 * d_sqr, cp * ct_over_d, -t1 * d], dim=-1),
        torch.stack([-t1 * d_sqr, sp * ct_over_d, t2 * d], dim=-1),
        torch.stack([-ct * d_sqr, -st * d, zero], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=state.dtype, device=state.device).expand(
        state.shape[:-1] + (3, 3))
    return torch.cat([eye, reduced], dim=-1)


def from_screen_observation(screen_uv, c2w, cam: CameraIntrinsics,
                            baseline_rho: float = 0.5e-3):
    """Depth-less screen observation -> inverse-depth state with rho set to half
    the inverse-depth baseline."""
    uv1 = torch.stack([screen_uv[..., 0], screen_uv[..., 1],
                       torch.ones_like(screen_uv[..., 0])], dim=-1)
    cam_dir = pinhole.screen_to_camera(uv1, cam)
    world_pt = pinhole.camera_to_world_point(cam_dir, c2w)
    origin = c2w[..., :3, 3]
    state = from_cartesian(world_pt, origin)
    return torch.cat([state[..., :INVERSE_DEPTH_IDX],
                      torch.full_like(state[..., :1], baseline_rho),
                      state[..., INVERSE_DEPTH_IDX + 1:]], dim=-1)


def estimation_bounds(state, rho_std):
    """Furthest/closest cartesian estimates at +-3 sigma of rho; ``rho_std`` has
    the state's leading shape (it broadcasts against it)."""
    b = bearing_vector(state)
    rho = state[..., INVERSE_DEPTH_IDX:INVERSE_DEPTH_IDX + 1]
    var3 = 3.0 * rho_std[..., None]
    far = state[..., :3] + b / torch.clamp_min(rho - var3, 1e-9)
    near = state[..., :3] + b / torch.clamp_min(rho + var3, 1e-9)
    return far, near


def to_screen_segment(state, rho_variance, w2c, cam: CameraIntrinsics):
    """Project the +-3 sigma inverse-depth span to a screen segment.  Returns
    (p0_uv, p1_uv, valid)."""
    rho_std = torch.sqrt(torch.clamp_min(rho_variance, 0.0))
    far, near = estimation_bounds(state, rho_std)
    s0, v0 = pinhole.world_to_screen(far, w2c, cam)
    s1, v1 = pinhole.world_to_screen(near, w2c, cam)
    return s0[..., :2], s1[..., :2], v0 & v1


def signed_screen_distance(state, rho_variance, obs_uv, w2c, cam: CameraIntrinsics,
                           big=1e10):
    """Signed px distance of an observation to the projected inverse-depth
    segment's line; a near-zero-length segment falls back to the point distance
    and an invalid projection maps to ``big``."""
    p0, p1, valid = to_screen_segment(state, rho_variance, w2c, cam)
    seg_len_sq = torch.sum((p1 - p0) ** 2, dim=-1)
    line_d = lines.segment_signed_distance_to_point(p0, p1, obs_uv)
    point_d = obs_uv - p0
    d = torch.where((seg_len_sq < 1e-12)[..., None], point_d, line_d)
    return torch.where(valid[..., None], d, torch.full_like(d, big))


def signed_line_distance_to_observation(state, obs_uv, w2c, cam: CameraIntrinsics):
    """3D line-to-line signed distance between this feature's bearing ray and
    the ray of a new observation."""
    c2w = torch.linalg.inv(w2c)
    other = from_screen_observation(obs_uv, c2w, cam)
    return lines.signed_line_distance(state[..., :3], bearing_vector(state),
                                      other[..., :3], bearing_vector(other))
