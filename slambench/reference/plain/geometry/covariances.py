"""Covariance models and propagation (port of
``rgbd_slam_tpu/geometry/covariances.py``).  Batched over a leading feature axis,
f32 with explicit symmetrization.
"""

from __future__ import annotations

import torch

from ..config import CameraIntrinsics, DepthNoiseModel


def get_depth_quantization(depth_mm, model: DepthNoiseModel = DepthNoiseModel()):
    """Minimum depth disparity at depth z: ``max(a + b z + c z^2, 0.5mm)``."""
    z = depth_mm
    return torch.clamp_min(model.constant + model.linear * z + model.quadratic * z * z,
                           model.floor_mm)


def propagate_covariance(cov, jacobian, eps=0.0):
    """First-order propagation ``J Sigma J^T (+ eps I)``, symmetrized."""
    out = jacobian @ cov @ jacobian.transpose(-1, -2)
    out = 0.5 * (out + out.transpose(-1, -2))
    if eps:
        out = out + eps * torch.eye(out.shape[-1], dtype=out.dtype, device=out.device)
    return out


def is_covariance_valid_fast(cov, atol=1e-5):
    """Covariance validity: finite, symmetric and positive-definite.  3x3 uses
    Sylvester's criterion in closed form; other sizes a Cholesky whose failure
    (``info != 0``, where ``jnp.linalg.cholesky`` returns NaN) means not PD."""
    sym_t = cov.transpose(-1, -2)
    finite = torch.isfinite(cov).all(dim=-1).all(dim=-1)
    scale = torch.clamp_min(torch.abs(cov).amax(dim=(-2, -1)), 1.0)
    sym = torch.abs(cov - sym_t).amax(dim=(-2, -1)) < atol * scale
    n = cov.shape[-1]
    s = 0.5 * (cov + sym_t) + atol * torch.eye(n, dtype=cov.dtype, device=cov.device)
    if n == 3:
        a, b, c = s[..., 0, 0], s[..., 0, 1], s[..., 0, 2]
        d, e, f = s[..., 1, 1], s[..., 1, 2], s[..., 2, 2]
        m1 = a
        m2 = a * d - b * b
        m3 = a * (d * f - e * e) - b * (b * f - c * e) + c * (b * e - c * d)
        pd = (m1 > 0) & (m2 > 0) & (m3 > 0)
    else:
        chol, info = torch.linalg.cholesky_ex(s)
        pd = (info == 0) & torch.isfinite(chol).all(dim=-1).all(dim=-1)
    return finite & sym & pd


def is_covariance_valid(cov, atol=1e-5):
    """Symmetry + positive-semi-definiteness check by ``eigvalsh``; batched,
    returns a bool mask.  A matrix with a non-finite entry is invalid (its
    eigenvalues are not computed: ``eigvalsh`` raises on them)."""
    sym_t = cov.transpose(-1, -2)
    sym = (torch.abs(cov - sym_t) < atol).all(dim=-1).all(dim=-1)
    finite = torch.isfinite(cov).all(dim=-1).all(dim=-1)
    eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    eigs = torch.linalg.eigvalsh(torch.where(finite[..., None, None], 0.5 * (cov + sym_t), eye))
    psd = finite & (eigs > -atol).all(dim=-1)
    return sym & psd


def screen_point_covariance(screen, model: DepthNoiseModel = DepthNoiseModel(),
                            xy_sigma_px: float = 0.1):
    """Measurement covariance of a screen observation [u, v, z]: fixed 0.1px xy
    variance and depth-quantization z variance (invalid depth -> 1000)."""
    from .pinhole import is_depth_valid

    z = screen[..., 2]
    zq = torch.where(is_depth_valid(z), get_depth_quantization(z, model),
                     torch.full_like(z, 1000.0))
    xy_var = torch.full_like(z, xy_sigma_px * xy_sigma_px)
    diag = torch.stack([xy_var, xy_var, zq], dim=-1)
    return diag[..., :, None] * torch.eye(3, dtype=screen.dtype, device=screen.device)


def screen_to_camera_covariance(screen, screen_cov, cam: CameraIntrinsics):
    """Screen covariance -> camera space with the absolute-value jacobian."""
    z = screen[..., 2]
    jx = torch.abs(screen[..., 0] - cam.cx) / cam.fx
    jy = torch.abs(screen[..., 1] - cam.cy) / cam.fy
    zero = torch.zeros_like(z)
    one = torch.ones_like(z)
    j = torch.stack([
        torch.stack([z / cam.fx, zero, jx], dim=-1),
        torch.stack([zero, z / cam.fy, jy], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    return propagate_covariance(screen_cov, j)


def camera_to_screen_covariance(pt_cam, cam_cov, cam: CameraIntrinsics):
    """Camera-space covariance -> screen space."""
    x, y, z = pt_cam[..., 0], pt_cam[..., 1], pt_cam[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    zero = torch.zeros_like(z)
    one = torch.ones_like(z)
    j = torch.stack([
        torch.stack([cam.fx / safe_z, zero, -cam.fx * x / (safe_z * safe_z)], dim=-1),
        torch.stack([zero, cam.fy / safe_z, -cam.fy * y / (safe_z * safe_z)], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    return propagate_covariance(cam_cov, j)


def rotate_covariance(cov, rotation_33, pose_cov=None):
    """Rotate a 3x3 covariance between frames and add the pose covariance."""
    out = propagate_covariance(cov, rotation_33)
    if pose_cov is not None:
        out = out + pose_cov
    return out


def screen_point_to_world_covariance(screen, c2w, cam: CameraIntrinsics,
                                     pose_cov=None,
                                     model: DepthNoiseModel = DepthNoiseModel()):
    """Full chain screen measurement -> world covariance."""
    s_cov = screen_point_covariance(screen, model)
    c_cov = screen_to_camera_covariance(screen, s_cov, cam)
    return rotate_covariance(c_cov, c2w[..., :3, :3], pose_cov)


# ---------------------------------------------------------------------------
# plane covariance conversions (hessian 4-param <-> reduced 3-param d*n)
# ---------------------------------------------------------------------------

def plane_covariance_from_point_cloud(plane_4, point_cloud_cov, eps=0.01):
    """3-param (n*d vector) point-cloud covariance -> 4-param hessian covariance;
    ``plane_4`` = [nx, ny, nz, d] with unit normal."""
    p = plane_4[..., :3] * plane_4[..., 3:4]
    a, b, c = p[..., 0], p[..., 1], p[..., 2]
    a2, b2, c2 = a * a, b * b, c * c
    s = a2 + b2 + c2
    divider = s ** 1.5
    common = 1.0 / torch.sqrt(s)
    j = torch.stack([
        torch.stack([common - a2 / divider, -(a * b) / divider, -(a * c) / divider], dim=-1),
        torch.stack([-(a * b) / divider, common - b2 / divider, -(b * c) / divider], dim=-1),
        torch.stack([-(a * c) / divider, -(b * c) / divider, common - c2 / divider], dim=-1),
        torch.stack([-a / divider, -b / divider, -c / divider], dim=-1),
    ], dim=-2)
    return propagate_covariance(point_cloud_cov, j, eps=eps)


def reduced_point_cloud_covariance_from_plane(plane_4, plane_cov44, eps=0.01):
    """4-param hessian covariance -> 3-param (n*d) covariance."""
    n = plane_4[..., :3]
    d = plane_4[..., 3]
    zero = torch.zeros_like(d)
    j = torch.stack([
        torch.stack([d, zero, zero, n[..., 0]], dim=-1),
        torch.stack([zero, d, zero, n[..., 1]], dim=-1),
        torch.stack([zero, zero, d, n[..., 2]], dim=-1),
    ], dim=-2)
    return propagate_covariance(plane_cov44, j, eps=eps)


def world_plane_covariance(plane_cam_4, plane_world_4, c2w, plane_cov44, world_pose_cov33,
                           eps=0.01):
    """Camera plane covariance -> world plane covariance via the reduced point
    form."""
    pc_cov = reduced_point_cloud_covariance_from_plane(plane_cam_4, plane_cov44, eps)
    pc_world = rotate_covariance(pc_cov, c2w[..., :3, :3], world_pose_cov33)
    return plane_covariance_from_point_cloud(plane_world_4, pc_world, eps)
