"""Residual blocks for pose optimization (port of ``rgbd_slam_tpu/pose/residuals.py``).

Every function broadcasts a batch of poses against a batch of feature sets:
``coeffs`` [..., 6] and prepared features [..., N, k] (or unbatched [N, k]) give
[..., R] residuals.  Their Jacobians come from ``torch.func`` forward mode in
``ops/lm_cuda.lm_solve_reference``, and from the LM kernel (``csrc/lm.cu``),
which evaluates the same rows in forward mode on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import CameraIntrinsics, RansacConfig
from ..geometry import inverse_depth as idp
from ..geometry import lines, pinhole, planes, se3
from .features import (LINE_ALPHA, PLANE_ALPHA, POINT2D_ALPHA, POINT_ALPHA,
                       MatchedFeatures)

#: residual magnitude assigned to invalid projections
BIG_RESIDUAL = 1.0e4


class PreparedFeatures(NamedTuple):
    """Pose-independent precomputation of a MatchedFeatures set: the world points
    every pose projects (points, inverse-depth far/near endpoints, line
    endpoints), stacked into one [..., NP + 2*N2 + 2*NL, 3] block."""

    pts_world: torch.Tensor
    point_obs_uv: torch.Tensor
    point_mask: torch.Tensor
    point2d_obs_uv: torch.Tensor
    point2d_mask: torch.Tensor
    plane_world: torch.Tensor
    plane_cam: torch.Tensor
    plane_mask: torch.Tensor
    line_obs_p0: torch.Tensor
    line_obs_p1: torch.Tensor
    line_mask: torch.Tensor


def prepare_features(feats: MatchedFeatures, cam: CameraIntrinsics = None
                     ) -> PreparedFeatures:
    """Resolve every pose-independent quantity of the residual evaluation."""
    rho_std = feats.point2d_state_std[..., idp.INVERSE_DEPTH_IDX]
    far, near = idp.estimation_bounds(feats.point2d_state, rho_std)
    pts = torch.cat([feats.point_world, far, near, feats.line_world[..., :3],
                     feats.line_world[..., 3:]], dim=-2)
    return PreparedFeatures(
        pts_world=pts,
        point_obs_uv=feats.point_obs_uv, point_mask=feats.point_mask,
        point2d_obs_uv=feats.point2d_obs_uv, point2d_mask=feats.point2d_mask,
        plane_world=feats.plane_world, plane_cam=feats.plane_cam,
        plane_mask=feats.plane_mask,
        line_obs_p0=feats.line_obs_p0, line_obs_p1=feats.line_obs_p1,
        line_mask=feats.line_mask)


def _line_point_distances(l0, l1, q0, q1, ok, big):
    """Perpendicular distances of the observed segment endpoints (q0, q1) to the
    infinite 2D line through the projected map segment (l0, l1), [..., NL, 2]."""
    d = l1 - l0
    nrm = torch.sqrt(torch.clamp_min(torch.sum(d * d, dim=-1), 1e-12))
    n = torch.stack([-d[..., 1], d[..., 0]], dim=-1) / nrm[..., None]
    r = torch.stack([torch.sum((q0 - l0) * n, dim=-1),
                     torch.sum((q1 - l0) * n, dim=-1)], dim=-1)
    degenerate = (torch.sum(d * d, dim=-1) < 1e-9)[..., None]
    r = torch.where(degenerate, big, r)
    return torch.where(ok[..., None], r, big)


def _project(coeffs, prep: PreparedFeatures, cam: CameraIntrinsics):
    quat, position = se3.coefficients_to_pose(coeffs)
    w2c = se3.world_to_camera(quat, position)
    scr, ok = pinhole.world_to_screen(prep.pts_world, w2c[..., None, :, :], cam)
    return w2c, scr, ok


def _point2d_distances(scr, ok, prep: PreparedFeatures, np_: int, n2: int):
    p0 = scr[..., np_:np_ + n2, :2]
    p1 = scr[..., np_ + n2:np_ + 2 * n2, :2]
    sok = ok[..., np_:np_ + n2] & ok[..., np_ + n2:np_ + 2 * n2]
    seg_len_sq = torch.sum((p1 - p0) ** 2, dim=-1)
    line_d = lines.segment_signed_distance_to_point(p0, p1, prep.point2d_obs_uv)
    point_d = prep.point2d_obs_uv - p0
    dq = torch.where((seg_len_sq < 1e-12)[..., None], point_d, line_d)
    return torch.where(sok[..., None], dq, BIG_RESIDUAL)


def _line_distances(scr, ok, prep: PreparedFeatures, np_: int, n2: int):
    nl = prep.line_mask.shape[-1]
    base = np_ + 2 * n2
    l0 = scr[..., base:base + nl, :2]
    l1 = scr[..., base + nl:, :2]
    lok = ok[..., base:base + nl] & ok[..., base + nl:]
    return _line_point_distances(l0, l1, prep.line_obs_p0, prep.line_obs_p1, lok,
                                 BIG_RESIDUAL)


def residual_vector_prepared(coeffs, prep: PreparedFeatures, cam: CameraIntrinsics):
    """Stacked residual vector [..., 2NP + 2N2 + 3NK + 2NL]; per-feature blocks are
    scaled by ``alpha / part_count`` and masked features contribute zero."""
    w2c, scr, ok = _project(coeffs, prep, cam)
    np_ = prep.point_mask.shape[-1]
    n2 = prep.point2d_mask.shape[-1]

    dp = torch.where(ok[..., :np_, None], prep.point_obs_uv - scr[..., :np_, :2],
                     BIG_RESIDUAL)
    rp = torch.where(prep.point_mask[..., None], dp, 0.0) * (POINT_ALPHA / 2.0)

    dq = _point2d_distances(scr, ok, prep, np_, n2)
    rq = torch.where(prep.point2d_mask[..., None], dq, 0.0) * (POINT2D_ALPHA / 2.0)

    plane_w2c = se3.plane_world_to_camera_matrix(w2c)[..., None, :, :]
    dk = planes.reduced_signed_distance(prep.plane_world, prep.plane_cam, plane_w2c)
    rk = torch.where(prep.plane_mask[..., None], dk, 0.0) * (PLANE_ALPHA / 3.0)

    dl = _line_distances(scr, ok, prep, np_, n2)
    rl = torch.where(prep.line_mask[..., None], dl, 0.0) * (LINE_ALPHA / 2.0)

    return torch.cat([rp.flatten(-2), rq.flatten(-2), rk.flatten(-2),
                      rl.flatten(-2)], dim=-1)


def point_residuals(feats: MatchedFeatures, w2c, cam: CameraIntrinsics):
    """Signed 2D px reprojection error per 3D point, [NP, 2]."""
    d = pinhole.signed_screen_distance_2d(feats.point_world, feats.point_obs_uv, w2c, cam,
                                          big=BIG_RESIDUAL)
    return torch.where(feats.point_mask[..., None], d, 0.0)


def point2d_residuals(feats: MatchedFeatures, w2c, cam: CameraIntrinsics):
    """Signed px distance of the observation to the projected inverse-depth
    segment, [N2, 2]; the rho variance comes from the state's std dev."""
    rho_var = feats.point2d_state_std[..., idp.INVERSE_DEPTH_IDX] ** 2
    d = idp.signed_screen_distance(feats.point2d_state, rho_var, feats.point2d_obs_uv, w2c,
                                   cam, big=BIG_RESIDUAL)
    return torch.where(feats.point2d_mask[..., None], d, 0.0)


def plane_residuals(feats: MatchedFeatures, w2c, cam: CameraIntrinsics = None):
    """Reduced ``d*n`` plane error, [NK, 3]."""
    plane_w2c = se3.plane_world_to_camera_matrix(w2c)
    d = planes.reduced_signed_distance(feats.plane_world, feats.plane_cam, plane_w2c)
    return torch.where(feats.plane_mask[..., None], d, 0.0)


def residual_vector(coeffs, feats: MatchedFeatures, cam: CameraIntrinsics, weights=None):
    """Full stacked residual vector for the 6-dof coefficients.  ``weights``
    (unified index space) selects the RANSAC subset: unselected features of all
    four types contribute zero.  (The JAX function unpacks three of the four
    blocks and raises when given weights; this is the masking its ``lm_solve``
    does.)"""
    if weights is not None:
        feats = feats.with_masks(*(w > 0 for w in feats.split_unified(weights)))
    return residual_vector_prepared(coeffs, prepare_features(feats, cam), cam)


def inlier_masks_prepared(quat, position, prep: PreparedFeatures,
                          cam: CameraIntrinsics, ransac: RansacConfig = RansacConfig()):
    """Per-type inlier masks at a pose: points L1 px <= 3; 2D points per
    component <= 3; planes |angles| <= 0.2 and |d| <= 50; lines per endpoint <= 3."""
    w2c = se3.world_to_camera(quat, position)
    scr, ok = pinhole.world_to_screen(prep.pts_world, w2c[..., None, :, :], cam)
    np_ = prep.point_mask.shape[-1]
    n2 = prep.point2d_mask.shape[-1]

    dp = torch.where(ok[..., :np_, None], prep.point_obs_uv - scr[..., :np_, :2],
                     BIG_RESIDUAL)
    d_pt = torch.sum(torch.abs(dp), dim=-1)
    point_in = (d_pt <= ransac.max_retroprojection_error_point_px) & prep.point_mask

    d_2d = _point2d_distances(scr, ok, prep, np_, n2)
    point2d_in = torch.all(
        torch.abs(d_2d) <= ransac.max_retroprojection_error_point2d_px, dim=-1
    ) & prep.point2d_mask

    plane_w2c = se3.plane_world_to_camera_matrix(w2c)[..., None, :, :]
    d_pl = torch.abs(planes.signed_distance(prep.plane_world, prep.plane_cam,
                                            plane_w2c))
    plane_in = (torch.all(d_pl[..., :3] <= ransac.max_retroprojection_error_plane_normal,
                          dim=-1)
                & (d_pl[..., 3] <= ransac.max_retroprojection_error_plane_mm)
                & prep.plane_mask)

    d_ln = _line_distances(scr, ok, prep, np_, n2)
    line_in = torch.all(torch.abs(d_ln) <= ransac.max_retroprojection_error_line_px,
                        dim=-1) & prep.line_mask
    return point_in, point2d_in, plane_in, line_in


def inlier_masks(quat, position, feats: MatchedFeatures, cam: CameraIntrinsics,
                 ransac: RansacConfig = RansacConfig()):
    """Per-type inlier masks at a pose (:func:`inlier_masks_prepared` of the
    prepared set)."""
    return inlier_masks_prepared(quat, position, prepare_features(feats, cam), cam, ransac)


class VariationNoise(NamedTuple):
    """Standard-normal draws of one Monte-Carlo perturbation per leading index
    (the five ``jax.random.normal`` calls of ``random_variation``)."""
    point: torch.Tensor   # [..., NP, 3]
    theta: torch.Tensor   # [..., N2]
    phi: torch.Tensor     # [..., N2]
    plane: torch.Tensor   # [..., NK, 4]
    line: torch.Tensor    # [..., NL, 6]


def random_variation(feats: MatchedFeatures, noise: VariationNoise,
                     scale=1.0) -> MatchedFeatures:
    """Perturb map features by their standard deviation for the Monte-Carlo pose
    covariance: full N(0, std) on world points, theta/phi only (clamped to their
    domains) on inverse-depth points, normal + d with renormalization on planes.
    ``scale`` multiplies the noise: a number, or a tensor of the draws' leading
    (member) shape; 0 gives the unperturbed member of a fused batch."""
    def s(trailing):
        if isinstance(scale, torch.Tensor):
            return scale.reshape(scale.shape + (1,) * trailing)
        return scale

    new_points = feats.point_world + s(2) * (noise.point * feats.point_world_std)

    theta = feats.point2d_state[..., idp.THETA_IDX]
    phi = feats.point2d_state[..., idp.PHI_IDX]
    nt = torch.clamp(theta + s(1) * noise.theta * feats.point2d_state_std[..., idp.THETA_IDX],
                     0.0, torch.pi)
    nphi = torch.clamp(phi + s(1) * noise.phi * feats.point2d_state_std[..., idp.PHI_IDX],
                       -torch.pi, torch.pi)
    new_state = torch.cat([feats.point2d_state[..., :idp.THETA_IDX].expand(
        nt.shape + (idp.THETA_IDX,)), nt[..., None], nphi[..., None]], dim=-1)

    new_planes = planes.normalize_plane(feats.plane_world
                                        + s(2) * noise.plane * feats.plane_world_std)
    new_lines = feats.line_world + s(2) * (noise.line * feats.line_world_std)
    return feats._replace(point_world=new_points, point2d_state=new_state,
                          plane_world=new_planes, line_world=new_lines)
