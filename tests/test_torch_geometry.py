"""Parity of the port's geometry (se3, pinhole, basis, lines, planes,
inverse_depth, covariances) with the JAX package on the same numpy inputs.

Tolerance: float32 elementwise math on both sides; results agree to a few ulps
of their magnitude (rtol 1e-5, atol 1e-4 on mm-scale values, 1e-6 on unit-scale
ones).  Validity masks must be equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from rgbd_slam_tpu.config import TUM_FR1
from rgbd_slam_tpu.geometry import basis as j_basis
from rgbd_slam_tpu.geometry import covariances as j_cov
from rgbd_slam_tpu.geometry import inverse_depth as j_idp
from rgbd_slam_tpu.geometry import lines as j_lines
from rgbd_slam_tpu.geometry import pinhole as j_pinhole
from rgbd_slam_tpu.geometry import planes as j_planes
from rgbd_slam_tpu.geometry import se3 as j_se3
from rgbd_slam_tpu_torch.config import TUM_FR1 as T_TUM_FR1
from rgbd_slam_tpu_torch.geometry import basis, covariances, inverse_depth, lines
from rgbd_slam_tpu_torch.geometry import pinhole, planes, se3

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol, atol=atol)


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def test_config_is_a_verbatim_copy():
    assert dataclasses.asdict(T_TUM_FR1) == dataclasses.asdict(TUM_FR1)
    import rgbd_slam_tpu.config as a
    import rgbd_slam_tpu_torch.config as b
    with open(a.__file__) as fa, open(b.__file__) as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("scene", ["WallScene", "StripeWallScene", "TunnelScene",
                                   "RoomScene", "HardRoomScene"])
def test_synthetic_and_trajectory_copies_match(scene):
    """The port's numpy copies render the same frames and score the same ATE."""
    import rgbd_slam_tpu.io.trajectory as j_traj
    import rgbd_slam_tpu.synthetic as j_syn
    from rgbd_slam_tpu_torch import synthetic as t_syn
    from rgbd_slam_tpu_torch.io import trajectory as t_traj
    cam = dataclasses.replace(TUM_FR1, width=64, height=48, fx=52.0, fy=52.0,
                              cx=32.0, cy=24.0)
    t_cam = dataclasses.replace(T_TUM_FR1, width=64, height=48, fx=52.0, fy=52.0,
                                cx=32.0, cy=24.0)
    j_scene, t_scene = getattr(j_syn, scene)(cam), getattr(t_syn, scene)(t_cam)
    for name in ("orbit_trajectory", "rotation_trajectory", "roll_trajectory",
                 "lateral_trajectory"):
        for (jq, jp), (tq, tp) in zip(getattr(j_syn, name)(3), getattr(t_syn, name)(3)):
            np.testing.assert_array_equal(tq, jq)
            np.testing.assert_array_equal(tp, jp)
            for a, b in zip(t_scene.render(tq, tp), j_scene.render(jq, jp)):
                np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(0)
    est, gt = rng.normal(size=(10, 3)), rng.normal(size=(10, 3))
    assert t_traj.ate_rmse(est, gt) == j_traj.ate_rmse(est, gt)
    assert t_traj.relative_pose_error(est, gt) == j_traj.relative_pose_error(est, gt)


@pytest.mark.parametrize("seed", [0, 1])
def test_se3_quaternion_and_transforms(seed):
    rng = np.random.default_rng(seed)
    q = _quats(rng, 16)
    p = rng.normal(0, 500, (16, 3)).astype(np.float32)
    _close(se3.quat_to_matrix(_t(q)), j_se3.quat_to_matrix(q))
    m = np.asarray(j_se3.quat_to_matrix(q))
    # matrix_to_quat is sign-ambiguous only in theory: same branch, same sign
    _close(se3.matrix_to_quat(_t(m)), j_se3.matrix_to_quat(m), atol=1e-6)
    _close(se3.camera_to_world(_t(q), _t(p)), j_se3.camera_to_world(q, p), atol=1e-4)
    _close(se3.world_to_camera(_t(q), _t(p)), j_se3.world_to_camera(q, p), atol=1e-3)
    c2w = np.asarray(j_se3.camera_to_world(q, p))
    _close(se3.plane_camera_to_world_matrix(_t(c2w)),
           j_se3.plane_camera_to_world_matrix(c2w), atol=1e-3)
    coeffs = np.asarray(j_se3.pose_to_coefficients(q, p))
    _close(se3.pose_to_coefficients(_t(q), _t(p)), coeffs, atol=1e-4)
    jq, jp = j_se3.coefficients_to_pose(coeffs)
    tq, tp = se3.coefficients_to_pose(_t(coeffs))
    _close(tq, jq, atol=1e-6)
    _close(tp, jp)
    _close(se3.quat_multiply(_t(q), _t(q[::-1].copy())), j_se3.quat_multiply(q, q[::-1]))
    _close(se3.quat_slerp(_t(q), _t(q[::-1].copy()), 0.5),
           j_se3.quat_slerp(q, q[::-1], 0.5), atol=1e-6)
    np.testing.assert_array_equal(se3.AXIS_CORRECTION, j_se3.AXIS_CORRECTION)


def test_pinhole_projection_round_trip_and_masks():
    rng = np.random.default_rng(2)
    cam = TUM_FR1
    q = _quats(rng, 1)[0]
    p = rng.normal(0, 100, 3).astype(np.float32)
    w2c = np.asarray(j_se3.world_to_camera(q, p))
    c2w = np.asarray(j_se3.camera_to_world(q, p))
    pts = rng.normal(0, 2000, (64, 3)).astype(np.float32)
    s_j, ok_j = j_pinhole.world_to_screen(pts, w2c, cam)
    s_t, ok_t = pinhole.world_to_screen(_t(pts), _t(w2c), cam)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    _close(s_t[ok_t], np.asarray(s_j)[np.asarray(ok_j)], rtol=1e-4, atol=1e-3)
    scr = np.concatenate([rng.uniform(0, 640, (64, 2)), rng.uniform(0, 7000, (64, 1))],
                         -1).astype(np.float32)
    _close(pinhole.screen_to_world(_t(scr), _t(c2w), cam),
           j_pinhole.screen_to_world(scr, c2w, cam), rtol=1e-5, atol=1e-2)
    np.testing.assert_array_equal(pinhole.is_in_screen_boundaries(_t(scr), cam).numpy(),
                                  np.asarray(j_pinhole.is_in_screen_boundaries(scr, cam)))
    np.testing.assert_array_equal(pinhole.is_depth_valid(_t(scr[:, 2])).numpy(),
                                  np.asarray(j_pinhole.is_depth_valid(scr[:, 2])))


def test_basis_lines_planes():
    rng = np.random.default_rng(3)
    xyz = rng.normal(0, 1000, (32, 3)).astype(np.float32)
    _close(basis.cartesian_to_spherical(_t(xyz)), j_basis.cartesian_to_spherical(xyz),
           atol=1e-3)
    sph = np.asarray(j_basis.cartesian_to_spherical(xyz))
    _close(basis.spherical_to_cartesian(_t(sph)), j_basis.spherical_to_cartesian(sph),
           atol=1e-2)
    a, b, c = (rng.normal(0, 100, (32, 2)).astype(np.float32) for _ in range(3))
    _close(lines.segment_signed_distance_to_point(_t(a), _t(b), _t(c)),
           j_lines.segment_signed_distance_to_point(a, b, c), atol=1e-3)
    ang = rng.uniform(-7, 7, (32, 3)).astype(np.float32)
    _close(lines.angle_distance(_t(ang), _t(ang[::-1].copy())),
           j_lines.angle_distance(ang, ang[::-1]), atol=1e-6)
    pl = rng.normal(size=(8, 4)).astype(np.float32)
    _close(planes.normalize_plane(_t(pl)), j_planes.normalize_plane(pl))
    m = rng.normal(size=(4, 4)).astype(np.float32)
    _close(planes.signed_distance(_t(pl), _t(pl[::-1].copy()), _t(m)),
           j_planes.signed_distance(pl, pl[::-1], m), atol=1e-5)
    _close(planes.reduced_signed_distance(_t(pl), _t(pl[::-1].copy()), _t(m)),
           j_planes.reduced_signed_distance(pl, pl[::-1], m), atol=1e-5)


def test_inverse_depth_parametrization():
    rng = np.random.default_rng(4)
    cam = TUM_FR1
    q = _quats(rng, 1)[0]
    p = rng.normal(0, 100, 3).astype(np.float32)
    c2w = np.asarray(j_se3.camera_to_world(q, p))
    uv = rng.uniform(0, 480, (32, 2)).astype(np.float32)
    st_j = np.asarray(j_idp.from_screen_observation(uv, c2w, cam, baseline_rho=5e-4))
    st_t = inverse_depth.from_screen_observation(_t(uv), _t(c2w), cam, baseline_rho=5e-4)
    _close(st_t, st_j, atol=1e-4)
    world = rng.normal(0, 2000, (32, 3)).astype(np.float32)
    origin = rng.normal(0, 100, 3).astype(np.float32)
    _close(inverse_depth.from_cartesian(_t(world), _t(origin)),
           j_idp.from_cartesian(world, origin), atol=1e-4)
    _close(inverse_depth.from_cartesian_jacobian(_t(world), _t(origin)),
           j_idp.from_cartesian_jacobian(world, origin), rtol=1e-4, atol=1e-9)
    state = np.asarray(j_idp.from_cartesian(world, origin))
    _close(inverse_depth.to_world(_t(state)), j_idp.to_world(state), atol=1e-2)
    _close(inverse_depth.to_world_jacobian(_t(state)), j_idp.to_world_jacobian(state),
           rtol=1e-4, atol=1e-2)
    rho_std = rng.uniform(0, 1e-4, 32).astype(np.float32)
    for port, ref in zip(inverse_depth.estimation_bounds(_t(state), _t(rho_std)),
                         j_idp.estimation_bounds(state, rho_std)):
        _close(port, ref, rtol=1e-4, atol=1e-1)


def _spd(rng, n, k):
    a = rng.normal(size=(k, n, n)).astype(np.float32)
    return (a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("n", [3, 6])
def test_covariance_validity_gate(n):
    rng = np.random.default_rng(5 + n)
    good = _spd(rng, n, 8)
    indefinite = good.copy()
    indefinite[:, 0, 0] = -1.0
    asym = good.copy()
    asym[:, 0, 1] += 1.0
    nan = good.copy()
    nan[:, 1, 1] = np.nan
    covs = np.concatenate([good, indefinite, asym, nan])
    got = covariances.is_covariance_valid_fast(_t(covs)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_cov.is_covariance_valid_fast(covs)))
    assert got[:8].all() and not got[8:].any()


def test_point_covariance_chain():
    rng = np.random.default_rng(6)
    cam = TUM_FR1
    q = _quats(rng, 1)[0]
    p = rng.normal(0, 100, 3).astype(np.float32)
    c2w = np.asarray(j_se3.camera_to_world(q, p))
    scr = np.concatenate([rng.uniform(0, 640, (32, 2)), rng.uniform(0, 7000, (32, 1))],
                         -1).astype(np.float32)
    pose_cov = _spd(rng, 3, 1)[0]
    _close(covariances.screen_point_to_world_covariance(_t(scr), _t(c2w), cam,
                                                        _t(pose_cov)),
           j_cov.screen_point_to_world_covariance(scr, c2w, cam, pose_cov),
           rtol=1e-4, atol=1e-3)
    _close(covariances.get_depth_quantization(_t(scr[:, 2])),
           j_cov.get_depth_quantization(scr[:, 2]), rtol=1e-6)
    j = rng.normal(size=(32, 3, 3)).astype(np.float32)
    cov = _spd(rng, 3, 32)
    _close(covariances.propagate_covariance(_t(cov), _t(j), eps=0.01),
           j_cov.propagate_covariance(cov, j, eps=0.01), rtol=1e-4, atol=1e-4)
