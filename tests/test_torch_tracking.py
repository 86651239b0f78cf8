"""Parity of the port's state estimation (Kalman, inverse-depth fusion, motion
model) and map lifecycle with the JAX package.

Tolerances: float32 on both sides with the same unrolled Cholesky; fused states
agree to 1e-4 relative (1e-3 mm absolute on mm-scale values) and covariance
entries to 1e-2 of their correlation scale; the 2D->3D linearity score, which reads a cancellation-prone
variance, to 1e-2.  The inverse-depth fusion covariances are held to a float64
evaluation of the same function instead, within the reference's own float32
error (see ``_assert_cov_near_f64``).  Slot allocation and lifecycle are integer
logic: equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_slam_tpu.config import TUM_FR1, DetectionConfig
from rgbd_slam_tpu.geometry import inverse_depth as j_idp
from rgbd_slam_tpu.geometry import se3 as j_se3
from rgbd_slam_tpu.mapping import maps as j_maps
from rgbd_slam_tpu.tracking import inverse_depth_tracking as j_idt
from rgbd_slam_tpu.tracking import kalman as j_kalman
from rgbd_slam_tpu.tracking import motion_model as j_motion
from rgbd_slam_tpu_torch.mapping import maps
from rgbd_slam_tpu_torch.tracking import inverse_depth_tracking as idt
from rgbd_slam_tpu_torch.tracking import kalman, motion_model

torch.set_num_threads(2)

CAM = TUM_FR1
DET = DetectionConfig()


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, rtol=1e-4, atol=1e-3):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol, atol=atol)


def _spd(rng, n, k, scale=1.0):
    a = rng.normal(size=(k, n, n)).astype(np.float32)
    return (scale * (a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(n))).astype(np.float32)


def test_point_kalman_update():
    rng = np.random.default_rng(0)
    pos = rng.normal(0, 2000, (32, 3)).astype(np.float32)
    obs = (pos + rng.normal(0, 10, (32, 3))).astype(np.float32)
    cov, ocov = _spd(rng, 3, 32, 20.0), _spd(rng, 3, 32, 30.0)
    j = j_kalman.track_points(pos, cov, obs, ocov)
    t = kalman.track_points(_t(pos), _t(cov), _t(obs), _t(ocov))
    _close(t[0], j[0])
    _close(t[1], j[1])
    _close(t[2], j[2], atol=1e-2)
    np.testing.assert_array_equal(t[3].numpy(), np.asarray(j[3]))


def _assert_cov_close(port, ref, rtol=1e-2):
    """Covariances whose entries span 1e-13 (fused rho variance) to 1e-3 (origin
    block): each entry to ``rtol`` of its correlation scale sqrt(|S_ii S_jj|);
    the rho entries come out of J S J^T products that cancel in float32."""
    d = np.abs(np.diagonal(ref, axis1=-2, axis2=-1))
    scale = np.sqrt(d[..., :, None] * d[..., None, :])
    assert np.all(np.abs(port - ref) <= rtol * scale + 1e-12)


def _assert_cov_near_f64(port, ref, exact):
    """Both float32 covariances against ``exact``, the port run on float64 tensors
    (the same function on the same rounded inputs).  Entries that cancel in
    J S J^T (rho and angle variances, 1e-12 to 1e-7 against mm^2 terms) are
    percent-level off in float32 on both sides: on feature 4's angle entry
    [4, 4] of the depth fusion the port is -1.8% and JAX +0.2% off float64, and
    JAX is 3.1% off on that feature's worst entry.  So each entry of the port,
    at the correlation scale sqrt(|S_ii S_jj|) of ``exact``, is held to
    max(1e-2, 2 x the JAX float32 error of the same feature)."""
    d = np.abs(np.diagonal(exact, axis1=-2, axis2=-1))
    scale = np.sqrt(d[..., :, None] * d[..., None, :]) + 1e-30
    port_err = np.abs(port - exact) / scale
    ref_err = (np.abs(ref - exact) / scale).reshape(len(exact), -1).max(axis=-1)
    bound = np.maximum(1e-2, 2.0 * ref_err)[:, None, None]
    assert np.all(port_err <= bound), (port_err / bound).max()


def _id_states(rng, n, c2w):
    uv = rng.uniform([10, 10], [630, 470], (n, 2)).astype(np.float32)
    st = np.array(j_idp.from_screen_observation(uv, c2w, CAM, baseline_rho=5e-4))
    st[:, 3] = rng.uniform(2e-4, 1e-3, n)
    return st.astype(np.float32), uv


@pytest.mark.parametrize("with_depth", [False, True])
def test_inverse_depth_fusion(with_depth):
    rng = np.random.default_rng(1)
    q = np.array([0.999, 0.02, -0.03, 0.01], np.float32)
    q /= np.linalg.norm(q)
    c2w = np.asarray(j_se3.camera_to_world(q, np.array([50.0, -20.0, 10.0], np.float32)))
    pose_cov = _spd(rng, 3, 1, 1e-3)[0]
    st, uv = _id_states(rng, 16, c2w)
    cov = np.asarray(j_idt.initial_covariance(np.broadcast_to(pose_cov, (16, 3, 3)), DET))
    obs_uv = (uv + rng.normal(0, 1.0, uv.shape)).astype(np.float32)
    def f64(a):
        return torch.from_numpy(np.asarray(a, np.float64))

    if with_depth:
        scr = np.concatenate([obs_uv, rng.uniform(800, 3000, (16, 1))], -1).astype(np.float32)
        j = j_idt.fuse_screen_observation_3d(st, cov, scr, c2w, pose_cov, CAM)
        t = idt.fuse_screen_observation_3d(_t(st), _t(cov), _t(scr), _t(c2w), _t(pose_cov),
                                           CAM)
        exact = idt.fuse_screen_observation_3d(f64(st), f64(cov), f64(scr), f64(c2w),
                                               f64(pose_cov), CAM)
    else:
        j = j_idt.fuse_screen_observation_2d(st, cov, obs_uv, c2w, pose_cov, CAM, DET)
        t = idt.fuse_screen_observation_2d(_t(st), _t(cov), _t(obs_uv), _t(c2w),
                                           _t(pose_cov), CAM, DET)
        exact = idt.fuse_screen_observation_2d(f64(st), f64(cov), f64(obs_uv), f64(c2w),
                                               f64(pose_cov), CAM, DET)
    assert exact[1].dtype == torch.float64
    _close(t[0], j[0], rtol=1e-4, atol=1e-6)
    _assert_cov_near_f64(t[1].numpy(), np.asarray(j[1]), exact[1].numpy())
    np.testing.assert_array_equal(t[2].numpy(), np.asarray(j[2]))
    # the score reads sqrt of the fused rho variance, an entry of J S J^T that
    # cancels in float32 (1e-8 against mm^2 terms): against the float64 score,
    # max(1e-2, 2 x the JAX float32 error) relative, per feature
    exact_score = idt.linearity_score(exact[0], exact[1], f64(c2w)).numpy()
    port_err = np.abs(idt.linearity_score(t[0], t[1], _t(c2w)).numpy() - exact_score)
    ref_err = np.abs(np.asarray(j_idt.linearity_score(j[0], j[1], c2w)) - exact_score)
    assert np.all(port_err <= np.maximum(1e-2, 2.0 * ref_err / np.abs(exact_score))
                  * np.abs(exact_score) + 1e-6)
    _close(idt.cartesian_covariance(_t(st), _t(cov)), j_idt.cartesian_covariance(st, cov),
           rtol=1e-4, atol=1e-3)


def test_motion_model():
    j_state = j_motion.reset()
    t_state = motion_model.reset(device="cpu")
    rng = np.random.default_rng(2)
    for i in range(3):
        q = rng.normal(size=4).astype(np.float32)
        q /= np.linalg.norm(q)
        p = rng.normal(0, 100, 3).astype(np.float32)
        j_state, jq, jp, _ = j_motion.predict_next_pose(j_state, q, p)
        t_state, tq, tp, _ = motion_model.predict_next_pose(t_state, _t(q), _t(p))
        _close(tq, jq, atol=1e-6)
        _close(tp, jp)
        for a, b in zip(t_state, j_state):
            _close(a, b, atol=1e-5)
        jq2, jp2 = j_motion.predict_pose(j_state, q, p)
        tq2, tp2 = motion_model.predict_pose(t_state, _t(q), _t(p))
        _close(tq2, jq2, atol=1e-6)
        _close(tp2, jp2)


def test_slot_allocation_and_lifecycle():
    rng = np.random.default_rng(3)
    for _ in range(4):
        free = rng.uniform(size=64) > 0.6
        want = rng.uniform(size=100) > 0.5
        np.testing.assert_array_equal(
            maps.allocate_slots(_t(free), _t(want)).numpy(),
            np.asarray(j_maps.allocate_slots(jnp.asarray(free), jnp.asarray(want))))
    is_local = rng.uniform(size=64) > 0.5
    mc = rng.integers(0, 5, 64).astype(np.int32)
    miss = rng.integers(0, 12, 64).astype(np.int32)
    matched = rng.uniform(size=64) > 0.5
    j = j_maps.lifecycle_update(is_local, mc, miss, matched, 3, 10)
    t = maps.lifecycle_update(_t(is_local), _t(mc), _t(miss), _t(matched), 3, 10)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert a.dtype in (torch.bool, torch.int32)
    m = maps.remove_features(maps.empty_point_map(64, device="cpu")._replace(
        fid=torch.arange(64, dtype=torch.int32)), t[3])
    jm = j_maps.remove_features(j_maps.empty_point_map(64)._replace(
        fid=jnp.arange(64, dtype=jnp.int32)), j[3])
    np.testing.assert_array_equal(m.fid.numpy(), np.asarray(jm.fid))


def test_empty_maps_have_the_jax_shapes_and_dtypes():
    pairs = [(maps.empty_point_map(16, device="cpu"), j_maps.empty_point_map(16)),
             (maps.empty_point2d_map(16, device="cpu"), j_maps.empty_point2d_map(16)),
             (maps.empty_plane_map(8, device="cpu"), j_maps.empty_plane_map(8)),
             (maps.empty_line_map(4, device="cpu"), j_maps.empty_line_map(4))]
    for port, ref in pairs:
        assert port._fields == ref._fields
        for a, b in zip(port, ref):
            b = np.asarray(b)
            assert tuple(a.shape) == b.shape
            # descriptors are uint32 words in JAX, int32 bit patterns here
            want = np.int32 if b.dtype == np.uint32 else b.dtype
            assert a.numpy().dtype == want
