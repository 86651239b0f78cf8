"""Parity of the port's pose optimization (SPD solve, LM, P3P, RANSAC + refit +
Monte-Carlo covariance) with the JAX package, with the JAX random draws injected.

Tolerances: the LM runs the same iterations on the same residuals in float32;
the Jacobians (forward-mode AD on both sides) and the 6x6 solves round
differently, so poses agree to 1e-2 mm and 1e-5 in quaternion components, while
inlier masks, success and hypothesis choice must be equal.  The Monte-Carlo
covariance is the sample covariance of 16 LM solutions under the same noise,
each rounding differently: 1e-2 relative.  P3P roots
come from a closed-form quartic in float32, so candidates agree to 1e-3 of the
scene scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_slam_tpu.config import TUM_FR1, EngineConfig
from rgbd_slam_tpu.geometry import se3 as j_se3
from rgbd_slam_tpu.ops import p3p as j_p3p
from rgbd_slam_tpu.pose import linalg6 as j_linalg6
from rgbd_slam_tpu.pose import optimizer as j_opt
from rgbd_slam_tpu.pose.features import make_matched_features
from rgbd_slam_tpu_torch.config import EngineConfig as TEngineConfig
from rgbd_slam_tpu_torch.ops import p3p
from rgbd_slam_tpu_torch.pose import linalg6, optimizer
from rgbd_slam_tpu_torch.pose.features import MatchedFeatures
from rgbd_slam_tpu_torch.pose.optimizer import PoseDraws
from rgbd_slam_tpu_torch.pose.residuals import VariationNoise

torch.set_num_threads(2)

CAM = TUM_FR1
ENGINE = dict(pose_covariance_mc_iterations=16, ransac_hypothesis_batch=16,
              p3p_hypothesis_batch=8)


_jax_compute_optimized_pose = jax.jit(j_opt.compute_optimized_pose,
                                      static_argnames=("cam", "ransac_cfg", "engine_cfg"))


def _t(a):
    return torch.from_numpy(np.array(a))


def to_torch_features(feats) -> MatchedFeatures:
    return MatchedFeatures(*[_t(x) for x in feats])


def jax_pose_draws(key, capacities, engine_cfg) -> PoseDraws:
    """The draws ``rgbd_slam_tpu.pose.optimizer.compute_optimized_pose`` makes
    from ``key``, as a port PoseDraws (optimizer.py:132, :252, :268, :370 and
    residuals.py:236-258)."""
    k_subsets, k_p3p, k_cov = jax.random.split(key, 3)
    sub = jax.random.uniform(k_subsets, (engine_cfg.ransac_hypothesis_batch,
                                         sum(capacities)))
    tri = jax.random.uniform(k_p3p, (engine_cfg.p3p_hypothesis_batch, capacities[0]))
    cp, c2, ck, cl = j_opt._REFIT_CAPS

    def one(k):
        k1, k2, k3, k4, k5 = jax.random.split(k, 5)
        n = jax.random.normal
        return (n(k1, (cp, 3), jnp.float32), n(k2, (c2,), jnp.float32),
                n(k3, (c2,), jnp.float32), n(k4, (ck, 4), jnp.float32),
                n(k5, (cl, 6), jnp.float32))

    noise = jax.vmap(one)(jax.random.split(k_cov, engine_cfg.pose_covariance_mc_iterations
                                           + 1))
    return PoseDraws(subset_priority=_t(sub), p3p_priority=_t(tri),
                     noise=VariationNoise(*[_t(x) for x in noise]))


def _scene_features(seed, n_pts=48, n_out=8, n_2d=10):
    """Matched features of a posed camera: 3D points with 0.3 px noise and
    ``n_out`` gross outliers, plus inverse-depth points."""
    rng = np.random.default_rng(seed)
    q = np.array(j_se3.quat_normalize(jnp.asarray(
        [1.0, 0.02 * seed, -0.03, 0.01], jnp.float32)))
    p = np.array([120.0, -40.0, 30.0], np.float32)
    c2w = np.asarray(j_se3.camera_to_world(q, p))
    uv = rng.uniform([20, 20], [620, 460], (n_pts, 2))
    z = rng.uniform(800, 4000, (n_pts, 1))
    cam_pts = np.concatenate([(uv - [CAM.cx, CAM.cy]) / [CAM.fx, CAM.fy] * z, z], -1)
    world = cam_pts @ c2w[:3, :3].T + c2w[:3, 3]
    obs = uv + rng.normal(0, 0.3, uv.shape)
    obs[:n_out] += rng.uniform(20, 60, (n_out, 2))
    std = np.full((n_pts, 3), 5.0)
    # inverse-depth points: observations on the ray, state origin near the camera
    uv2 = rng.uniform([20, 20], [620, 460], (n_2d, 2))
    rays = np.concatenate([(uv2 - [CAM.cx, CAM.cy]) / [CAM.fx, CAM.fy],
                           np.ones((n_2d, 1))], -1) @ c2w[:3, :3].T
    theta = np.arctan2(np.hypot(rays[:, 0], rays[:, 1]), rays[:, 2])
    phi = np.arctan2(rays[:, 1], rays[:, 0])
    state2d = np.concatenate([np.tile(c2w[:3, 3], (n_2d, 1)),
                              np.full((n_2d, 1), 5e-4), theta[:, None], phi[:, None]], -1)
    std2d = np.tile([1.0, 1.0, 1.0, 2.5e-4, 0.01, 0.01], (n_2d, 1))
    f32 = np.float32
    feats = make_matched_features(
        point_obs_uv=obs.astype(f32), point_world=world.astype(f32),
        point_world_std=std.astype(f32), point2d_obs_uv=uv2.astype(f32),
        point2d_state=state2d.astype(f32), point2d_state_std=std2d.astype(f32),
        capacities=(64, 16, 8, 8))
    q0 = np.array(j_se3.quat_normalize(jnp.asarray(q) + jnp.asarray(
        [0.0, 0.01, 0.0, -0.01], jnp.float32)))
    return feats, q0, (p + np.array([15.0, -10.0, 8.0], f32)).astype(f32), q, p


def test_solve_spd_matches_unrolled_cholesky():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(32, 6, 6)).astype(np.float32)
    a = a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(6, dtype=np.float32)
    b = rng.normal(size=(32, 6)).astype(np.float32)
    np.testing.assert_allclose(linalg6.solve6_spd(_t(a), _t(b)).numpy(),
                               np.asarray(j_linalg6.solve6_spd(a, b)), rtol=1e-4,
                               atol=1e-5)
    bm = rng.normal(size=(32, 3, 3)).astype(np.float32)
    a3 = a[:, :3, :3].copy()
    np.testing.assert_allclose(linalg6.solve_spd(_t(a3), _t(bm)).numpy(),
                               np.asarray(j_linalg6.solve_spd(a3, bm)), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_lm_solve(seed):
    feats, q0, p0, _, _ = _scene_features(seed, n_out=0)
    c0 = np.asarray(j_se3.pose_to_coefficients(q0, p0))
    j_c, j_cost = jax.jit(j_opt.lm_solve, static_argnames=("cam", "iterations"))(
        jnp.asarray(c0), feats, CAM, iterations=8)
    t_c, t_cost = optimizer.lm_solve(_t(c0), to_torch_features(feats), CAM, iterations=8)
    np.testing.assert_allclose(t_c.numpy()[:3], np.asarray(j_c)[:3], atol=1e-2)
    np.testing.assert_allclose(t_c.numpy()[3:], np.asarray(j_c)[3:], atol=1e-5)
    np.testing.assert_allclose(t_cost.numpy(), np.asarray(j_cost), rtol=1e-3, atol=1e-4)


def test_p3p_candidates():
    rng = np.random.default_rng(4)
    feats, _, _, q, p = _scene_features(4, n_out=0)
    world = np.asarray(feats.point_world)[:48]
    uv = np.asarray(feats.point_obs_uv)[:48]
    idx = rng.integers(0, 48, (32, 3))
    tri_w = world[idx]
    d = np.concatenate([(uv[idx] - [CAM.cx, CAM.cy]) / [CAM.fx, CAM.fy],
                        np.ones((32, 3, 1))], -1)
    bear = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    jq, jp, jok = (np.asarray(x) for x in j_p3p.p3p(tri_w, bear))
    tq, tp, tok = (x.numpy() for x in p3p.p3p(_t(tri_w), _t(bear)))
    assert (tok == jok).mean() > 0.95
    both = tok & jok
    assert both.sum() > 20
    np.testing.assert_allclose(tp[both], jp[both], atol=3.0)      # mm, 1e-3 of ~3 m
    np.testing.assert_allclose(np.abs(np.sum(tq[both] * jq[both], -1)), 1.0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_optimized_pose_with_jax_draws(seed):
    feats, q0, p0, q_true, p_true = _scene_features(seed)
    cfg = EngineConfig(**ENGINE)
    key = jax.random.PRNGKey(seed)
    jr = _jax_compute_optimized_pose(key, jnp.asarray(q0), jnp.asarray(p0), feats, CAM,
                                     engine_cfg=cfg)
    draws = jax_pose_draws(key, (64, 16, 8, 8), cfg)
    tr = optimizer.compute_optimized_pose(_t(q0), _t(p0), to_torch_features(feats), CAM,
                                          engine_cfg=TEngineConfig(**ENGINE), draws=draws)
    assert bool(tr.success) == bool(jr.success)
    assert bool(tr.success)
    for name in ("point_inliers", "point2d_inliers", "plane_inliers", "line_inliers"):
        np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                      np.asarray(getattr(jr, name)), err_msg=name)
    assert not tr.point_inliers.numpy()[:8].any()      # the gross outliers
    np.testing.assert_allclose(tr.position.numpy(), np.asarray(jr.position), atol=1e-2)
    np.testing.assert_allclose(tr.quat.numpy(), np.asarray(jr.quat), atol=1e-5)
    np.testing.assert_allclose(tr.covariance.numpy(), np.asarray(jr.covariance),
                               rtol=1e-2, atol=1e-6)
    np.testing.assert_allclose(tr.inlier_score.numpy(), np.asarray(jr.inlier_score),
                               rtol=1e-6)
    assert np.linalg.norm(tr.position.numpy() - p_true) < 5.0


def test_generator_draws_give_a_pose():
    feats, q0, p0, _, p_true = _scene_features(5)
    gen = torch.Generator().manual_seed(0)
    tr = optimizer.compute_optimized_pose(_t(q0), _t(p0), to_torch_features(feats), CAM,
                                          engine_cfg=TEngineConfig(**ENGINE),
                                          generator=gen)
    assert bool(tr.success)
    assert np.linalg.norm(tr.position.numpy() - p_true) < 5.0
    with pytest.raises(ValueError):
        optimizer.compute_optimized_pose(_t(q0), _t(p0), to_torch_features(feats), CAM)
