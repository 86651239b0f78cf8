"""Per-step parity of the port's default plane-and-point SLAM step with the JAX
package's ``engine.step(..., with_planes=True)``.

The setup of test_torch_engine.py (160x120 camera, 2 pyramid levels with 13 px
windows, so both JAX LK window clamps agree; reduced capacities and batches;
the JAX draws injected), over 10 RoomScene orbit frames with depth noise.  In
them planes are detected, matched, polygon-merged, inserted, promoted and
dropped, and one frame detects a cylinder.  Two tracked-set capacities: 64
(the fused forward-backward LK) and 50 (N % 4 != 0: the forward-only LK twice,
which the JAX step on the CPU composes the same way); and the fused one with
``use_motion_model_prediction`` on, where the motion model's prediction feeds
the LK and matching gates, the LM start and a failed frame's pose, and the
model's ``is_set`` flag must turn in the same frame in both packages.

Discrete fields (ids, masks, counters, polygon vertex counts, cylinder cells)
must be equal.  The pose is held to the reference's Monte-Carlo spread as in
test_torch_engine.py, and every world-frame plane quantity to a float32 bound
plus what the frame's measured pose gap moves it (``_pose_tol``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_slam_tpu import engine as j_engine
from rgbd_slam_tpu.config import DepthNoiseModel
from rgbd_slam_tpu.synthetic import RoomScene, orbit_trajectory
from rgbd_slam_tpu_torch import convert, engine, runner
from test_torch_engine import (CAM, CFG, DISCRETE_OUT, T_CAM, _assert_cov_close,
                               _jax_step, _port_config, assert_pose_close,
                               fused_cov_extra, jax_step_draws, pose_cov_extra, pose_gap)

torch.set_num_threads(2)

N_FRAMES = 10


def _cfg(tracked: int, prediction: bool = False):
    return dataclasses.replace(
        CFG, mapping=dataclasses.replace(CFG.mapping, max_tracked_points=tracked),
        engine=dataclasses.replace(CFG.engine, use_motion_model_prediction=prediction))


@pytest.fixture(scope="module")
def frames():
    scene = RoomScene(CAM, depth_noise=DepthNoiseModel())
    return [scene.render(q, p) for q, p in orbit_trajectory(N_FRAMES, speed_mm=6.0)]


@pytest.fixture(scope="module", params=[(64, False), (50, False), (64, True)],
                ids=["fused_lk", "forward_only_lk", "prediction"])
def stepped(request, frames):
    """Both steps from each JAX input state: [(jax_state_in, jax (state, out),
    port (state, out))] per frame."""
    cfg = _cfg(*request.param)
    t_cfg = _port_config(cfg)
    results = []
    j_state = j_engine.init_state(CAM, cfg, seed=0)
    for gray, depth in frames:
        t_state = convert.state_from_numpy(jax.tree.map(np.asarray, j_state), device="cpu")
        draws = jax_step_draws(j_state.key, cfg)
        j_new, j_out = _jax_step(j_state, jnp.asarray(gray), jnp.asarray(depth), CAM, cfg,
                                 with_planes=True)
        t_new, t_out = engine.step(t_state, torch.from_numpy(gray), torch.from_numpy(depth),
                                   T_CAM, t_cfg, with_planes=True, draws=draws)
        results.append((j_state, j_new, j_out, t_new, t_out))
        j_state = j_new
    return cfg, results


def _np(x):
    return np.asarray(x)


def _pose_tol(t_out, j_out, magnitude, base):
    """``base`` plus how far the frame's pose gap moves a world-frame quantity of
    size ``magnitude``: |dp| + |d theta| (|x| + |camera position|)."""
    dp, de = pose_gap(t_out, j_out)
    cam = np.linalg.norm(_np(j_out.position))
    return base + np.linalg.norm(dp) + np.linalg.norm(de) * (magnitude + cam)


PLANE_DISCRETE = ("fid", "is_local", "match_count", "miss_count", "poly_count")


def _assert_within(port, ref, tol, name=""):
    err = np.abs(port - ref)
    assert np.all(err <= tol), (name, (err - tol).max())


def _assert_planes_close(t_map, j_map, t_out, j_out):
    """Plane map (or eviction record) fields of live slots."""
    alive = _np(j_map.fid) >= 0
    for f in PLANE_DISCRETE:
        np.testing.assert_array_equal(getattr(t_map, f).numpy(), _np(getattr(j_map, f)),
                                      err_msg=f)
    p_t, p_j = t_map.params.numpy()[alive], _np(j_map.params)[alive]
    # unit normals: 1e-5 plus the rotation gap; d (mm): 1e-2 mm relative plus
    # the pose gap at the plane's distance
    _assert_within(p_t[:, :3], p_j[:, :3], _pose_tol(t_out, j_out, 1.0, 1e-5), "normal")
    _assert_within(p_t[:, 3], p_j[:, 3], _pose_tol(t_out, j_out, np.abs(p_j[:, 3]),
                                                   1e-5 * np.abs(p_j[:, 3]) + 1e-3), "d")
    for f in ("basis_center", "basis_u", "basis_v"):
        a, b = getattr(t_map, f).numpy()[alive], _np(getattr(j_map, f))[alive]
        mag = np.linalg.norm(b, axis=-1, keepdims=True)
        _assert_within(a, b, _pose_tol(t_out, j_out, mag, 1e-5 * mag + 1e-5), f)
    v_t, v_j = t_map.poly_verts.numpy()[alive], _np(j_map.poly_verts)[alive]
    cnt = _np(j_map.poly_count)[alive]
    for k in range(len(cnt)):
        mag = np.linalg.norm(v_j[k, :cnt[k]], axis=-1, keepdims=True)
        _assert_within(v_t[k, :cnt[k]], v_j[k, :cnt[k]],
                       _pose_tol(t_out, j_out, mag, 1e-4 * mag + 1e-3), "poly_verts")


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_step_output_matches_jax(stepped, frame):
    cfg, results = stepped
    _, _, j_out, _, t_out = results[frame]
    assert t_out._fields == j_out._fields
    for name in DISCRETE_OUT:
        np.testing.assert_array_equal(getattr(t_out, name).numpy(),
                                      _np(getattr(j_out, name)), err_msg=name)
    assert_pose_close(t_out, j_out)
    _assert_cov_close(t_out.pose_cov.numpy(), _np(j_out.pose_cov).astype(np.float64),
                      extra=pose_cov_extra(t_out, j_out,
                                           cfg.engine.pose_covariance_mc_iterations))
    np.testing.assert_allclose(t_out.point_obs_uv.numpy(), _np(j_out.point_obs_uv),
                               atol=0.05)
    # death-export records of evicted planes: the updated plane before insertion
    evicted = _np(j_out.plane_evicted)
    for f in ("plane_evict_params", "plane_evict_center", "plane_evict_u",
              "plane_evict_v"):
        a, b = getattr(t_out, f).numpy()[evicted], _np(getattr(j_out, f))[evicted]
        mag = np.linalg.norm(b, axis=-1, keepdims=True)
        _assert_within(a, b, _pose_tol(t_out, j_out, mag, 1e-5 * mag + 1e-3), f)
    np.testing.assert_array_equal(t_out.plane_evict_count.numpy()[evicted],
                                  _np(j_out.plane_evict_count)[evicted])


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_next_state_matches_jax(stepped, frame):
    _, results = stepped
    _, j_new, j_out, t_new, t_out = results[frame]
    t_np = convert.state_to_numpy(t_new)
    for name in ("frame_idx", "failed_count", "is_lost", "next_id", "tracked_ok",
                 "tracked_map_idx"):
        np.testing.assert_array_equal(getattr(t_np, name), _np(getattr(j_new, name)),
                                      err_msg=name)
    for f in ("desc", "fid", "is_local", "match_count", "miss_count", "is_moving"):
        np.testing.assert_array_equal(getattr(t_np.points, f), _np(getattr(j_new.points, f)),
                                      err_msg=f"points.{f}")
    _assert_planes_close(t_new.planes, j_new.planes, t_out, j_out)
    # the motion model: set in the same frame, velocities from poses that agree
    # to the pose bound
    np.testing.assert_array_equal(t_np.motion.is_set, _np(j_new.motion.is_set))
    np.testing.assert_allclose(t_np.motion.linear_velocity,
                               _np(j_new.motion.linear_velocity), atol=2e-2)
    np.testing.assert_allclose(t_np.motion.angular_velocity,
                               _np(j_new.motion.angular_velocity), atol=1e-5)
    # plane covariances: Kalman fusions of observation covariances rotated with
    # the frame's pose and carrying its position covariance (fused_cov_extra)
    alive = _np(j_new.planes.fid) >= 0
    ref_cov = _np(j_new.planes.cov)[alive].astype(np.float64)
    _assert_cov_close(t_np.planes.cov[alive], ref_cov,
                      extra=fused_cov_extra(ref_cov, t_out, j_out))


def test_sequence_exercises_the_plane_path(stepped):
    """Planes are detected and matched on at least half the frames, matched
    planes get their polygons merged, new detections are inserted, a staged
    plane is promoted, one is dropped, and a cylinder is detected."""
    _, results = stepped
    matched = merged = inserted = dropped = 0
    for j_in, j_new, j_out, _, _ in results:
        old, new = _np(j_in.planes.fid), _np(j_new.planes.fid)
        kept = (old >= 0) & (new == old)
        hit = kept & (_np(j_new.planes.miss_count) == 0)
        matched += int(hit.any())
        merged += int(np.any(_np(j_new.planes.poly_verts)[hit]
                             != _np(j_in.planes.poly_verts)[hit]))
        inserted += int(((new >= 0) & (new != old)).any())
        dropped += int(((old >= 0) & (new != old)).any())
        assert bool(j_out.success)
    assert matched >= N_FRAMES // 2 and merged >= N_FRAMES // 2
    assert inserted >= 2 and dropped >= 1
    assert _np(results[-1][1].planes.is_local).any()
    assert any(int(j_out.n_cylinders) > 0 for _, _, j_out, _, _ in results)


def test_runner_runs_the_plane_step(frames):
    """run_frames at its default (planes on) over the frames tracks every one."""
    state, traj, stats = runner.run_frames(frames[:4], T_CAM, _port_config(CFG),
                                           device="cpu")
    assert stats.frame_count == 4 and stats.success_count == 4 and stats.lost_count == 0
    assert int((state.planes.fid >= 0).sum()) > 0
    assert np.isfinite(traj.positions_array()).all()
