"""Per-step parity of the port's points-only SLAM step with the JAX package's
``engine.step(..., with_planes=False)``.

Each frame starts both steps from the same input state (the JAX state carried
across by ``rgbd_slam_tpu_torch.convert``), with the JAX step's random draws
injected into the port.  Setup: a 160x120 camera, 2 pyramid levels, reduced
capacities and Monte-Carlo/RANSAC batches, 5 RoomScene orbit frames, then a
blackout that fails the pose until tracking is lost, then frames that re-seed the
map from the lost state.  On the CPU
the JAX step runs its XLA LK path; with 13 px windows at every level both LK
window clamps (level size - 3 there, - 8 in the Pallas kernel the port follows)
give the same windows.

Discrete fields (ids, masks, counters, descriptors, lifecycle) must be equal.
Continuous fields: the LK results agree to 0.05 px (see test_torch_lk.py), and
everything downstream of them (poses, Kalman-fused map points, projections) to
the tolerances stated at each comparison.

The pose is held to the reference in units of the reference's own Monte-Carlo
pose spread, because the reference itself moves by more than a fixed float32
bound: with XLA's CPU code generation capped at AVX2 (tests/conftest.py) the
JAX step's frame-1 position is [0.0697, -1.8781, 0.2044] mm, uncapped it is
[0.0393, -2.0846, 0.2207] mm, while that frame's Monte-Carlo sigma is
[3.39, 10.13, 1.07] mm.  The quantities computed from the pose (map-point
covariances, the next tracked set) get bounds propagated from the measured pose
gap of the same frame.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rgbd_slam_tpu_torch.config as tcfg
from rgbd_slam_tpu import engine as j_engine
from rgbd_slam_tpu.config import (CameraIntrinsics, DepthNoiseModel, DetectionConfig,
                                  EngineConfig, MappingConfig, SlamConfig)
from rgbd_slam_tpu.geometry import se3 as j_se3
from rgbd_slam_tpu.synthetic import RoomScene, orbit_trajectory
from rgbd_slam_tpu_torch import convert, engine, runner
from test_torch_pose import jax_pose_draws

torch.set_num_threads(2)

CAM = CameraIntrinsics(width=160, height=120, fx=130.0, fy=130.0, cx=80.0, cy=60.0)
CFG = SlamConfig(
    detection=DetectionConfig(optical_flow_pyramid_depth=2,
                              optical_flow_coarse_window_px=13),
    mapping=MappingConfig(max_points_3d=128, max_points_2d=64, max_planes=8,
                          max_lines=4, max_tracked_points=64),
    engine=EngineConfig(pose_covariance_mc_iterations=16, ransac_hypothesis_batch=16,
                        p3p_hypothesis_batch=8))


def _port_config(cfg):
    """The same configuration as the port's own dataclasses."""
    return tcfg.SlamConfig(**{
        f.name: getattr(tcfg, type(getattr(cfg, f.name)).__name__)(
            **dataclasses.asdict(getattr(cfg, f.name)))
        for f in dataclasses.fields(cfg)})


T_CAM = tcfg.CameraIntrinsics(**dataclasses.asdict(CAM))
T_CFG = _port_config(CFG)
N_TRACKED = 5
#: > max_failed_tracking failures in a row: the last blackout frame is lost
N_BLACKOUT = CFG.engine.max_failed_tracking + 2
N_RECOVER = 2
N_FRAMES = N_TRACKED + N_BLACKOUT + N_RECOVER

_jax_step = jax.jit(j_engine.step, static_argnames=("cam", "cfg", "with_planes",
                                                     "with_lines"))


def jax_step_draws(key, cfg) -> engine.StepDraws:
    """The draws ``rgbd_slam_tpu.engine.step`` makes from ``state.key``
    (engine.py:299, :963 and the pose optimizer's)."""
    _, k_drop, k_opt = jax.random.split(key, 3)
    m = cfg.mapping
    drop = jax.random.randint(k_drop, (m.max_points_3d,), 0,
                              2 * cfg.detection.keypoint_refresh_frequency)
    caps = (m.max_points_3d, m.max_points_2d, m.max_planes, m.max_lines)
    return engine.StepDraws(drop=torch.from_numpy(np.array(drop)),
                            pose=jax_pose_draws(k_opt, caps, cfg.engine))


@pytest.fixture(scope="module")
def frames():
    """RoomScene frames with depth noise and a depth-less band on the left, so
    detections there become inverse-depth (2D) points and tracked map points
    there fuse depth-less observations; then a blackout (featureless gray, no
    depth) and the last tracked view again."""
    scene = RoomScene(CAM, depth_noise=DepthNoiseModel())
    poses = orbit_trajectory(N_TRACKED, speed_mm=6.0)
    poses = poses + [None] * N_BLACKOUT + [poses[-1]] * N_RECOVER
    out = []
    for pose in poses:
        if pose is None:
            out.append((np.full((CAM.height, CAM.width), 128.0, np.float32),
                        np.zeros((CAM.height, CAM.width), np.float32)))
            continue
        gray, depth = scene.render(*pose)
        depth[:, :24] = 0.0
        out.append((gray, depth))
    return out


@pytest.fixture(scope="module")
def stepped(frames):
    """Both steps from each JAX input state: [(jax_state_in, jax (state, out),
    port (state, out))] per frame."""
    results = []
    j_state = j_engine.init_state(CAM, CFG, seed=0)
    for gray, depth in frames:
        t_state = convert.state_from_numpy(jax.tree.map(np.asarray, j_state), device="cpu")
        draws = jax_step_draws(j_state.key, CFG)
        j_new, j_out = _jax_step(j_state, jnp.asarray(gray), jnp.asarray(depth), CAM, CFG,
                                 with_planes=False)
        t_new, t_out = engine.step(t_state, torch.from_numpy(gray), torch.from_numpy(depth),
                                   T_CAM, T_CFG, with_planes=False, draws=draws)
        results.append((j_new, j_out, t_new, t_out))
        j_state = j_new
    return results


def _np(x):
    return np.asarray(x)


def _assert_cov_close(port, ref, rtol=1e-2, extra=0.0):
    """Each entry to ``rtol`` of its correlation scale sqrt(S_ii S_jj), plus
    ``extra`` (same units as the entries)."""
    d = np.abs(np.diagonal(ref, axis1=-2, axis2=-1))
    scale = np.sqrt(d[..., :, None] * d[..., None, :])
    err = np.abs(port - ref)
    assert np.all(err <= rtol * scale + extra), (err / scale).max()


#: the port's pose may differ from the JAX step's by this fraction of the
#: reference's Monte-Carlo standard deviation on each axis.  It admits the ISA
#: spread of the reference: at frame 1 the port's position is [0.0354, -2.1021,
#: 0.2218] mm, 0.224 mm from the AVX2-capped reference on y against a bound of
#: 0.1 * 10.13 = 1.01 mm, and its euler angles are [7.0e-5, 1.3e-5, 6.4e-6] rad
#: off against bounds of [3.2e-4, 1.1e-4, 3.3e-5] rad.
POSE_SIGMA_FRACTION = 0.1
#: floors of the pose bound where the spread is ~0 (first frame, failed frames
#: that keep the pose): 5e-2 mm and 2e-5 rad, the float32 bounds used before
POSE_FLOOR = np.array([5e-2, 5e-2, 5e-2, 2e-5, 2e-5, 2e-5])


def euler_xyz(q):
    """Euler angles (R = Rx(a) Ry(b) Rz(c)) of a [w, x, y, z] quaternion, the
    parametrization of the rotation block of the pose covariance."""
    w, x, y, z = np.asarray(q, np.float64)
    return np.array([np.arctan2(-2 * (y * z - w * x), 1 - 2 * (x * x + y * y)),
                     np.arcsin(np.clip(2 * (x * z + w * y), -1.0, 1.0)),
                     np.arctan2(-2 * (x * y - w * z), 1 - 2 * (y * y + z * z))])


def pose_gap(t_out, j_out):
    """(|position difference| [3] mm, |euler difference| [3] rad) of two outputs."""
    dp = np.abs(t_out.position.numpy().astype(np.float64) - _np(j_out.position))
    de = euler_xyz(t_out.quat.numpy()) - euler_xyz(_np(j_out.quat))
    return dp, np.abs((de + np.pi) % (2 * np.pi) - np.pi)


def mc_sigma(j_out):
    """Per-axis Monte-Carlo standard deviation of the reference pose: the pose
    covariance's diagonal less the optimizer's 1e-3 floor."""
    return np.sqrt(np.maximum(np.diagonal(_np(j_out.pose_cov)).astype(np.float64)
                              - 1e-3, 0.0))


def assert_pose_close(t_out, j_out):
    """The pose bound: per axis max(POSE_FLOOR, POSE_SIGMA_FRACTION * sigma)."""
    gap = np.concatenate(pose_gap(t_out, j_out))
    bound = np.maximum(POSE_FLOOR, POSE_SIGMA_FRACTION * mc_sigma(j_out))
    assert np.all(gap <= bound), (gap, bound)


def pose_cov_extra(t_out, j_out, n_members):
    """Bound on how far the Monte-Carlo sample covariance moves when each of its
    ``n_members`` solutions moves by at most the frame's pose gap g:
    |dC_ij| <= 2 sqrt(n / (n - 1)) (sigma_i g_j + sigma_j g_i) (Cauchy-Schwarz on
    the centered samples).  At frame 1 under the AVX2 cap the worst entry is
    0.030 of its correlation scale, against 0.01 + 0.067 from this bound."""
    g = np.concatenate(pose_gap(t_out, j_out))
    sigma = mc_sigma(j_out)
    k = 2.0 * np.sqrt(n_members / (n_members - 1.0))
    return k * (sigma[:, None] * g[None, :] + g[:, None] * sigma[None, :])


def fused_cov_extra(cov, t_out, j_out):
    """Bound on how far a Kalman-fused world covariance S moves with the frame's
    pose: its observation covariance R = Rot C Rot^T + P (P the pose covariance's
    position block) moves by at most 2 |rotation gap| lambda_max(S) (d(Rot C
    Rot^T) = W C - C W) plus |dP|_F, and the fused covariance moves by at most as
    much as R does.  At frame 1 under the AVX2 cap the worst map-point entry is
    0.016 of its correlation scale."""
    rot = 2.0 * np.linalg.norm(pose_gap(t_out, j_out)[1]) \
        * np.linalg.eigvalsh(cov)[..., -1][..., None, None]
    d_pos_cov = t_out.pose_cov.numpy()[:3, :3].astype(np.float64) - _np(j_out.pose_cov)[:3, :3]
    return rot + np.linalg.norm(d_pos_cov)


def tracked_uv_bound(t_out, j_out, j_new, cam):
    """Bound on each next-frame projection: the LK/float bound 0.05 px plus what
    the frame's pose gap moves it, f * (2 |rotation gap| + |position gap| / z)
    (the 2 covers the off-axis growth 1 + r^2/f^2 of the rotation term)."""
    dp, de = pose_gap(t_out, j_out)
    w2c = np.linalg.inv(np.asarray(j_se3.camera_to_world(j_out.quat, j_out.position)))
    z = (_np(j_new.points.pos) @ w2c[:3, :3].T + w2c[:3, 3])[..., 2]
    f = max(cam.fx, cam.fy)
    z_t = z[np.clip(_np(j_new.tracked_map_idx), 0, None)]
    return 0.05 + f * (2.0 * np.linalg.norm(de) + np.linalg.norm(dp) / np.maximum(z_t, 1.0))


DISCRETE_OUT = ("success", "is_lost", "n_point_matches", "n_point_inliers",
                "n_points_alive", "n_planes_alive", "n_detected", "n_lines",
                "n_line_matches", "n_lines_alive", "n_cylinders",
                "n_plane_merge_dropped", "cylinder_cells", "point_matched", "point_fid",
                "n_evicted", "point_evicted", "point2d_evicted", "plane_evicted",
                "line_evicted")


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_step_output_matches_jax(stepped, frame):
    _, j_out, _, t_out = stepped[frame]
    assert t_out._fields == j_out._fields
    for name in DISCRETE_OUT:
        np.testing.assert_array_equal(getattr(t_out, name).numpy(),
                                      _np(getattr(j_out, name)), err_msg=name)
    # pose: LM on the same inliers from the same hypotheses, held to the
    # reference's own Monte-Carlo spread (POSE_SIGMA_FRACTION)
    assert_pose_close(t_out, j_out)
    # Monte-Carlo covariance: sample covariance of the same 16 perturbed 6-step
    # LM solves; each entry to 1e-2 of its correlation scale sqrt(S_ii S_jj),
    # plus what the frame's pose gap moves the samples by
    _assert_cov_close(t_out.pose_cov.numpy(), _np(j_out.pose_cov).astype(np.float64),
                      extra=pose_cov_extra(t_out, j_out,
                                           CFG.engine.pose_covariance_mc_iterations))
    # LK observations: 0.05 px; descriptor-matched ones are detections (1e-4 px)
    np.testing.assert_allclose(t_out.point_obs_uv.numpy(), _np(j_out.point_obs_uv),
                               atol=0.05)
    np.testing.assert_allclose(t_out.point_obs_z.numpy(), _np(j_out.point_obs_z))
    np.testing.assert_allclose(t_out.point_evict_pos.numpy(), _np(j_out.point_evict_pos),
                               rtol=1e-4, atol=0.5)


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_next_state_matches_jax(stepped, frame):
    j_new, j_out, t_new, t_out = stepped[frame]
    t_np = convert.state_to_numpy(t_new)
    for name in ("frame_idx", "failed_count", "is_lost", "next_id", "tracked_ok",
                 "tracked_map_idx"):
        np.testing.assert_array_equal(getattr(t_np, name), _np(getattr(j_new, name)),
                                      err_msg=name)
    for map_name, fields in (("points", ("desc", "fid", "is_local", "match_count",
                                         "miss_count", "is_moving")),
                             ("points2d", ("desc", "fid", "is_local", "match_count",
                                           "miss_count")),
                             ("planes", ("fid", "is_local", "match_count", "miss_count")),
                             ("lines", ("fid", "is_local", "match_count", "miss_count"))):
        for f in fields:
            got = getattr(getattr(t_np, map_name), f)
            want = _np(getattr(getattr(j_new, map_name), f))
            assert got.dtype == want.dtype, (map_name, f)
            np.testing.assert_array_equal(got, want, err_msg=f"{map_name}.{f}")
    alive = _np(j_new.points.fid) >= 0
    # map points: Kalman fusions of observations at poses that agree to 5e-2 mm
    # and LK positions that agree to 0.05 px (0.5 mm at this depth and focal)
    np.testing.assert_allclose(t_np.points.pos[alive], _np(j_new.points.pos)[alive],
                               rtol=1e-4, atol=0.5)
    # covariances: 1e-2 of the correlation scale, plus how far the frame's pose
    # gap moves the observation covariance they fused
    ref_cov = _np(j_new.points.cov)[alive].astype(np.float64)
    _assert_cov_close(t_np.points.cov[alive], ref_cov,
                      extra=fused_cov_extra(ref_cov, t_out, j_out))
    # inverse-depth points: the origin is the camera position when the point was
    # first seen (the pose tolerance above); rho and the angles to 1e-4
    alive2 = _np(j_new.points2d.fid) >= 0
    t2, j2 = t_np.points2d.state[alive2], _np(j_new.points2d.state)[alive2]
    np.testing.assert_allclose(t2[:, :3], j2[:, :3], atol=5e-2)
    np.testing.assert_allclose(t2[:, 3:], j2[:, 3:], rtol=1e-4, atol=1e-3)
    # next tracked set: projections of the map at the new pose
    ok = _np(j_new.tracked_ok)
    uv_err = np.abs(t_np.tracked_uv - _np(j_new.tracked_uv)).max(axis=-1)
    assert np.all(uv_err[ok] <= tracked_uv_bound(t_out, j_out, j_new, CAM)[ok])
    for a, b in zip(t_np.prev_pyramid, j_new.prev_pyramid):
        np.testing.assert_allclose(a, _np(b), atol=1e-3)
    np.testing.assert_allclose(t_np.motion.linear_velocity,
                               _np(j_new.motion.linear_velocity), atol=2e-2)
    np.testing.assert_array_equal(t_np.motion.is_set, _np(j_new.motion.is_set))


def test_sequence_tracks_and_exercises_every_branch(stepped):
    outs = [j_out for _, j_out, _, _ in stepped]
    success = [bool(o.success) for o in outs]
    lost = [bool(o.is_lost) for o in outs]
    assert all(success[:N_TRACKED])
    assert int(outs[N_TRACKED - 1].n_point_inliers) >= 20   # LK carries the pose
    assert int(_np(stepped[N_TRACKED - 1][0].points2d.fid >= 0).sum()) > 0
    # refresh (frame 0) and a tracking frame both ran
    assert int(outs[0].n_detected) > 0 and int(outs[1].n_point_matches) > 0
    # the blackout fails every frame and ends lost; the next frame starts lost,
    # so all its detections re-seed the map, and tracking comes back
    blackout = slice(N_TRACKED, N_TRACKED + N_BLACKOUT)
    assert not any(success[blackout]) and lost[N_TRACKED + N_BLACKOUT - 1]
    assert int(outs[N_TRACKED + N_BLACKOUT].n_detected) > 0
    assert success[-1] and not lost[-1]


def test_init_state_matches_jax():
    j = jax.tree.map(np.asarray, j_engine.init_state(CAM, CFG, seed=0))
    t = convert.state_to_numpy(engine.init_state(T_CAM, T_CFG, seed=0, device="cpu"))
    j_leaves = jax.tree_util.tree_leaves(j._replace(key=None))
    t_leaves = jax.tree_util.tree_leaves(t._replace(generator=None))
    assert len(j_leaves) == len(t_leaves)
    for a, b in zip(t_leaves, j_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # round trip through convert
    back = convert.state_to_numpy(convert.state_from_numpy(j, device="cpu"))
    for a, b in zip(jax.tree_util.tree_leaves(back._replace(generator=None)), j_leaves):
        np.testing.assert_array_equal(a, b)


def test_runner_and_unported_paths(frames):
    """run_frames drives the step (points only here, and the default plane step
    on one frame); lines and the BA backend, which used to raise, run (their own
    tests are test_torch_engine_lines.py and test_torch_ba.py); the sharded BA,
    depth rectification and the map writer, which used to raise by name, take
    their arguments (test_torch_sharded_ba.py, test_torch_cli.py, test_torch_io.py)."""
    seen = []
    state, traj, stats = runner.run_frames(
        frames[:3], T_CAM, T_CFG, with_planes=False, device="cpu",
        on_frame=lambda i, s, o, dt: seen.append(i))
    assert seen == [0, 1, 2] and stats.frame_count == 3 and len(traj.positions) == 3
    assert stats.success_count == 3 and stats.lost_count == 0
    assert int(state.frame_idx) == 3
    _, traj, stats = runner.run_frames(frames[:1], T_CAM, T_CFG, device="cpu")
    assert stats.frame_count == 1 and stats.success_count == 1 and len(traj.positions) == 1
    _, traj, stats = runner.run_frames(frames[:2], T_CAM, T_CFG, with_planes=False,
                                       with_lines=True, ba_every=2, device="cpu")
    assert stats.frame_count == 2 and stats.success_count == 2 and stats.keyframe_count >= 1
    assert stats.ba_runs == 0          # two keyframes at most: nothing to refine yet
    # a value of the wrong kind for the rig, the map file or the process group is
    # refused where it is first used
    for kw, error in (("ba_mesh", (TypeError, ValueError, AttributeError, RuntimeError)),
                      ("camera_setup", AttributeError), ("export_map", OSError)):
        with pytest.raises(error):
            runner.run_frames(frames[:1], T_CAM, T_CFG, with_planes=False, device="cpu",
                              **{kw: "/nowhere/asked for"})
