"""Per-step parity of the port's plane-and-point step with the JAX package's on
the scenes that only the benchmark drives: ``HardRoomScene``, the roll
trajectory and the tunnel flight.

The setup of test_torch_engine_planes.py (160x120 camera, 2 pyramid levels with
13 px windows, reduced capacities and batches, the JAX draws injected, each step
started from the JAX input state), over a few frames of each scene:

* ``hard``: ``HardRoomScene`` with depth noise, its hole radius scaled from
  640 to 160 px wide (28 -> 7 px) and a noise burst every 3rd frame, so that
  every frame has depth holes, frame 2 is a burst frame, and the hanging sphere
  occludes the front wall in every frame;
* ``roll``: the RoomScene on the first frames of a 40-frame roll trajectory
  (+-30 degrees about the optical axis, 4.6 degrees a frame at the start);
* ``tunnel``: ``TunnelScene`` on the forward flight of ``bench_torch.py``,
  where every frame detects a cylinder;
* ``prediction_blackout``: motion-model prediction on, 3 RoomScene orbit frames
  and then 2 of a blackout (featureless gray, no depth): a failed frame takes
  the predicted pose, and the model is reset by the failure.

Discrete fields must be equal, continuous ones within the bounds of
test_torch_engine_planes.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench_torch import tunnel_trajectory
from rgbd_slam_tpu import engine as j_engine
from rgbd_slam_tpu.config import DepthNoiseModel
from rgbd_slam_tpu.synthetic import (HardRoomScene, RoomScene, TunnelScene, orbit_trajectory,
                                     roll_trajectory)
from rgbd_slam_tpu_torch import convert, engine
from test_torch_engine import (CAM, DISCRETE_OUT, T_CAM, _assert_cov_close, _jax_step,
                               _port_config, assert_pose_close, jax_step_draws,
                               pose_cov_extra)
from test_torch_engine_planes import _assert_planes_close, _cfg

torch.set_num_threads(2)

N_FRAMES = 5
#: the hard scene's hole radius at 640 px wide, scaled to the test camera
HOLE_RADIUS_PX = 28.0 * CAM.width / 640.0
BURST_EVERY = 3


#: frames of the ``prediction_blackout`` scene before its blackout
N_LIT = 3


def _poses_and_frames(name):
    if name == "hard":
        scene = HardRoomScene(CAM, depth_noise=DepthNoiseModel(),
                              hole_radius_px=HOLE_RADIUS_PX, burst_every=BURST_EVERY)
        poses = orbit_trajectory(N_FRAMES, speed_mm=6.0)
    elif name == "roll":
        scene = RoomScene(CAM, depth_noise=DepthNoiseModel())
        poses = roll_trajectory(40)[:N_FRAMES]
    elif name == "tunnel":
        scene = TunnelScene(CAM)
        poses = tunnel_trajectory(N_FRAMES)
    else:
        scene = RoomScene(CAM, depth_noise=DepthNoiseModel())
        poses = orbit_trajectory(N_LIT, speed_mm=6.0)
        dark = (np.full((CAM.height, CAM.width), 128.0, np.float32),
                np.zeros((CAM.height, CAM.width), np.float32))
        return poses, [scene.render(q, p) for q, p in poses] + [dark] * (N_FRAMES - N_LIT)
    return poses, [scene.render(q, p) for q, p in poses]


@pytest.fixture(scope="module", params=["hard", "roll", "tunnel", "prediction_blackout"])
def stepped(request):
    """(scene, poses, frames, config, [(jax_state_in, jax state, jax out, port
    state, port out)])."""
    cfg = _cfg(64, prediction=request.param == "prediction_blackout")
    t_cfg = _port_config(cfg)
    poses, frames = _poses_and_frames(request.param)
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
    return request.param, poses, frames, cfg, results


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_step_output_matches_jax(stepped, frame):
    _, _, _, cfg, results = stepped
    _, _, j_out, _, t_out = results[frame]
    for name in DISCRETE_OUT:
        np.testing.assert_array_equal(getattr(t_out, name).numpy(),
                                      _np(getattr(j_out, name)), err_msg=name)
    assert_pose_close(t_out, j_out)
    _assert_cov_close(t_out.pose_cov.numpy(), _np(j_out.pose_cov).astype(np.float64),
                      extra=pose_cov_extra(t_out, j_out,
                                           cfg.engine.pose_covariance_mc_iterations))
    np.testing.assert_allclose(t_out.point_obs_uv.numpy(), _np(j_out.point_obs_uv),
                               atol=0.05)


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_next_state_matches_jax(stepped, frame):
    results = stepped[-1]
    _, j_new, j_out, t_new, t_out = results[frame]
    t_np = convert.state_to_numpy(t_new)
    for name in ("frame_idx", "failed_count", "is_lost", "next_id", "tracked_ok",
                 "tracked_map_idx"):
        np.testing.assert_array_equal(getattr(t_np, name), _np(getattr(j_new, name)),
                                      err_msg=name)
    for map_name in ("points", "points2d", "planes"):
        for f in ("fid", "is_local", "match_count", "miss_count"):
            np.testing.assert_array_equal(getattr(getattr(t_np, map_name), f),
                                          _np(getattr(getattr(j_new, map_name), f)),
                                          err_msg=f"{map_name}.{f}")
    np.testing.assert_array_equal(t_np.points.desc, _np(j_new.points.desc))
    alive = _np(j_new.points.fid) >= 0
    np.testing.assert_allclose(t_np.points.pos[alive], _np(j_new.points.pos)[alive],
                               rtol=1e-4, atol=0.5)
    _assert_planes_close(t_new.planes, j_new.planes, t_out, j_out)
    np.testing.assert_array_equal(t_np.motion.is_set, _np(j_new.motion.is_set))


def test_scenes_exercise_their_paths(stepped):
    """What each scene is there for happens in its frames: the hard scene's
    holes, its burst frame and its occluder (depth in front of the wall); a
    roll of several degrees a frame that tracking follows; a cylinder found on
    every tunnel frame; with prediction, a failed frame at the pose the model
    predicts and the model reset by the failure."""
    name, poses, frames, _, results = stepped
    outs = [r[2] for r in results]
    if name == "prediction_blackout":
        assert [bool(o.success) for o in outs] == [True] * N_LIT + [False] * (N_FRAMES - N_LIT)
        # the first failed frame moves on at the model's velocity, the second
        # (model reset) stays where the first left it
        first, second = outs[N_LIT].position, outs[N_LIT + 1].position
        assert float(jnp.linalg.norm(first - outs[N_LIT - 1].position)) > 1.0
        np.testing.assert_array_equal(_np(second), _np(first))
        assert not bool(results[N_LIT][1].motion.is_set)
        return
    assert all(bool(o.success) for o in outs)
    if name == "hard":
        holes = [float((d == 0).mean()) for _, d in frames]
        assert min(holes) > 0.01
        diffs = [np.abs(np.diff(d[d > 0])).mean() for _, d in frames]
        assert diffs[BURST_EVERY - 1] > 1.5 * np.median(diffs)    # the burst frame
        # the sphere: depth well short of the room's own at the same pose
        room = RoomScene(CAM)
        for (q, p), (_, d) in zip(poses, frames):
            assert ((d > 0) & (d < room.render(q, p)[1] - 300.0)).mean() > 0.01
    elif name == "roll":
        assert int(outs[-1].n_point_matches) >= 10
    else:
        assert all(int(o.n_cylinders) >= 1 for o in outs)
        assert all(int(_np(o.cylinder_cells).sum()) > 0 for o in outs)
