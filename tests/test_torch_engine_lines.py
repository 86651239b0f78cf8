"""Per-step parity of the port's SLAM step with lines on against the JAX
package's ``engine.step(..., with_lines=True)``.

The setup of test_torch_engine.py (160x120 camera, reduced capacities, 4 map
lines, the JAX draws injected), planes off.  8 StripeWallScene frames on a
lateral run, then 11 frames of the same wall without its stripes: lines are
inserted (frame 0), matched and inliers of the pose (frames 1-7), promoted to
local (frame 2), a detection that matches nothing is inserted beside them
(frame 6), and on the plain wall every line misses until the local ones are
evicted (frames 16 and 18).

Discrete fields must be equal.  The pose is held to 0.1 sigma of the
reference's Monte-Carlo spread (test_torch_engine.py), line endpoints to 1e-2
mm plus what the frame's measured pose gap moves a point at their range, and
the endpoint covariances to the Kalman bound of that file.  A vertical
segment's two endpoints may come in either order (see test_torch_lines.py), so
a map line is compared in the order that fits, with its covariances in the
same order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_slam_tpu import engine as j_engine
from rgbd_slam_tpu.synthetic import StripeWallScene, WallScene, lateral_trajectory
from rgbd_slam_tpu_torch import convert, engine, runner
from test_torch_engine import (CAM, CFG, DISCRETE_OUT, T_CAM, T_CFG, _assert_cov_close,
                               _jax_step, assert_pose_close, fused_cov_extra,
                               jax_step_draws, pose_cov_extra, pose_gap)

torch.set_num_threads(2)

N_STRIPES = 8
#: more misses in a row than point_unmatched_count_to_loose
N_PLAIN = CFG.mapping.point_unmatched_count_to_loose + 1
N_FRAMES = N_STRIPES + N_PLAIN


@pytest.fixture(scope="module")
def frames():
    poses = lateral_trajectory(N_STRIPES, speed_mm=4.0)
    striped = StripeWallScene(CAM)
    plain = WallScene(CAM)
    return [striped.render(q, p) for q, p in poses] + [plain.render(*poses[-1])] * N_PLAIN


@pytest.fixture(scope="module")
def stepped(frames):
    """Both steps from each JAX input state, per frame: (jax state in, jax state
    out, jax output, port state out, port output)."""
    results = []
    j_state = j_engine.init_state(CAM, CFG, seed=0)
    for gray, depth in frames:
        t_state = convert.state_from_numpy(jax.tree.map(np.asarray, j_state), device="cpu")
        draws = jax_step_draws(j_state.key, CFG)
        j_new, j_out = _jax_step(j_state, jnp.asarray(gray), jnp.asarray(depth), CAM, CFG,
                                 with_planes=False, with_lines=True)
        t_new, t_out = engine.step(t_state, torch.from_numpy(gray), torch.from_numpy(depth),
                                   T_CAM, T_CFG, with_planes=False, with_lines=True,
                                   draws=draws)
        results.append((j_state, j_new, j_out, t_new, t_out))
        j_state = j_new
    return results


def _np(x):
    return np.asarray(x)


def _endpoint_tol(t_out, j_out, eps):
    """1e-2 mm plus how far the frame's pose gap moves a world point at the
    endpoints' range from the camera: |dp| + |d theta| * range."""
    dp, de = pose_gap(t_out, j_out)
    rng_mm = np.linalg.norm(eps.reshape(-1, 2, 3) - _np(j_out.position), axis=-1).max(axis=-1)
    return 1e-2 + np.linalg.norm(dp) + np.linalg.norm(de) * rng_mm


def _swapped(eps):
    return np.concatenate([eps[:, 3:], eps[:, :3]], axis=-1)


def _assert_lines_close(t_eps, j_eps, rows, t_out, j_out, t_cov=None, j_cov=None):
    """Endpoints [M, 6] (and covariances [M, 2, 3, 3]) of ``rows``, each line in
    the endpoint order that fits."""
    t_eps, j_eps = t_eps[rows], j_eps[rows].astype(np.float64)
    tol = _endpoint_tol(t_out, j_out, j_eps)[:, None]
    direct = np.abs(t_eps - j_eps)
    swap = np.abs(_swapped(t_eps) - j_eps)
    use_swap = swap.max(axis=-1) < direct.max(axis=-1)
    err = np.where(use_swap[:, None], swap, direct)
    assert np.all(err <= tol), (err - tol).max()
    if t_cov is not None:
        t_cov, j_cov = t_cov[rows], j_cov[rows].astype(np.float64)
        t_cov = np.where(use_swap[:, None, None, None], t_cov[:, ::-1], t_cov)
        _assert_cov_close(t_cov, j_cov, extra=fused_cov_extra(j_cov, t_out, j_out))


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_step_output_matches_jax(stepped, frame):
    _, _, j_out, _, t_out = stepped[frame]
    assert t_out._fields == j_out._fields
    for name in DISCRETE_OUT:
        np.testing.assert_array_equal(getattr(t_out, name).numpy(),
                                      _np(getattr(j_out, name)), err_msg=name)
    assert_pose_close(t_out, j_out)
    _assert_cov_close(t_out.pose_cov.numpy(), _np(j_out.pose_cov).astype(np.float64),
                      extra=pose_cov_extra(t_out, j_out,
                                           CFG.engine.pose_covariance_mc_iterations))
    # death-export record of evicted lines: the updated endpoints
    evicted = _np(j_out.line_evicted)
    _assert_lines_close(t_out.line_evict_eps.numpy(), _np(j_out.line_evict_eps), evicted,
                        t_out, j_out)


@pytest.mark.parametrize("frame", range(N_FRAMES))
def test_next_state_matches_jax(stepped, frame):
    _, j_new, j_out, t_new, t_out = stepped[frame]
    t_np = convert.state_to_numpy(t_new)
    for name in ("frame_idx", "failed_count", "is_lost", "next_id", "tracked_ok",
                 "tracked_map_idx"):
        np.testing.assert_array_equal(getattr(t_np, name), _np(getattr(j_new, name)),
                                      err_msg=name)
    for f in ("fid", "is_local", "match_count", "miss_count"):
        got, want = getattr(t_np.lines, f), _np(getattr(j_new.lines, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f"lines.{f}")
        np.testing.assert_array_equal(getattr(t_np.points, f), _np(getattr(j_new.points, f)),
                                      err_msg=f"points.{f}")
    assert t_np.lines.endpoints.shape == j_new.lines.endpoints.shape
    assert t_np.lines.cov.shape == j_new.lines.cov.shape
    alive = _np(j_new.lines.fid) >= 0
    _assert_lines_close(t_np.lines.endpoints, _np(j_new.lines.endpoints), alive, t_out, j_out,
                        t_np.lines.cov, _np(j_new.lines.cov))


def test_sequence_exercises_the_line_path(stepped):
    """Lines are inserted, matched as pose inliers, promoted to local, a later
    detection is inserted beside them, and local lines are evicted."""
    inserted = matched = evicted = 0
    for j_in, j_new, j_out, _, _ in stepped:
        old, new = _np(j_in.lines.fid), _np(j_new.lines.fid)
        inserted += int(((new >= 0) & (new != old)).sum())
        matched += int(j_out.n_line_matches)
        evicted += int(_np(j_out.line_evicted).sum())
    assert inserted >= 4 and matched >= 12 and evicted >= 2
    assert any(_np(j_new.lines.is_local).any() for _, j_new, _, _, _ in stepped)
    assert all(bool(j_out.success) for _, _, j_out, _, _ in stepped)
    # frames 1..: a frame with line inliers also has point inliers: both blocks
    # are in the pose
    assert any(int(o.n_line_matches) > 0 and int(o.n_point_inliers) > 0
               for _, _, o, _, _ in stepped)


def test_filled_line_map_crosses_convert_both_ways(stepped):
    j_state = stepped[N_STRIPES - 1][1]
    assert (_np(j_state.lines.fid) >= 0).sum() >= 3
    j_np = jax.tree.map(np.asarray, j_state)
    back = convert.state_to_numpy(convert.state_from_numpy(j_np, device="cpu"))
    for f in j_np.lines._fields:
        a, b = getattr(back.lines, f), getattr(j_np.lines, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_runner_runs_the_line_step(frames):
    """run_frames(with_lines=True) over the striped frames: every frame tracks,
    lines are alive in the map at the end and matched on some frame."""
    matches = []
    state, traj, stats = runner.run_frames(
        frames[:N_STRIPES], T_CAM, T_CFG, with_planes=False, with_lines=True,
        device="cpu", on_frame=lambda i, s, o, dt: matches.append(int(o.n_line_matches)))
    assert stats.frame_count == N_STRIPES and stats.success_count == N_STRIPES
    assert int((state.lines.fid >= 0).sum()) >= 2
    assert max(matches) >= 2
    assert np.isfinite(traj.positions_array()).all()
