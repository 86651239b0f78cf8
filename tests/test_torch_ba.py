"""Parity of the port's backend with the JAX package: ``inv3``, the windowed
bundle adjustment, the keyframe window, and the runner's backend hooks.

``ba_solve`` runs on the synthetic window of tests/test_ba.py (6 keyframes, 128
landmarks, 4 observations each), perturbed, anchored and not, with and without
measured depths.  Both packages take the same Gauss-Newton steps in float32 with
different Cholesky routines and sum orders, so after 8 iterations the costs
agree to 1e-3 relative (measured: 5e-5; plus 1e-7 of the first cost, under which
a converged cost is rounding), poses to 5e-3 mm and 1e-6 in the
stereographic coefficients (measured: 6e-4 mm, 9e-8), landmarks to 5e-2 mm
(measured: 6e-3).  The keyframe window's bookkeeping is numpy in both packages
and must be equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rgbd_slam_tpu_torch.config as tcfg
from rgbd_slam_tpu import runner as j_runner
from rgbd_slam_tpu.geometry import pinhole as j_pinhole
from rgbd_slam_tpu.geometry import se3 as j_se3
from rgbd_slam_tpu.io.trajectory import Trajectory as JTrajectory
from rgbd_slam_tpu.parallel import ba as j_ba
from rgbd_slam_tpu.parallel.keyframes import KeyframeWindow as JKeyframeWindow
from rgbd_slam_tpu.pose import linalg6 as j_linalg6
from rgbd_slam_tpu_torch import engine, runner
from rgbd_slam_tpu_torch.io.trajectory import Trajectory
from rgbd_slam_tpu_torch.parallel import ba
from rgbd_slam_tpu_torch.parallel.keyframes import KeyframeWindow
from rgbd_slam_tpu_torch.pose import linalg6
from rgbd_slam_tpu_torch.synthetic import RoomScene, orbit_trajectory
from test_ba import CAM, make_window, perturb
from test_torch_engine import T_CAM as SMALL_CAM
from test_torch_engine import T_CFG as SMALL_CFG

torch.set_num_threads(2)

T_CAM = tcfg.CameraIntrinsics(**dataclasses.asdict(CAM))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_inv3_matches_jax():
    """The adjugate inverse is the same products in both packages: 1e-6
    relative to the largest entry; a singular matrix takes the +-eps floor."""
    rng = np.random.default_rng(0)
    a = rng.normal(0, 1, (5, 40, 3, 3)).astype(np.float32)
    a = a @ a.transpose(0, 1, 3, 2) + 0.1 * np.eye(3, dtype=np.float32)
    a[0, 0] = 0.0                                   # det = 0
    a[0, 1] = np.diag([1.0, 1.0, -1e-35]).astype(np.float32)
    got = linalg6.inv3(_t(a)).numpy()
    want = np.asarray(j_linalg6.inv3(jnp.asarray(a)))
    scale = np.abs(want).max(axis=(-1, -2), keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-6 * scale + 1e-30)
    np.testing.assert_allclose((a[1] @ got[1]), np.broadcast_to(np.eye(3), (40, 3, 3)),
                               atol=1e-3)


@pytest.fixture(scope="module")
def window():
    rng = np.random.default_rng(1000)
    gt_poses, gt_lm, obs_kf, uv, mask = make_window(rng)
    poses0, lm0 = perturb(rng, gt_poses, gt_lm)
    # measured depths: the landmark's depth in its keyframe, 30% missing
    z = np.zeros(mask.shape, np.float32)
    for l in range(z.shape[0]):
        for c in range(z.shape[1]):
            quat, pos = j_se3.coefficients_to_pose(gt_poses[int(obs_kf[l, c])])
            s, _ = j_pinhole.world_to_screen(gt_lm[l], j_se3.world_to_camera(quat, pos), CAM)
            z[l, c] = float(s[2])
    z[rng.uniform(size=z.shape) < 0.3] = 0.0
    return dict(gt_poses=np.asarray(gt_poses), poses0=np.asarray(poses0),
                lm0=np.asarray(lm0), obs_kf=np.asarray(obs_kf), uv=np.asarray(uv),
                mask=np.asarray(mask), z=z)


def _solve_both(w, iterations=8, **kw):
    z = kw.pop("obs_z", None)
    j = j_ba.ba_solve(jnp.asarray(w["poses0"]), jnp.asarray(w["lm0"]),
                      jnp.asarray(w["obs_kf"]), jnp.asarray(w["uv"]), jnp.asarray(w["mask"]),
                      CAM, iterations=iterations,
                      obs_z=None if z is None else jnp.asarray(z), **kw)
    t = ba.ba_solve(_t(w["poses0"]), _t(w["lm0"]), _t(w["obs_kf"]), _t(w["uv"]),
                    _t(w["mask"]), T_CAM, iterations=iterations,
                    obs_z=None if z is None else _t(z), **kw)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


@pytest.mark.parametrize("anchored", [False, True], ids=["free", "anchored"])
@pytest.mark.parametrize("with_z", [False, True], ids=["pixels", "rgbd"])
def test_ba_solve_matches_jax(window, anchored, with_z):
    (jp, jl, jc), (tp, tl, tc) = _solve_both(window, anchored=anchored,
                                             obs_z=window["z"] if with_z else None)
    assert tc.shape == (8,) and tp.shape == jp.shape and tl.shape == jl.shape
    np.testing.assert_allclose(tc, jc, rtol=1e-3, atol=1e-7 * jc[0])
    np.testing.assert_allclose(tp[:, :3], jp[:, :3], atol=5e-3)
    np.testing.assert_allclose(tp[:, 3:], jp[:, 3:], atol=1e-6)
    np.testing.assert_allclose(tl, jl, atol=5e-2)
    assert tc[-1] < tc[0]
    if not anchored and not with_z:
        # the free pixel solve converges to the ground truth (test_ba.py)
        assert tc[-1] < 1e-3 * tc[0]
        assert np.abs(tp[:, :3] - window["gt_poses"][:, :3]).max() < 5.0


def test_ba_gauge_is_fixed(window):
    _, (tp, _, _) = _solve_both(window, iterations=4)
    np.testing.assert_allclose(tp[0], window["poses0"][0], atol=1e-5)


def test_singular_window_gives_nonfinite_costs_and_does_not_raise(window):
    """A negative position anchor makes the reduced system indefinite: the
    Cholesky fails and the step is NaN in both packages, and nothing raises.
    The port's costs after the first are NaN, so the runner's finite-cost test
    refuses the window.  The JAX package's are 0 (a NaN pose's residuals are
    masked like an invalid projection), which its runner's test accepts: the
    reference's own divergence, listed in ROADMAP queue 3."""
    (jp, _, jc), (tp, _, tc) = _solve_both(window, iterations=3, anchored=True,
                                           anchor_weights=(1e-3, -1e6, 1e-3))
    np.testing.assert_allclose(tc[0], jc[0], rtol=1e-5)
    assert not np.isfinite(tp[1:]).any() and not np.isfinite(jp[1:]).any()
    assert np.isfinite(tc[0]) and np.isnan(tc[1:]).all()
    np.testing.assert_array_equal(jc[1:], 0.0)

    def accepted(costs):                                        # the runners' test
        return bool(np.isfinite(costs).all() and costs[-1] < costs[0])

    assert not accepted(tc) and accepted(jc)


def test_a_mesh_is_refused_by_name(window):
    """The sharded solve takes a process group (``group=``), not the JAX
    package's mesh axis: ``axis_name`` is refused as an unknown argument, and
    without a group the reduced-solver options change nothing (bit-equal)."""
    z = torch.zeros
    with pytest.raises(TypeError, match="axis_name"):
        ba._gn_iteration(z(2, 6), z(4, 3), z(4, 2, dtype=torch.int32), z(4, 2, 2),
                         z(4, 2, dtype=torch.bool), T_CAM, 2, axis_name="lm")
    args = [torch.tensor(window[name]) for name in ("poses0", "lm0", "obs_kf", "uv", "mask")]
    k = args[0].shape[0]
    ref = ba._gn_iteration(*args, T_CAM, k)
    for kw in (dict(reduced_solver="pcg"), dict(cg_iterations=4)):
        for a, b in zip(ba._gn_iteration(*args, T_CAM, k, **kw), ref):
            assert torch.equal(a, b)
    # an under-constrained window returns before it touches the mesh
    assert KeyframeWindow(device="cpu").refine(T_CAM, mesh=object()) is None


# ---------------------------------------------------------------------------
# KeyframeWindow
# ---------------------------------------------------------------------------

N_SLOTS = 48


class _Record:
    """One keyframe's observation record, as ``StepOutput`` carries it."""

    def __init__(self, matched, fid, uv, z):
        self.point_matched, self.point_fid = matched, fid
        self.point_obs_uv, self.point_obs_z = uv, z


def _keyframe_records(n_keyframes=10, seed=5):
    """Seeded keyframes on a lateral run over landmarks on a slab: per keyframe
    (quat, position, record, map positions).  Slots are reused by other feature
    ids over time, and every keyframe sees a random three quarters of the map."""
    rng = np.random.default_rng(seed)
    world = np.concatenate([rng.uniform(2000, 4000, (N_SLOTS + 12, 1)),
                            rng.uniform(-1200, 1200, (N_SLOTS + 12, 2))], 1).astype(np.float32)
    out = []
    for i in range(n_keyframes):
        quat = np.asarray(j_se3.quat_from_axis_angle(jnp.array([0.0, 0.0, 1.0]),
                                                     jnp.float32(0.01 * i)))
        pos = np.array([20.0 * i, 30.0 * i, 5.0 * i], np.float32)
        # slot s holds feature s, or feature N_SLOTS + s once it is reused
        fid = np.arange(N_SLOTS, dtype=np.int32)
        reused = (np.arange(N_SLOTS) < 12) & (i >= 5)
        fid[reused] += N_SLOTS
        fid[40:44] = -1
        lm = world[np.where(fid >= 0, fid, 0)]
        w2c = j_se3.world_to_camera(jnp.asarray(quat), jnp.asarray(pos))
        screen, ok = j_pinhole.world_to_screen(jnp.asarray(lm), w2c, CAM)
        screen = np.asarray(screen)
        matched = np.asarray(ok) & (rng.uniform(size=N_SLOTS) < 0.75)
        uv = (screen[:, :2] + rng.normal(0, 0.3, (N_SLOTS, 2))).astype(np.float32)
        z = np.where(rng.uniform(size=N_SLOTS) < 0.8, screen[:, 2], 0.0).astype(np.float32)
        noisy_lm = (lm + rng.normal(0, 15.0, lm.shape)).astype(np.float32)
        out.append((quat, pos, _Record(matched, fid, uv, z), noisy_lm))
    return out


def _fill(window, records, packed):
    for i, (quat, pos, rec, lm) in enumerate(records):
        if packed:
            fobs = np.concatenate([rec.point_matched.astype(np.float32)[:, None],
                                   rec.point_obs_uv, rec.point_obs_z[:, None], lm], -1)
            window.add_keyframe_packed(quat, pos, fobs, rec.point_fid, timestamp=float(i),
                                       frame_id=3 * i)
        else:
            window.add_keyframe(quat, pos, rec, lm, timestamp=float(i), frame_id=3 * i)
    return window


def _windows(packed, **kw):
    records = _keyframe_records()
    return (_fill(JKeyframeWindow(**kw), records, packed),
            _fill(KeyframeWindow(device="cpu", **kw), records, packed))


@pytest.mark.parametrize("packed", [False, True], ids=["add_keyframe", "add_keyframe_packed"])
def test_window_bookkeeping_equals_jax(packed):
    """10 keyframes into a window of 6 with 32 landmarks and 4 observations a
    landmark: it slides, truncates and counts alike, and packs equal arrays."""
    j, t = _windows(packed, max_keyframes=6, max_landmarks=32, max_obs_per_landmark=4)
    assert t.n_keyframes == j.n_keyframes == 6
    assert t.frame_ids == j.frame_ids == [12, 15, 18, 21, 24, 27]
    assert t.timestamps == j.timestamps
    j_prob, t_prob = j.build_problem(), t.build_problem()
    assert len(t_prob) == len(j_prob) == 9
    for a, b in zip(t_prob, j_prob):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert t.dropped_obs == j.dropped_obs > 0
    assert t.dropped_landmarks == j.dropped_landmarks > 0
    assert sorted(t.obs) == sorted(j.obs)


def test_underconstrained_window_builds_nothing():
    records = _keyframe_records(1)
    t = _fill(KeyframeWindow(device="cpu"), records, True)
    assert t.build_problem() is None and t.refine(T_CAM) is None
    assert t.transfers == {"uploads": 0, "readbacks": 0}


@pytest.fixture(scope="module")
def refined_windows():
    j, t = _windows(True, max_keyframes=6, max_landmarks=64)
    return j, t, j.refine(CAM, iterations=6), t.refine(T_CAM, iterations=6)


def test_refine_matches_jax(refined_windows):
    """The anchored RGB-D solve through both windows: costs to 1e-3 relative,
    keyframe positions to 5e-3 mm, quaternions to 1e-6, landmarks to 5e-2 mm."""
    j, t, (j_ref, j_lm, j_costs), (t_ref, t_lm, t_costs) = refined_windows
    assert len(t_ref) == len(j_ref) == 6
    np.testing.assert_allclose(t_costs, j_costs, rtol=1e-3)
    assert t_costs[-1] < t_costs[0]
    for (tq, tp), (jq, jp) in zip(t_ref, j_ref):
        np.testing.assert_allclose(tq, jq, atol=1e-6)
        np.testing.assert_allclose(tp, jp, atol=5e-3)
    # device_lm: (fids host, slots, new_lm, lm_valid, fids) with the last four
    # as tensors on the window's device
    assert len(t_lm) == len(j_lm) == 5
    np.testing.assert_array_equal(t_lm[0], j_lm[0])
    for k in (1, 3, 4):
        np.testing.assert_array_equal(t_lm[k].numpy(), np.asarray(j_lm[k]))
    valid = np.asarray(j_lm[3])
    np.testing.assert_allclose(t_lm[2].numpy()[valid], np.asarray(j_lm[2])[valid], atol=5e-2)
    assert all(isinstance(x, torch.Tensor) for x in t_lm[1:])
    # one copy to the device and one read back a refine
    assert t.transfers == {"uploads": 1, "readbacks": 1}


def test_apply_refinement_feeds_back(refined_windows):
    j, t, (j_ref, j_lm, _), (t_ref, t_lm, _) = refined_windows
    j.apply_refinement(j_ref, j_lm)
    t.apply_refinement(t_ref, t_lm)
    q, p = t_ref[-1]
    np.testing.assert_allclose(
        t.poses[-1],
        np.asarray(j_se3.pose_to_coefficients(jnp.asarray(q), jnp.asarray(p))), atol=1e-5)
    for a, b in zip(t.poses, j.poses):
        np.testing.assert_allclose(a[:3], b[:3], atol=5e-3)
        np.testing.assert_allclose(a[3:], b[3:], atol=1e-6)
    assert sorted(t.landmark_pos) == sorted(j.landmark_pos)
    moved = 0
    for fid, pos in j.landmark_pos.items():
        np.testing.assert_allclose(t.landmark_pos[fid], pos, atol=5e-2)
    fids, new_lm = t_lm[0], t_lm[2].numpy()
    for i, fid in enumerate(fids):
        if fid >= 0:
            moved += int(np.array_equal(t.landmark_pos[int(fid)], new_lm[i]))
    assert moved >= 8


# ---------------------------------------------------------------------------
# the runner's hooks
# ---------------------------------------------------------------------------

def test_scatter_kernel_matches_jax():
    """The landmark scatter writes a refined position only into a slot that
    still holds its feature id, for a valid landmark that moved <= 300 mm."""
    rng = np.random.default_rng(8)
    m, l = 64, 24
    pos = rng.uniform(-3000, 3000, (m, 3)).astype(np.float32)
    fid = np.arange(100, 100 + m, dtype=np.int32)
    slots = rng.permutation(m)[:l].astype(np.int32)
    slots[l - 6:] = 0                                  # padding rows point at slot 0
    fids = fid[slots].copy()
    new_lm = (pos[slots] + rng.normal(0, 20.0, (l, 3))).astype(np.float32)
    valid = np.ones(l, bool)
    valid[l - 6:] = False
    fids[3] += 1000                                    # its slot went to another feature
    valid[5] = False                                   # not valid in the window
    new_lm[7] += 301.0                                 # divergent
    new_lm[8] = pos[slots[8]] + np.array([299.0, 0.0, 0.0], np.float32)   # just inside
    slots[9] = 0
    fids[9] = fid[0]                                   # a real landmark of slot 0
    want = np.asarray(j_runner._scatter_kernel(
        jnp.asarray(pos), jnp.asarray(fid), jnp.asarray(slots), jnp.asarray(fids),
        jnp.asarray(new_lm), jnp.asarray(valid)))
    got = runner._scatter_kernel(_t(pos), _t(fid), _t(slots), _t(fids), _t(new_lm),
                                 _t(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    for k in (3, 5, 7):
        np.testing.assert_array_equal(got[slots[k]], pos[slots[k]])
    np.testing.assert_array_equal(got[slots[8]], new_lm[8])
    np.testing.assert_array_equal(got[slots[0]], new_lm[0])
    # slot 0: the padding rows after row 9 write its old value back, as on XLA's CPU
    np.testing.assert_array_equal(got[0], pos[0])


def test_apply_graph_correction_equals_jax():
    rng = np.random.default_rng(9)

    def trajectory(cls):
        traj = cls()
        r = np.random.default_rng(10)
        for i in range(30):
            q = r.normal(0, 1, 4)
            traj.append(float(i), r.normal(0, 100, 3), q / np.linalg.norm(q))
        return traj

    node_fids = [12, 3, 20, 40, 8]                     # unordered, one past the end
    quats = rng.normal(0, 1, (5, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    positions = rng.normal(0, 100, (5, 3))
    j_traj, t_traj = trajectory(JTrajectory), trajectory(Trajectory)
    before = np.array(t_traj.positions)
    j_runner._apply_graph_correction(j_traj, node_fids, quats, positions)
    runner._apply_graph_correction(t_traj, node_fids, quats, positions)
    np.testing.assert_array_equal(np.array(t_traj.positions), np.array(j_traj.positions))
    np.testing.assert_array_equal(np.array(t_traj.quaternions), np.array(j_traj.quaternions))
    np.testing.assert_array_equal(np.array(t_traj.positions)[:3], before[:3])
    assert not np.array_equal(np.array(t_traj.positions)[3:], before[3:])


def test_summary_and_keyframe_packs_have_the_jax_layout():
    cfg = SMALL_CFG
    state = engine.init_state(SMALL_CAM, cfg, device="cpu")
    gray = torch.full((SMALL_CAM.height, SMALL_CAM.width), 128.0)
    state, out = engine.step(state, gray, torch.zeros_like(gray), SMALL_CAM, cfg,
                             with_planes=False)
    summary = runner._pack_summary(out).numpy()
    assert summary.shape == (12,) and summary.dtype == np.float32
    np.testing.assert_array_equal(summary[:3], out.position.numpy())
    np.testing.assert_array_equal(summary[3:7], out.quat.numpy())
    assert list(summary[7:]) == [float(out.success), float(out.is_lost),
                                 float(out.n_evicted), float(out.n_plane_merge_dropped),
                                 float(out.n_point_inliers)]
    fobs, fids = runner._pack_keyframe_obs(out, state.points.pos)
    assert fobs.shape == (cfg.mapping.max_points_3d, 7) and fobs.dtype == torch.float32
    assert fids.dtype == torch.int32
    np.testing.assert_array_equal(fobs[:, 4:].numpy(), state.points.pos.numpy())


@pytest.fixture(scope="module")
def orbit():
    scene = RoomScene(SMALL_CAM, depth_noise=tcfg.DepthNoiseModel())
    poses = orbit_trajectory(24, speed_mm=8.0)
    return ([scene.render(q, p) for q, p in poses],
            np.stack([p for _, p in poses]).astype(np.float64))


def _run(orbit, **kw):
    frames, gt = orbit
    state, traj, stats = runner.run_frames(frames, SMALL_CAM, SMALL_CFG, with_planes=False,
                                           device="cpu", **kw)
    return state, traj, stats, runner.evaluate_against_ground_truth(traj, gt)["ate_rmse_mm"]


def test_run_frames_with_the_backend(orbit, monkeypatch):
    """The slice as a whole at a small size: keyframes are selected by the
    gate, BA runs and is accepted, the graph is solved, every pose is finite,
    BA-on ATE is no worse than BA-off by the margin of tests/test_ba.py:262,
    and the events keep the JAX runner's order: summaries are read in batches of
    8 after frame 0, so the refine of frame 7 scatters into the state past
    frame 8, that of frame 15 past frame 16, and the last batch into the final
    state."""
    scattered_into = []
    order = []
    real = runner._scatter_ba_landmarks

    def spy(state, device_lm):
        scattered_into.append(int(state.frame_idx))
        return real(state, device_lm)

    monkeypatch.setattr(runner, "_scatter_ba_landmarks", spy)
    _, _, _, ate_off = _run(orbit)
    assert not scattered_into
    state, traj, stats, ate_on = _run(orbit, ba_every=8,
                                      on_frame=lambda i, s, o, dt: order.append(i))
    assert order == list(range(24))
    assert stats.frame_count == 24 and stats.success_count == 24
    assert 3 <= stats.keyframe_count <= 16
    assert stats.ba_runs >= 2 and stats.ba_accepted >= 1
    assert stats.ba_total_iters == 8 * stats.ba_runs and stats.ba_iters_per_s > 0
    assert stats.graph_solves == stats.ba_accepted
    assert stats.backend_uploads == stats.backend_readbacks \
        == stats.ba_runs + stats.graph_solves
    assert scattered_into == [9, 17, 24][-stats.ba_accepted:]
    assert np.isfinite(traj.positions_array()).all()
    assert np.isfinite(np.array(traj.quaternions)).all()
    assert np.isfinite(state.points.pos.numpy()).all()
    assert ate_on <= ate_off * 1.08, (ate_on, ate_off)


def test_backend_options(orbit):
    """Without the graph the refined keyframe poses are written into the
    trajectory directly; without map feedback the live map is left alone."""
    frames, gt = orbit
    short = (frames[:16], gt[:16])
    _, traj, stats, ate = _run(short, ba_every=8, with_pose_graph=False,
                               ba_update_map=False, ba_iterations=4, ba_window=4)
    assert stats.ba_runs >= 1 and stats.graph_solves == 0 and np.isfinite(ate)
    assert stats.ba_total_iters == 4 * stats.ba_runs


@pytest.mark.parametrize("kw, names", [
    ("ba_mesh", "a process group of one rank"),
    ("camera_setup", "a rig at the identity"),
    ("export_map", "map.obj"),
])
def test_unported_runner_arguments_raise(kw, names, tmp_path):
    """The three runner arguments that raised ``NotImplementedError`` until the
    map writer, the rectification and the sharded solve were ported: each is
    taken now, here over an empty sequence."""
    import torch.distributed as dist

    value = {"camera_setup": tcfg.CameraSetup(rgb=SMALL_CAM, depth=SMALL_CAM),
             "export_map": str(tmp_path / names)}.get(kw)
    if kw == "ba_mesh":
        dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                                world_size=1, rank=0)
        value = dist.group.WORLD
    try:
        state, traj, stats = runner.run_frames([], SMALL_CAM, SMALL_CFG, device="cpu",
                                               ba_every=8, **{kw: value})
    finally:
        if kw == "ba_mesh":
            dist.destroy_process_group()
    assert stats.frame_count == 0 and len(traj.positions) == 0 and state is not None
    if kw == "export_map":
        assert (tmp_path / names).read_text() == ""
