"""The backend's packed solves read the host nowhere, so that a CUDA graph can
record them, and what runs them as graphs (``rgbd_slam_tpu_torch.solve_graph``)
keeps the runner's results.

On the CPU:

* the windowed BA's packed solve (``KeyframeWindow._get_solver``, the local
  branch of ``_solve``) and the pose graph's (``pose_graph._solve_packed``
  through ``PoseGraph._get_solver``) run while ``Tensor.item``, ``__bool__``,
  ``__int__``, ``__float__``, ``tolist``, ``cpu`` and ``numpy`` raise, and
  equal the JAX package's jitted packed solvers on the same seeded buffers,
  within the tolerances of ``test_refine_matches_jax`` and
  ``test_solve_pose_graph_matches_jax``;
* ``SolveGraph`` raises without a card, and the CPU's solver is the eager one;
* the runner over solvers that, like the graphs, overwrite their outputs in
  place at every call gives the eager runner's keyframes, refines, trajectory
  and map, and a refine's device block outlives the next refine;
* a singular window still gives non-finite costs through the solver, and the
  runner refuses it.

The card's side (replays against the eager solves to the bit at full width,
one graph a key, no eager solve on the card) is in ``test_torch_cuda.py``.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_slam_tpu.parallel import pose_graph as j_pg
from rgbd_slam_tpu.parallel.keyframes import KeyframeWindow as JKeyframeWindow
from rgbd_slam_tpu_torch import runner, solve_graph, step_graph
from rgbd_slam_tpu_torch.geometry import se3
from rgbd_slam_tpu_torch.parallel import keyframes
from rgbd_slam_tpu_torch.parallel import pose_graph as pg
from rgbd_slam_tpu_torch.parallel.keyframes import KeyframeWindow
from test_torch_ba import CAM, T_CAM, _fill, _keyframe_records
from test_torch_pose_graph import _chain_problem
from test_torch_step_graph import _HOST_READS, _orbit_frames
from test_torch_engine import T_CAM as SMALL_CAM
from test_torch_engine import T_CFG as SMALL_CFG

torch.set_num_threads(2)

#: a negative position anchor makes the reduced system indefinite
#: (``test_singular_window_gives_nonfinite_costs_and_does_not_raise``)
SINGULAR_ANCHORS = (1e-3, -1e6, 1e-3)
#: every orbit frame (6 mm apart) a keyframe and a refine every 4 frames (at
#: frames 3, 7, ...)
BACKEND_EVERY_FRAME = dict(ba_every=4, kf_min_trans_mm=5.0)


@contextlib.contextmanager
def no_host_reads():
    """``Tensor.item``, ``__bool__`` and the other host reads raise inside."""
    def guard(name):
        def read(self, *args, **kw):
            raise RuntimeError(f"the solve read the host: Tensor.{name}")
        return read

    with pytest.MonkeyPatch.context() as mp:
        for name in _HOST_READS:
            mp.setattr(torch.Tensor, name, guard(name))
        yield


def _windows(k, l, c, **kw):
    records = _keyframe_records()
    return (_fill(JKeyframeWindow(max_keyframes=k, max_landmarks=l, max_obs_per_landmark=c,
                                  **kw), records, True),
            _fill(KeyframeWindow(max_keyframes=k, max_landmarks=l, max_obs_per_landmark=c,
                                 device="cpu", **kw), records, True))


def _jax_packed(problem):
    """The JAX window's two buffers of ``problem`` (``KeyframeWindow.refine``)."""
    poses, landmarks, obs_kf, obs_uv, obs_z, obs_mask, fids, slots, lm_valid = problem
    fbuf = np.concatenate([poses.reshape(-1), landmarks.reshape(-1), obs_uv.reshape(-1),
                           obs_z.reshape(-1), obs_mask.astype(np.float32).reshape(-1),
                           lm_valid.astype(np.float32)])
    ibuf = np.concatenate([obs_kf.reshape(-1), slots, fids.astype(np.int32)])
    return jnp.asarray(fbuf), jnp.asarray(ibuf)


@pytest.mark.parametrize("k, l", [(4, 32), (6, 64)], ids=["4x32x4", "6x64x4"])
def test_packed_ba_solve_reads_no_host_and_matches_jax(k, l):
    """The packed refine's solve at K x L x 4, 6 iterations, under the guard:
    costs to 1e-3 relative, quaternions to 1e-6, positions to 5e-3 mm, valid
    landmarks to 5e-2 mm; slots, validity and feature ids equal."""
    iterations = 6
    j, t = _windows(k, l, 4)
    problem = t.build_problem()
    j_out, j_lm, j_slots, j_valid, j_fids = [
        np.asarray(x) for x in j._get_solver(CAM, iterations, None)(
            *_jax_packed(j.build_problem()))]
    buf = torch.from_numpy(keyframes._pack_problem(problem))
    solve = t._get_solver(T_CAM, iterations, None)
    assert isinstance(solve, solve_graph.EagerSolve)
    with no_host_reads():
        out, new_lm, slots, lm_valid, fids = solve(buf)
    out = out.numpy()
    costs, j_costs = (o[k * 7: k * 7 + iterations] for o in (out, j_out))
    np.testing.assert_allclose(costs, j_costs, rtol=1e-3)
    assert costs[-1] < costs[0]
    np.testing.assert_allclose(out[: k * 4], j_out[: k * 4], atol=1e-6)
    np.testing.assert_allclose(out[k * 4: k * 7], j_out[k * 4: k * 7], atol=5e-3)
    lm_out = out[k * 7 + iterations:].reshape(l, 3)
    np.testing.assert_array_equal(lm_out, new_lm.numpy())
    valid = problem[8]
    np.testing.assert_allclose(lm_out[valid], j_lm[valid], atol=5e-2)
    np.testing.assert_array_equal(slots.numpy(), j_slots)
    np.testing.assert_array_equal(lm_valid.numpy(), j_valid)
    np.testing.assert_array_equal(fids.numpy(), j_fids)


@pytest.mark.parametrize("n, cap_nodes, cap_edges", [(8, 8, 16), (12, 16, 32)],
                         ids=["8x16", "16x32"])
def test_packed_pose_graph_solve_reads_no_host_and_matches_jax(n, cap_nodes, cap_edges):
    """The packed graph solve, 10 iterations, under the guard: costs to 1e-3
    relative plus 1e-9 of the first, positions to 1e-2 mm, quaternions to
    1e-5."""
    iterations = 10
    poses, ei, ej, meas, w, _ = _chain_problem(n, cap_nodes, cap_edges, 30.0)
    quats, positions = (x.numpy() for x in se3.coefficients_to_pose(torch.from_numpy(poses)))
    floats = [quats.reshape(-1), positions.reshape(-1), meas.reshape(-1), w]
    j_out = np.asarray(j_pg._solve_packed(jnp.asarray(np.concatenate(floats)),
                                          jnp.asarray(np.concatenate([ei, ej])),
                                          cap_nodes, cap_edges, iterations=iterations))
    graph = pg.PoseGraph(max_nodes=cap_nodes, max_edges=cap_edges, device="cpu")
    fbuf = torch.from_numpy(np.concatenate(floats + [ei.view(np.float32),
                                                     ej.view(np.float32)]))
    with no_host_reads():
        out = graph._get_solver(iterations)(fbuf)
    out = out.numpy()
    costs, j_costs = out[cap_nodes * 7:], j_out[cap_nodes * 7:]
    assert costs.shape == (iterations,)
    np.testing.assert_allclose(costs, j_costs, rtol=1e-3, atol=1e-9 * j_costs[0] + 1e-9)
    assert costs[-1] < 1e-3 * costs[0]
    np.testing.assert_allclose(out[: cap_nodes * 4], j_out[: cap_nodes * 4], atol=1e-5)
    np.testing.assert_allclose(out[cap_nodes * 4: cap_nodes * 7],
                               j_out[cap_nodes * 4: cap_nodes * 7], atol=1e-2)


def test_solve_graph_raises_on_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        solve_graph.SolveGraph(lambda x: x, "cpu")


def test_the_cpu_solvers_are_the_eager_solves():
    """On the CPU ``solver`` is the function as it is, and the window and the
    graph keep one solver a static key, as ``jax.jit`` keeps one program."""
    solve = solve_graph.solver(torch.neg, "cpu")
    assert isinstance(solve, solve_graph.EagerSolve) and not solve.reuses_outputs
    assert torch.equal(solve(torch.ones(3)), -torch.ones(3))
    _, window = _windows(4, 32, 4)
    first = window._get_solver(T_CAM, 6, None)
    assert window._get_solver(T_CAM, 6, None) is first
    assert window._get_solver(T_CAM, 4, None) is not first and len(window._solvers) == 2
    graph = pg.PoseGraph(device="cpu")
    assert graph._get_solver(10) is graph._get_solver(10)
    window.close()
    graph.close()
    assert not window._solvers and not graph._solvers


class InPlaceSolve:
    """The eager solve behind a graph's contract: one set of outputs,
    overwritten in place at every call."""

    reuses_outputs = True

    def __init__(self, fn, device):
        self._fn = fn
        self._out = None

    def __call__(self, *inputs):
        out = self._fn(*(x.clone() for x in inputs))
        if self._out is None:
            self._out = step_graph.clone_tree(out)
        for s, n in zip(step_graph.tensor_leaves(self._out), step_graph.tensor_leaves(out)):
            s.copy_(n)
        return self._out

    def close(self):
        pass


def test_runner_over_reused_solver_outputs_keeps_its_results(monkeypatch, tmp_path):
    """The runner over solvers that overwrite their outputs at every call
    gives the eager runner's trajectory, counts, final map and streamed map to
    the bit, with the backend (refines, pose graph, landmark write-back) on;
    the device block a refine returns still holds that refine's values after
    the next one."""
    frames = _orbit_frames(8)
    kept = []
    real_refine = KeyframeWindow.refine

    def keeping(self, *args, **kw):
        res = real_refine(self, *args, **kw)
        if res is not None:
            kept.append((res[1][1:], step_graph.clone_tree(res[1][1:])))
        return res

    monkeypatch.setattr(KeyframeWindow, "refine", keeping)

    def run(tag):
        path = str(tmp_path / f"{tag}.obj")
        state, traj, stats = runner.run_frames(frames, SMALL_CAM, SMALL_CFG,
                                               with_planes=False, export_map=path,
                                               device="cpu", **BACKEND_EVERY_FRAME)
        with open(path) as f:
            return state, traj, stats, f.read()

    eager = run("eager")
    kept.clear()
    monkeypatch.setattr(solve_graph, "solver", InPlaceSolve)
    reused = run("reused")
    assert eager[2].ba_accepted >= 1 and eager[2].graph_solves >= 1 and len(kept) >= 2
    for key in ("keyframe_count", "ba_runs", "ba_accepted", "graph_solves", "map_streamed",
                "map_alive_at_end", "success_count", "backend_uploads", "backend_readbacks"):
        assert getattr(eager[2], key) == getattr(reused[2], key), key
    np.testing.assert_array_equal(eager[1].positions_array(), reused[1].positions_array())
    np.testing.assert_array_equal(np.array(eager[1].quaternions),
                                  np.array(reused[1].quaternions))
    assert eager[3] == reused[3]
    for a, b in zip(step_graph.tensor_leaves(eager[0]), step_graph.tensor_leaves(reused[0]),
                    strict=True):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    for returned, at_return in kept:
        for a, b in zip(returned, at_return):
            assert torch.equal(a, b)


def test_singular_window_is_refused_through_the_solver():
    """A window whose reduced system is indefinite: the packed solve gives a
    finite first cost and NaN after it, the window's refine returns them, and
    the runner, with the same anchors, runs refines and accepts none."""
    _, window = _windows(6, 64, 4, anchor_weights=SINGULAR_ANCHORS)
    _, _, costs = window.refine(T_CAM, iterations=3)
    assert np.isfinite(costs[0]) and np.isnan(costs[1:]).all()
    _, traj, stats = runner.run_frames(_orbit_frames(4), SMALL_CAM, SMALL_CFG,
                                       with_planes=False, ba_anchor_weights=SINGULAR_ANCHORS,
                                       device="cpu", **BACKEND_EVERY_FRAME)
    assert stats.ba_runs >= 1 and stats.ba_accepted == 0 and stats.graph_solves == 0
    assert np.isfinite(traj.positions_array()).all()
