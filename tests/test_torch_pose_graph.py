"""Parity of the port's pose graph with the JAX package, on the cases of
tests/test_pose_graph.py (``TestSolver``, ``TestPoseGraphLayer``).

The host bookkeeping (relative poses, composition, node and edge lists) is the
same numpy in both packages and must be equal.  The dense Gauss-Newton solve
runs in float32 in both with different Cholesky routines: refined positions
agree to 1e-2 mm, stereographic coefficients and quaternions to 1e-5, and the
costs to 1e-3 relative plus 1e-9 of the first cost, under which a converged cost
is rounding (measured on the 12-node chain: 3e-5 mm, 1e-7, and costs of 1e-8
against a first cost of 7.6e4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_slam_tpu.parallel import pose_graph as j_pg
from rgbd_slam_tpu_torch.parallel import pose_graph as pg
from test_pose_graph import _coeffs, _gt_chain

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _chain_problem(n, cap_nodes, cap_edges, noise_mm, seed=3):
    """Exact relative measurements between consecutive nodes of a ground-truth
    chain, drifted node estimates, zero-weight padding edges and padding nodes."""
    quats, positions = _gt_chain(n)
    rng = np.random.default_rng(seed)
    poses = np.zeros((cap_nodes, 6), np.float32)
    poses[0] = _coeffs(quats[0], positions[0])
    for i in range(1, n):
        poses[i] = _coeffs(quats[i], positions[i] + rng.standard_normal(3) * noise_mm)
    ei = np.zeros((cap_edges,), np.int32)
    ej = np.zeros((cap_edges,), np.int32)
    meas = np.zeros((cap_edges, 6), np.float32)
    w = np.zeros((cap_edges,), np.float32)
    for i in range(n - 1):
        q_rel, p_rel = j_pg.np_relative(quats[i], positions[i], quats[i + 1], positions[i + 1])
        ei[i], ej[i] = i, i + 1
        meas[i] = j_pg._np_rel_coeffs(q_rel, p_rel)
        w[i] = 1.0
    return poses, ei, ej, meas, w, np.stack(positions)


@pytest.mark.parametrize("n, cap_nodes, cap_edges, noise_mm, iterations", [
    (12, 12, 22, 30.0, 10),     # TestSolver.test_exact_edges_recover_drifted_nodes
    (5, 8, 8, 0.0, 5),          # TestSolver.test_padding_nodes_untouched
])
def test_solve_pose_graph_matches_jax(n, cap_nodes, cap_edges, noise_mm, iterations):
    poses, ei, ej, meas, w, gt = _chain_problem(n, cap_nodes, cap_edges, noise_mm)
    j_ref, j_costs = j_pg.solve_pose_graph(jnp.asarray(poses), jnp.asarray(ei),
                                           jnp.asarray(ej), jnp.asarray(meas),
                                           jnp.asarray(w), iterations=iterations)
    t_ref, t_costs = pg.solve_pose_graph(_t(poses), _t(ei), _t(ej), _t(meas), _t(w),
                                         iterations=iterations)
    j_ref, j_costs = np.asarray(j_ref), np.asarray(j_costs)
    t_ref, t_costs = t_ref.numpy(), t_costs.numpy()
    assert t_costs.shape == (iterations,)
    np.testing.assert_allclose(t_costs, j_costs, rtol=1e-3, atol=1e-9 * j_costs[0] + 1e-9)
    np.testing.assert_allclose(t_ref[:, :3], j_ref[:, :3], atol=1e-2)
    np.testing.assert_allclose(t_ref[:, 3:], j_ref[:, 3:], atol=1e-5)
    # the gauge node and the padding nodes stay where they were
    np.testing.assert_allclose(t_ref[0], poses[0], atol=1e-5)
    np.testing.assert_allclose(t_ref[n:], poses[n:], atol=1e-5)
    if noise_mm:
        err = np.linalg.norm(t_ref[:n, :3] - gt, axis=1)
        assert t_costs[-1] < 1e-3 * t_costs[0] and err.max() < 1.0


def test_host_quaternion_algebra_equals_jax():
    rng = np.random.default_rng(4)
    q = rng.normal(0, 1, (2, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    p = rng.normal(0, 100, (2, 3))
    for name in ("np_relative", "np_compose"):
        got = getattr(pg, name)(q[0], p[0], q[1], p[1])
        want = getattr(j_pg, name)(q[0], p[0], q[1], p[1])
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pg._np_rel_coeffs(q[0], p[0]), j_pg._np_rel_coeffs(q[0], p[0]))


def _drifting_graph(module, **kw):
    """TestPoseGraphLayer.test_ba_edges_beat_odometry_chain: 60 keyframes whose
    odometry drifts, and BA windows of 8 sliding by 4 with near-true relatives."""
    n = 60
    quats, positions = _gt_chain(n, seed=1)
    rng = np.random.default_rng(7)
    graph = module.PoseGraph(max_nodes=64, max_edges=256, **kw)
    odo_q, odo_p = [quats[0]], [positions[0]]
    for i in range(1, n):
        q_rel, p_rel = module.np_relative(quats[i - 1], positions[i - 1], quats[i],
                                          positions[i])
        q, p = module.np_compose(odo_q[-1], odo_p[-1], q_rel,
                                 p_rel + np.array([1.2, 0.8, 0.3])
                                 + rng.standard_normal(3) * 0.5)
        odo_q.append(q)
        odo_p.append(p)
    for i in range(n):
        graph.add_keyframe(i * 5, odo_q[i], odo_p[i])
    for start in range(0, n - 8, 4):
        fids = [(start + j) * 5 for j in range(8)]
        refined = [(quats[start + j], positions[start + j] + rng.standard_normal(3) * 0.2)
                   for j in range(8)]
        graph.add_ba_window(fids, refined)
    return graph, np.stack(odo_p), np.stack(positions)


def test_pose_graph_layer_matches_jax():
    j_graph, odo_p, gt = _drifting_graph(j_pg)
    t_graph, _, _ = _drifting_graph(pg, device="cpu")
    assert t_graph.frame_ids == j_graph.frame_ids
    assert list(t_graph.edges) == list(j_graph.edges)
    for key, (m, w) in j_graph.edges.items():
        np.testing.assert_array_equal(t_graph.edges[key][0], m)
        assert t_graph.edges[key][1] == w
    j_fids, j_q, j_p = j_graph.solve(iterations=10)
    t_fids, t_q, t_p = t_graph.solve(iterations=10)
    assert t_fids == j_fids
    np.testing.assert_allclose(t_q, j_q, atol=1e-5)
    np.testing.assert_allclose(t_p, j_p, atol=1e-2)
    # the refined poses are written back into the node state
    np.testing.assert_array_equal(np.stack(t_graph.positions), t_p.astype(np.float64))
    ate_odo = np.sqrt(np.mean(np.sum((odo_p - gt) ** 2, axis=1)))
    ate_graph = np.sqrt(np.mean(np.sum((t_p - gt) ** 2, axis=1)))
    assert ate_graph < 0.3 * ate_odo
    # one copy to the device and one read back a solve
    assert t_graph.transfers == {"uploads": 1, "readbacks": 1}


def test_node_overflow_and_coexisting_edges_equal_jax():
    q = np.array([1.0, 0, 0, 0])
    graphs = [m.PoseGraph(max_nodes=4, max_edges=16, **kw)
              for m, kw in ((j_pg, {}), (pg, {"device": "cpu"}))]
    for graph in graphs:
        for i in range(6):
            graph.add_keyframe(i, q, np.array([10.0 * i, 0, 0]))
        graph.add_ba_window([3, 4, 5], [(q, np.array([0.0, 0, 0])), (q, np.array([11.0, 0, 0])),
                                        (q, np.array([21.0, 0, 0]))])
    j_graph, t_graph = graphs
    assert t_graph.dropped_nodes == j_graph.dropped_nodes == 2
    assert t_graph.frame_ids == j_graph.frame_ids == [2, 3, 4, 5]
    assert list(t_graph.edges) == list(j_graph.edges)
    assert (3, 4, "odom") in t_graph.edges and (3, 4, "ba") in t_graph.edges
    j_solved, t_solved = j_graph.solve(), t_graph.solve()
    np.testing.assert_allclose(t_solved[2], j_solved[2], atol=1e-2)


def test_edge_overflow_keeps_the_newest_and_counts():
    """7 chained nodes with room for 4 edges: the 2 oldest edges go and are
    counted.  The nodes they held are then tied to nothing, the normal matrix
    is singular but for the damping, and both packages refuse the solve."""
    graphs = [m.PoseGraph(max_nodes=8, max_edges=4, **kw)
              for m, kw in ((j_pg, {}), (pg, {"device": "cpu"}))]
    q = np.array([1.0, 0, 0, 0])
    for graph in graphs:
        for i in range(7):
            graph.add_keyframe(i, q, np.array([10.0 * i, 1.0 * i * i, 0]))
    j_solved, t_solved = graphs[0].solve(), graphs[1].solve()
    assert graphs[1].dropped_edges == graphs[0].dropped_edges == 2
    assert t_solved is None and j_solved is None


def test_underconstrained_and_nonfinite_graphs_are_refused():
    """Fewer than 3 nodes: nothing to solve.  A measurement that is not finite
    makes the normal matrix fail its Cholesky: the solve gives NaN, the graph
    refuses it (None), keeps its node estimates, and nothing raises."""
    q = np.array([1.0, 0, 0, 0])
    graph = pg.PoseGraph(device="cpu")
    graph.add_keyframe(0, q, np.zeros(3))
    graph.add_keyframe(1, q, np.array([10.0, 0, 0]))
    assert graph.solve() is None and graph.transfers["uploads"] == 0
    graph.add_keyframe(2, q, np.array([20.0, 0, 0]))
    graph.add_ba_window([0, 1, 2], [(q, np.zeros(3)), (q, np.array([np.nan, 0, 0])),
                                    (q, np.array([20.0, 0, 0]))])
    before = [p.copy() for p in graph.positions]
    assert graph.solve() is None
    assert graph.transfers == {"uploads": 1, "readbacks": 1}
    for a, b in zip(graph.positions, before):
        np.testing.assert_array_equal(a, b)
    # the same through the solver: NaN poses and costs, no error
    poses, ei, ej, meas, w, _ = _chain_problem(5, 5, 4, 0.0)
    meas[2, 0] = np.inf
    refined, costs = pg.solve_pose_graph(_t(poses), _t(ei), _t(ej), _t(meas), _t(w),
                                         iterations=3)
    assert not np.isfinite(costs.numpy()).any() and not np.isfinite(refined.numpy()).all()
