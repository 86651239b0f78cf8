"""Pose-graph layer stitching consecutive BA windows into one trajectory (port of
``rgbd_slam_tpu/parallel/pose_graph.py``).

Windowed BA refines keyframe poses inside a sliding window, but frames chained
after an earlier window keep the absolute error they inherited at chaining
time.  The graph keeps every keyframe as a node, odometry and BA-refined
relative poses as edges, and re-solves the whole chain, so that later, better
relative estimates reach the absolute poses.

The graph is packed into static ``(max_nodes, max_edges)`` arrays with validity
weights; the Gauss-Newton solve is dense ([6N, 6N] Cholesky).  It is a bounded
sliding-window graph, not a global one: overflow drops the oldest node and is
counted in ``dropped_nodes``.  Nodes use the 6-coefficient pose
parameterization (position + stereographic quaternion) of the pose optimizer
and the BA.

The bookkeeping (node list, edge dict, relative-pose measurements) is
per-keyframe quaternion algebra in numpy on the host; only the packed solve runs
on the device: one copy there (one float32 buffer; the edge indices travel as
their bit patterns), one read back.  ``PoseGraph.transfers`` counts both.  On a
card the packed solve runs as a CUDA graph (``solve_graph.SolveGraph``), one
per (max_nodes, max_edges, iterations), recorded at the first solve and
replayed at every later one, as the JAX package compiles ``_solve_packed`` once
per static key; on the CPU it runs eagerly.  :meth:`PoseGraph.close` frees the
graphs.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import jvp, vmap

from .. import profiling, solve_graph
from ..device import resolve_device
from ..geometry import se3

DAMPING = 1e-5
#: scale of the stereographic-coefficient rows of an edge residual against its
#: position rows (mm): 1 coefficient unit ~ 2 rad ~ O(1000) mm at scene scale
ROTATION_SCALE = 500.0


# ---------------------------------------------------------------------------
# host-side (numpy) quaternion algebra for the bookkeeping
# ---------------------------------------------------------------------------

def _np_quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _np_quat_conj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def _np_quat_rotate(q, v):
    w, x, y, z = q
    r = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    return r @ np.asarray(v)


def np_relative(quat_i, pos_i, quat_j, pos_j):
    """(q_rel, p_rel): pose of j expressed in i's frame."""
    qc = _np_quat_conj(quat_i)
    q_rel = _np_quat_mul(qc, quat_j)
    p_rel = _np_quat_rotate(qc, np.asarray(pos_j) - np.asarray(pos_i))
    return q_rel, p_rel


def np_compose(quat_i, pos_i, q_rel, p_rel):
    """World pose of j given i's world pose and j's pose in i's frame."""
    return (_np_quat_mul(quat_i, q_rel),
            np.asarray(pos_i) + _np_quat_rotate(quat_i, p_rel))


def _np_stereographic(q):
    """Numpy mirror of se3.quat_to_stereographic."""
    return np.asarray(q[:3]) / max(1.0 + float(q[3]), 1e-3)


def _np_rel_coeffs(q_rel, p_rel):
    return np.concatenate([np.asarray(p_rel, np.float32),
                           _np_stereographic(q_rel).astype(np.float32)])


# ---------------------------------------------------------------------------
# device solve
# ---------------------------------------------------------------------------

def _relative_coeffs(coeffs_i, coeffs_j):
    """6-coefficient relative pose of node j in node i's frame (batched)."""
    qi, pi = se3.coefficients_to_pose(coeffs_i)
    qj, pj = se3.coefficients_to_pose(coeffs_j)
    qi_inv = se3.quat_conjugate(qi)
    q_rel = se3.quat_multiply(qi_inv, qj)
    p_rel = se3.quat_rotate(qi_inv, pj - pi)
    return se3.pose_to_coefficients(q_rel, p_rel)


def _edge_residual(coeffs_i, coeffs_j, meas, weight):
    """Weighted 6-residual [..., 6] of edges: the current relative pose against
    the measured one, rotation rows scaled by ROTATION_SCALE.  ``weight`` is
    [...] (0 = padding)."""
    r = _relative_coeffs(coeffs_i, coeffs_j) - meas
    scale = torch.cat([torch.ones(3, dtype=r.dtype, device=r.device),
                       torch.full((3,), ROTATION_SCALE, dtype=r.dtype, device=r.device)])
    return r * weight[..., None] * scale


def solve_pose_graph(poses, edge_i, edge_j, edge_meas, edge_w, iterations: int = 10):
    """Dense Gauss-Newton over the pose graph.

    poses [N, 6] node coefficients (node 0 gauge-fixed), edge_i / edge_j [E]
    int, edge_meas [E, 6] measured relative coefficients, edge_w [E] weights (0
    = padding).  Returns (refined poses [N, 6], costs [iterations]: the cost
    before each step).  A normal matrix that is not positive definite gives NaN
    poses and costs instead of an error."""
    n = poses.shape[0]
    e = edge_i.shape[0]
    dt = poses.dtype
    dev = poses.device
    edge_i = edge_i.to(torch.int64)
    edge_j = edge_j.to(torch.int64)
    # node assignment one-hots: the dense Jacobian is assembled by contractions
    # whose order is fixed
    onei = F.one_hot(edge_i, n).to(dt)                   # [E, N]
    onej = F.one_hot(edge_j, n).to(dt)
    eye12 = torch.eye(12, dtype=dt, device=dev)
    tan_i = eye12[:, None, :6].expand(12, e, 6)
    tan_j = eye12[:, None, 6:].expand(12, e, 6)
    eye_n = torch.eye(n * 6, dtype=dt, device=dev)
    fix = torch.arange(n * 6, device=dev) < 6            # gauge: freeze node 0

    p = poses
    costs = []
    for _ in range(iterations):
        ci, cj = p[edge_i], p[edge_j]

        def edge_r(a, b):
            return _edge_residual(a, b, edge_meas, edge_w)

        # edge-local Jacobians over the two incident poses (12 tangents)
        r, jac = vmap(lambda ta, tb: jvp(edge_r, (ci, cj), (ta, tb)),
                      out_dims=(0, -1))(tan_i, tan_j)
        r = r[0]                                         # [E, 6]
        bigj = (torch.einsum("en,erc->ernc", onei, jac[..., :6])
                + torch.einsum("en,erc->ernc", onej, jac[..., 6:])).reshape(e * 6, n * 6)
        h = bigj.T @ bigj
        g = bigj.T @ r.reshape(-1)
        h = torch.where(fix[:, None] | fix[None, :], eye_n, h) + DAMPING * eye_n
        g = torch.where(fix, torch.zeros((), dtype=dt, device=dev), g)
        chol, info = torch.linalg.cholesky_ex(h)
        chol = torch.where(info == 0, chol, torch.full_like(chol, float("nan")))
        delta = torch.cholesky_solve(-g[:, None], chol)[:, 0]
        costs.append(torch.sum(r * r))
        p = p + delta.reshape(n, 6)
    return p, torch.stack(costs)


def _solve_packed(fbuf, max_nodes: int, max_edges: int, iterations: int = 10):
    """:func:`solve_pose_graph` on one packed float32 buffer (quaternions,
    positions, measurements, weights, then the two edge index arrays as int32
    bit patterns), with the quaternion <-> coefficient conversions on the
    device.  Returns one float32 buffer: quaternions, positions, costs."""
    n, e = max_nodes, max_edges
    quats = fbuf[: n * 4].reshape(n, 4)
    positions = fbuf[n * 4: n * 7].reshape(n, 3)
    meas = fbuf[n * 7: n * 7 + e * 6].reshape(e, 6)
    w = fbuf[n * 7 + e * 6: n * 7 + e * 7]
    ibuf = fbuf[n * 7 + e * 7:].view(torch.int32)
    refined, costs = solve_pose_graph(se3.pose_to_coefficients(quats, positions),
                                      ibuf[:e], ibuf[e:], meas, w, iterations=iterations)
    rq, rp = se3.coefficients_to_pose(refined)
    return torch.cat([rq.reshape(-1), rp.reshape(-1), costs])


# ---------------------------------------------------------------------------
# host orchestration
# ---------------------------------------------------------------------------

@dataclass
class PoseGraph:
    """Keyframe pose graph with odometry and BA-window edges.

    Edge measurements are relative poses, which do not depend on the global
    frame the estimates live in: odometry edges are measured between
    consecutive raw engine poses, BA edges between refined window poses.  Node
    estimates chain through the graph's own (solved) frame.

    The packed problem is always (max_nodes, max_edges); overflow drops the
    oldest nodes and is counted.  ``device=None`` is the card."""

    max_nodes: int = 64
    max_edges: int = 256
    odometry_weight: float = 1.0
    ba_weight: float = 4.0
    device: object = None

    frame_ids: list = field(default_factory=list)    # node -> source frame id
    quats: list = field(default_factory=list)        # node -> est quat (np [4])
    positions: list = field(default_factory=list)    # node -> est pos (np [3])
    # (fid_i, fid_j, kind) -> (meas6, w): odometry and BA measurements of the
    # same pair coexist as independent constraints with their own weights
    edges: dict = field(default_factory=dict)
    dropped_nodes: int = 0
    dropped_edges: int = 0
    #: host-to-device copies and device-to-host reads made by solve()
    transfers: dict = field(default_factory=lambda: {"uploads": 0, "readbacks": 0})

    def __post_init__(self):
        self._last_raw = None  # (quat, pos) of the last keyframe in the engine frame
        # the packed solvers by static key (see _get_solver)
        self._solvers = {}

    def add_keyframe(self, frame_id: int, quat, position):
        """Add a keyframe node from the engine's raw pose estimate; chains an
        odometry edge (measured in the engine frame) from the previous node."""
        quat = np.asarray(quat, np.float64)
        position = np.asarray(position, np.float64)
        if self.frame_ids:
            q_rel, p_rel = np_relative(self._last_raw[0], self._last_raw[1], quat, position)
            self.edges[(self.frame_ids[-1], int(frame_id), "odom")] = \
                (_np_rel_coeffs(q_rel, p_rel), self.odometry_weight)
            # the node estimate chains from the previous node's (solved) estimate
            q_est, p_est = np_compose(self.quats[-1], self.positions[-1], q_rel, p_rel)
        else:
            q_est, p_est = quat, position
        self._last_raw = (quat, position)
        self.frame_ids.append(int(frame_id))
        self.quats.append(q_est)
        self.positions.append(p_est)
        if len(self.frame_ids) > self.max_nodes:
            dropped_fid = self.frame_ids.pop(0)
            self.quats.pop(0)
            self.positions.pop(0)
            self.edges = {k: v for k, v in self.edges.items() if dropped_fid not in k[:2]}
            self.dropped_nodes += 1

    def add_ba_window(self, frame_ids, refined):
        """Record BA-refined relative poses between consecutive window keyframes
        as high-weight edges.  ``refined``: list of (quat, position) host arrays."""
        known = set(self.frame_ids)
        for a in range(len(frame_ids) - 1):
            fa, fb = int(frame_ids[a]), int(frame_ids[a + 1])
            if fa not in known or fb not in known:
                continue
            qa, pa = refined[a]
            qb, pb = refined[a + 1]
            q_rel, p_rel = np_relative(np.asarray(qa, np.float64), np.asarray(pa, np.float64),
                                       np.asarray(qb, np.float64), np.asarray(pb, np.float64))
            self.edges[(fa, fb, "ba")] = (_np_rel_coeffs(q_rel, p_rel), self.ba_weight)

    def _get_solver(self, iterations: int):
        """:func:`_solve_packed` as ``solve_graph.solver`` gives it, one per
        static key (max_nodes, max_edges, iterations), kept for the graph's
        life: on a card a ``SolveGraph`` recorded at its first call, on the CPU
        the eager solve."""
        key = (self.max_nodes, self.max_edges, iterations)
        if key not in self._solvers:
            self._solvers[key] = solve_graph.solver(
                functools.partial(_solve_packed, max_nodes=self.max_nodes,
                                  max_edges=self.max_edges, iterations=iterations),
                resolve_device(self.device))
        return self._solvers[key]

    def close(self):
        """Free the solvers' CUDA graphs and their memory; a later solve
        records anew."""
        for solve in self._solvers.values():
            solve.close()
        self._solvers.clear()

    def _pack(self):
        """The one float32 buffer that :meth:`solve` moves to the device
        (quaternions, positions, measurements, weights, then the two edge
        index arrays as int32 bit patterns; :func:`_solve_packed` takes it
        apart), or None when the graph is under-constrained.  The newest
        ``max_edges`` edges are kept and the rest counted."""
        n = len(self.frame_ids)
        if n < 3 or not self.edges:
            return None
        fid_to_node = {f: i for i, f in enumerate(self.frame_ids)}
        packed = [(fid_to_node[a], fid_to_node[b], m, w)
                  for (a, b, _), (m, w) in self.edges.items()
                  if a in fid_to_node and b in fid_to_node]
        if len(packed) > self.max_edges:
            self.dropped_edges += len(packed) - self.max_edges
            packed = packed[-self.max_edges:]

        quats = np.zeros((self.max_nodes, 4), np.float32)
        quats[:, 0] = 1.0
        quats[:n] = np.stack(self.quats).astype(np.float32)
        positions = np.zeros((self.max_nodes, 3), np.float32)
        positions[:n] = np.stack(self.positions).astype(np.float32)

        ei = np.zeros((self.max_edges,), np.int32)
        ej = np.zeros((self.max_edges,), np.int32)
        meas = np.zeros((self.max_edges, 6), np.float32)
        w = np.zeros((self.max_edges,), np.float32)
        for k, (a, b, m, ww) in enumerate(packed):
            ei[k], ej[k], meas[k], w[k] = a, b, m, ww
        return np.concatenate([quats.reshape(-1), positions.reshape(-1), meas.reshape(-1),
                               w, ei.view(np.float32), ej.view(np.float32)])

    def solve(self, iterations: int = 10):
        """Solve the graph on the device; returns (frame_ids list, quats [n, 4],
        positions [n, 3]) numpy, or None if the graph is under-constrained or
        the solve is not finite.  Refined poses are written back into the node
        state, so that later odometry chains from them."""
        fbuf = self._pack()
        if fbuf is None:
            return None
        n = len(self.frame_ids)
        # the solver moves the host buffer to its device in the one copy
        out = self._get_solver(iterations)(torch.from_numpy(fbuf))
        self.transfers["uploads"] += 1
        with profiling.span("solve.read"):
            out = out.cpu().numpy()
        self.transfers["readbacks"] += 1
        nn = self.max_nodes
        rq = out[: nn * 4].reshape(nn, 4)
        rp = out[nn * 4: nn * 7].reshape(nn, 3)
        costs = out[nn * 7:]
        if not (np.isfinite(costs).all() and np.isfinite(rq[:n]).all()
                and np.isfinite(rp[:n]).all()):
            return None
        for i in range(n):
            self.quats[i] = rq[i].astype(np.float64)
            self.positions[i] = rp[i].astype(np.float64)
        return list(self.frame_ids), rq[:n], rp[:n]
