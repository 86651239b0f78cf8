"""Keyframe window feeding the windowed bundle adjustment (port of
``rgbd_slam_tpu/parallel/keyframes.py``).

Keyframes are collected from the engine's per-frame observation record
(``StepOutput.point_*``), landmark observations are grouped by feature id across
the window, and the window is refined with :mod:`.ba`.  The bookkeeping (ring
buffers, ids) is host-side numpy; the solve runs on the device.

The packed problem always has the static shape ``(max_keyframes,
max_landmarks, max_obs_per_landmark)`` with validity masks.  A refine moves the
problem to the device in one copy (one int32 buffer; the float arrays travel as
their bit patterns) and reads the result back in one; the refined landmarks,
their slots, validity and feature ids stay on the device for the map scatter.
``transfers`` counts both.

On a card the packed solve runs as a CUDA graph (``solve_graph.SolveGraph``),
one per static key, recorded at the window's first refine with that key and
replayed at every later one, as the JAX package compiles one program per
window; on the CPU it runs eagerly.  :meth:`KeyframeWindow.close` frees the
graphs.

With a process group (``refine(mesh=group)``) the solve is sharded by landmarks
over the group's ranks.  Rank 0 owns the window: it broadcasts a header and the
same packed buffer, every rank solves its shard of the landmarks
(``ba.make_sharded_ba``), and the refined shards are gathered.  The other ranks
run :func:`serve_refines`, which waits for those broadcasts and ends on the
header that :func:`stop_serving` sends.  The sharded solve stays eager: its
``gloo`` collectives cannot be held by a CUDA graph.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from .. import profiling, solve_graph
from ..config import CameraIntrinsics
from ..device import resolve_device
from ..geometry import se3
from . import ba

#: the header rank 0 broadcasts before a sharded refine: (_REFINE, iterations,
#: K, L, C), or _STOP and zeros when no refine follows
_STOP, _REFINE = 0, 1


def _np_pose_to_coeffs(quat, position):
    """Host mirror of se3.pose_to_coefficients."""
    q = np.asarray(quat, np.float64)
    p = np.asarray(position, np.float64)
    return np.concatenate([p, q[:3] / max(1.0 + q[3], 1e-3)]).astype(np.float32)


def _to_numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@dataclass
class KeyframeWindow:
    """Sliding window of keyframes with per-feature-id observations.

    ``max_obs_per_landmark`` defaults to ``max_keyframes``: a keyframe gives at
    most one observation of a landmark, so the per-landmark cap cannot drop an
    observation inside the window; whatever is truncated is counted in
    ``dropped_landmarks`` / ``dropped_obs``.  ``device=None`` is the card."""

    max_keyframes: int = 8
    max_landmarks: int = 512
    max_obs_per_landmark: int = 0   # 0 -> max_keyframes
    # (landmark, position, rotation) anchor information weights of the
    # anchored live solve; None = the defaults of the ba module
    anchor_weights: tuple | None = None
    device: object = None

    poses: list = field(default_factory=list)         # [K] 6-coeff np arrays
    timestamps: list = field(default_factory=list)
    frame_ids: list = field(default_factory=list)     # [K] source frame index
    obs: dict = field(default_factory=dict)           # fid -> [(kf_idx, uv, z)]
    landmark_pos: dict = field(default_factory=dict)  # fid -> last map position
    landmark_slot: dict = field(default_factory=dict) # fid -> map slot at last sight
    dropped_landmarks: int = 0   # cumulative landmarks truncated by max_landmarks
    dropped_obs: int = 0         # cumulative observations truncated by the C cap
    #: host-to-device copies and device-to-host reads made by refine()
    transfers: dict = field(default_factory=lambda: {"uploads": 0, "readbacks": 0})

    def __post_init__(self):
        if self.max_obs_per_landmark <= 0:
            self.max_obs_per_landmark = self.max_keyframes
        self._lm_host = None
        # the local solvers by static key (see _get_solver)
        self._solvers = {}

    def add_keyframe(self, quat, position, output, point_positions, timestamp=0.0,
                     frame_id=None):
        """Record a keyframe from an engine step output.  ``point_positions``:
        the map's world positions aligned with the output's per-slot record
        (``state.points.pos`` of the same step)."""
        fids = _to_numpy(output.point_fid)
        zs = (_to_numpy(output.point_obs_z) if hasattr(output, "point_obs_z")
              else np.zeros(len(fids), np.float32))
        self._add(_to_numpy(quat), _to_numpy(position), _to_numpy(output.point_matched),
                  fids, _to_numpy(output.point_obs_uv), zs, _to_numpy(point_positions),
                  timestamp, frame_id)

    def add_keyframe_packed(self, quat, position, fobs, fids, timestamp=0.0,
                            frame_id=None):
        """Record a keyframe from the runner's ``_pack_keyframe_obs`` output
        (two host reads instead of five)."""
        fobs = _to_numpy(fobs)
        self._add(quat, position, fobs[:, 0] > 0.5, _to_numpy(fids), fobs[:, 1:3],
                  fobs[:, 3], fobs[:, 4:7], timestamp, frame_id)

    def _add(self, quat, position, matched, fids, uvs, zs, pos, timestamp, frame_id):
        # slide before inserting: a landmark seen in every live keyframe would
        # otherwise hit the C cap with the new observation while the oldest one
        # is about to leave anyway
        if len(self.poses) + 1 > self.max_keyframes:
            self._drop_oldest()
        kf_idx = len(self.poses)
        self.poses.append(_np_pose_to_coeffs(quat, position))
        self.timestamps.append(float(timestamp))
        self.frame_ids.append(kf_idx if frame_id is None else int(frame_id))

        for i in np.nonzero(matched & (fids >= 0))[0]:
            fid = int(fids[i])
            entry = self.obs.setdefault(fid, [])
            if len(entry) < self.max_obs_per_landmark:
                entry.append((kf_idx, uvs[i].copy(), float(zs[i])))
            else:
                self.dropped_obs += 1
            self.landmark_pos[fid] = pos[i].copy()
            self.landmark_slot[fid] = int(i)

    def _drop_oldest(self):
        self.poses.pop(0)
        self.timestamps.pop(0)
        self.frame_ids.pop(0)
        new_obs = {}
        for fid, entries in self.obs.items():
            kept = [(k - 1, uv, z) for k, uv, z in entries if k > 0]
            if kept:
                new_obs[fid] = kept
        self.obs = new_obs

    @property
    def n_keyframes(self):
        return len(self.poses)

    def build_problem(self):
        """Pack the window into the BA layout: landmarks seen in >= 2 keyframes.

        Always the static shapes K = max_keyframes, L = max_landmarks, C =
        max_obs_per_landmark: (poses [K, 6], landmarks [L, 3], obs_kf [L, C],
        obs_uv [L, C, 2], obs_z [L, C], obs_mask [L, C], fids [L] int64, slots
        [L] int32, lm_valid [L]) as numpy, or None if under-constrained."""
        if self.n_keyframes < 2:
            return None
        usable = [(fid, e) for fid, e in self.obs.items() if len(e) >= 2]
        if len(usable) < 8:
            return None
        if len(usable) > self.max_landmarks:
            # keep the best-constrained landmarks and account for the rest
            usable.sort(key=lambda t: len(t[1]), reverse=True)
            self.dropped_landmarks += len(usable) - self.max_landmarks
            usable = usable[: self.max_landmarks]
        k = self.max_keyframes
        l = self.max_landmarks
        c = self.max_obs_per_landmark
        obs_kf = np.zeros((l, c), np.int32)
        obs_uv = np.zeros((l, c, 2), np.float32)
        obs_z = np.zeros((l, c), np.float32)
        obs_mask = np.zeros((l, c), bool)
        landmarks = np.zeros((l, 3), np.float32)
        fids = np.full((l,), -1, np.int64)
        slots = np.zeros((l,), np.int32)
        lm_valid = np.zeros((l,), bool)
        for i, (fid, entries) in enumerate(usable):
            fids[i] = fid
            slots[i] = self.landmark_slot.get(fid, 0)
            lm_valid[i] = True
            landmarks[i] = self.landmark_pos[fid]
            for j, (kf, uv, z) in enumerate(entries[:c]):
                obs_kf[i, j] = kf
                obs_uv[i, j] = uv
                obs_z[i, j] = z
                obs_mask[i, j] = True
        poses = np.zeros((k, 6), np.float32)
        poses[: self.n_keyframes] = np.stack(self.poses).astype(np.float32)
        return (poses, landmarks, obs_kf, obs_uv, obs_z, obs_mask, fids, slots, lm_valid)

    def _solve(self, buf, cam: CameraIntrinsics, iterations: int, mesh=None):
        """The packed solve on the device, local or, with ``mesh``, this rank's
        part of the sharded one.  ``buf`` is the int32 buffer that
        :meth:`refine` packs.  Returns (one float32 result buffer, and the
        refined landmarks, slots, validity and feature ids for the map
        scatter)."""
        dims = (self.max_keyframes, self.max_landmarks, self.max_obs_per_landmark)
        poses, landmarks, obs_uv, obs_z, obs_kf, obs_mask, slots, lm_valid, fids_dev = \
            _unpack_problem(buf, *dims)
        if mesh is None:
            new_poses, new_lm, costs = ba.ba_solve(
                poses, landmarks, obs_kf, obs_uv, obs_mask, cam, iterations=iterations,
                anchored=True, anchor_weights=self.anchor_weights, obs_z=obs_z)
        else:
            new_poses, new_lm, costs = _solve_shard(
                mesh, cam, iterations, self.anchor_weights, poses, landmarks, obs_kf, obs_uv,
                obs_mask, obs_z)
        quats, positions = se3.coefficients_to_pose(new_poses)
        # the refined landmarks ride along in the one read, so that
        # apply_refinement does not read them again
        out = torch.cat([quats.reshape(-1), positions.reshape(-1), costs.reshape(-1),
                         new_lm.reshape(-1)])
        return out, new_lm, slots, lm_valid, fids_dev

    def _get_solver(self, cam: CameraIntrinsics, iterations: int, mesh):
        """The packed solve of :meth:`_solve` that :meth:`refine` calls on its
        buffer.  Without ``mesh``: one ``solve_graph.solver`` per static key
        (``cam``, ``iterations``, the anchor weights, K, L, C and the device),
        kept for the window's life, as ``jax.jit`` keeps one program per static
        key: on a card a ``SolveGraph`` recorded at its first call, on the CPU
        the eager solve.  With ``mesh``: this rank's part of the sharded solve,
        eagerly (a CUDA graph cannot hold its ``gloo`` collectives)."""
        device = resolve_device(self.device)
        if mesh is not None:
            return solve_graph.EagerSolve(
                functools.partial(self._solve, cam=cam, iterations=iterations, mesh=mesh),
                device)
        key = (cam, iterations, self.anchor_weights, self.max_keyframes, self.max_landmarks,
               self.max_obs_per_landmark, device)
        if key not in self._solvers:
            self._solvers[key] = solve_graph.solver(
                functools.partial(self._solve, cam=cam, iterations=iterations), device)
        return self._solvers[key]

    def refine(self, cam: CameraIntrinsics, iterations: int = 8, mesh=None):
        """Run windowed BA.

        Returns ``(refined, device_lm, costs)``: ``refined`` a list of (quat,
        position) host arrays of the live keyframes; ``device_lm = (fids [L]
        host, slots [L], new_lm [L, 3], lm_valid [L], fids [L])``, the last four
        on the device for the map scatter; ``costs`` the cost before each
        iteration, host.  None when under-constrained.  Where the solve
        overwrites its outputs at the next call (a CUDA graph), the four
        device tensors are copies, taken on the device, so that they outlive
        the next refine.

        ``mesh``: a process group over which the solve is sharded by
        landmarks; this is rank 0's side, the other ranks are in
        :func:`serve_refines`.  The group's size must divide ``max_landmarks``."""
        problem = self.build_problem()
        if problem is None:
            return None
        fids, lm_valid = problem[6], problem[8]
        buf = torch.from_numpy(_pack_problem(problem))
        solve = self._get_solver(cam, iterations, mesh)
        if mesh is not None:
            buf = buf.to(resolve_device(self.device))
            _broadcast_header(mesh, buf.device, _REFINE, iterations, self.max_keyframes,
                              self.max_landmarks, self.max_obs_per_landmark)
            dist.broadcast(buf, src=dist.get_global_rank(mesh, 0), group=mesh)
        # the solver moves a host buffer to its device in the one copy
        out, *device_lm = solve(buf)
        self.transfers["uploads"] += 1
        with profiling.span("solve.read"):
            out = out.cpu().numpy()
        self.transfers["readbacks"] += 1
        if solve.reuses_outputs:
            device_lm = [t.clone() for t in device_lm]
        new_lm, slots_dev, lm_valid_dev, fids_dev = device_lm
        k, l = self.max_keyframes, self.max_landmarks
        quats = out[: k * 4].reshape(k, 4)
        positions = out[k * 4: k * 7].reshape(k, 3)
        costs = out[k * 7: k * 7 + iterations]
        self._lm_host = (fids, out[k * 7 + iterations:].reshape(l, 3), lm_valid)
        refined = [(quats[i], positions[i]) for i in range(self.n_keyframes)]
        return refined, (fids, slots_dev, new_lm, lm_valid_dev, fids_dev), costs

    def close(self):
        """Free the solvers' CUDA graphs and their memory; a later refine
        records anew."""
        for solve in self._solvers.values():
            solve.close()
        self._solvers.clear()

    def apply_refinement(self, refined, device_lm=None):
        """Write refined poses back into the window, so that the next refine
        starts from them.  Landmark positions refresh themselves on the next
        keyframe from the live map, so only landmarks that have left the map
        need the ``device_lm`` update here."""
        self.poses = [_np_pose_to_coeffs(q, p) for q, p in refined]
        if device_lm is not None:
            fids, _slots, new_lm, lm_valid = device_lm[:4]
            cached = self._lm_host
            if cached is not None and cached[0] is fids:
                _, lm_host, valid_host = cached   # rode along in refine's read
            else:
                lm_host = _to_numpy(new_lm)
                valid_host = _to_numpy(lm_valid)
            for i in range(len(fids)):
                if valid_host[i] and int(fids[i]) in self.landmark_pos:
                    self.landmark_pos[int(fids[i])] = lm_host[i]


def _pack_problem(problem) -> np.ndarray:
    """The one int32 buffer of :meth:`KeyframeWindow.build_problem`'s arrays
    that a refine moves to the device: the float arrays as their bit patterns,
    then the integer and boolean ones (:func:`_unpack_problem` takes it
    apart)."""
    poses, landmarks, obs_kf, obs_uv, obs_z, obs_mask, fids, slots, lm_valid = problem
    floats = np.concatenate([poses.reshape(-1), landmarks.reshape(-1),
                             obs_uv.reshape(-1), obs_z.reshape(-1)])
    return np.concatenate([floats.view(np.int32), obs_kf.reshape(-1),
                           obs_mask.reshape(-1).astype(np.int32), slots,
                           lm_valid.astype(np.int32), fids.astype(np.int32)])


def _unpack_problem(buf, k: int, l: int, c: int):
    """The views of the int32 buffer that :meth:`KeyframeWindow.refine` packs:
    (poses [K, 6], landmarks [L, 3], obs_uv [L, C, 2], obs_z [L, C], obs_kf
    [L, C], obs_mask [L, C], slots [L], lm_valid [L], fids [L])."""
    n_float = k * 6 + l * 3 + l * c * 2 + l * c
    fbuf = buf[:n_float].view(torch.float32)
    ibuf = buf[n_float:]
    offset = [0]

    def take(src, n, shape):
        a = src[offset[0]:offset[0] + n].reshape(shape)
        offset[0] += n
        return a

    poses = take(fbuf, k * 6, (k, 6))
    landmarks = take(fbuf, l * 3, (l, 3))
    obs_uv = take(fbuf, l * c * 2, (l, c, 2))
    obs_z = take(fbuf, l * c, (l, c))
    offset[0] = 0
    obs_kf = take(ibuf, l * c, (l, c))
    obs_mask = take(ibuf, l * c, (l, c)) > 0
    slots = take(ibuf, l, (l,))
    lm_valid = take(ibuf, l, (l,)) > 0
    fids = take(ibuf, l, (l,))
    return poses, landmarks, obs_uv, obs_z, obs_kf, obs_mask, slots, lm_valid, fids


def _solve_shard(group, cam, iterations, anchor_weights, poses, landmarks, obs_kf, obs_uv,
                 obs_mask, obs_z):
    """This rank's part of a sharded refine: solve its block of landmarks and
    gather every rank's refined block.  Returns (poses, landmarks [L, 3],
    costs), the same on every rank."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    n_l = landmarks.shape[0]
    if n_l % world:
        raise ValueError(f"{n_l} landmarks do not divide over {world} ranks")
    mine = slice(rank * n_l // world, (rank + 1) * n_l // world)
    solve = ba.make_sharded_ba(group, cam, n_keyframes=poses.shape[0], iterations=iterations,
                               anchored=True, anchor_weights=anchor_weights, with_depth=True)
    new_poses, lm_shard, costs = solve(poses, landmarks[mine], obs_kf[mine], obs_uv[mine],
                                       obs_mask[mine], obs_z[mine])
    return new_poses, ba.all_gather_rows(lm_shard, group), costs


def _broadcast_header(group, device, *values):
    header = torch.tensor(values, dtype=torch.int32, device=device)
    dist.broadcast(header, src=dist.get_global_rank(group, 0), group=group)


def stop_serving(group, device=None):
    """Rank 0: end the other ranks' :func:`serve_refines`."""
    _broadcast_header(group, resolve_device(device), _STOP, 0, 0, 0, 0)


def serve_refines(group, cam: CameraIntrinsics, anchor_weights: tuple | None = None,
                  device=None) -> int:
    """The loop of every rank but 0 of a sharded backend: wait for rank 0's
    header, take the broadcast window, solve this rank's shard of it, and go
    on until the header says stop.  ``anchor_weights`` must be rank 0's.
    Returns the number of refines served."""
    device = resolve_device(device)
    src = dist.get_global_rank(group, 0)
    served = 0
    while True:
        header = torch.zeros(5, dtype=torch.int32, device=device)
        dist.broadcast(header, src=src, group=group)
        op, iterations, k, l, c = header.tolist()
        if op == _STOP:
            return served
        buf = torch.zeros(k * 6 + l * 3 + 5 * l * c + 3 * l, dtype=torch.int32, device=device)
        dist.broadcast(buf, src=src, group=group)
        poses, landmarks, obs_uv, obs_z, obs_kf, obs_mask, _, _, _ = \
            _unpack_problem(buf, k, l, c)
        _solve_shard(group, cam, iterations, anchor_weights, poses, landmarks, obs_kf, obs_uv,
                     obs_mask, obs_z)
        served += 1
