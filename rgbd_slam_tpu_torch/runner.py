"""Sequence runner: drive the engine over frames and record the trajectory and
timings (port of ``rgbd_slam_tpu/runner.py``): the frame loop, depth
rectification for a calibrated rig, the keyframe / bundle-adjustment /
pose-graph backend on one device or sharded over a process group, and the
streaming map export.
"""

from __future__ import annotations

import functools
import inspect
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from . import engine
from .config import CameraIntrinsics, SlamConfig
from .device import resolve_device
from .io.map_writer import OBJWriter, append_alive_features, append_dying_features
from .io.trajectory import Trajectory, ate_rmse
from .ops.depth_cloud import rectify_depth
from .parallel.keyframes import KeyframeWindow, serve_refines, stop_serving
from .parallel.pose_graph import PoseGraph, _np_quat_mul, _np_quat_rotate


@dataclass
class RunStats:
    """Wall-clock accounting.  ``compile_s`` is the first frame's time, which
    includes the kernel build and device warm-up; ``ba_compile_s`` the first
    refine's, which includes the solver's warm-up."""
    frame_count: int = 0
    success_count: int = 0
    lost_count: int = 0
    total_step_s: float = 0.0
    compile_s: float = 0.0
    keyframe_count: int = 0
    ba_runs: int = 0
    ba_accepted: int = 0
    ba_total_s: float = 0.0
    ba_total_iters: int = 0
    ba_compile_s: float = 0.0
    # observations and landmarks truncated by the BA window, never silently
    ba_dropped_landmarks: int = 0
    ba_dropped_obs: int = 0
    # pose-graph solves (every accepted refine asks for one) and their time
    graph_solves: int = 0
    graph_total_s: float = 0.0
    graph_first_s: float = 0.0
    # the backend's copies to the device and reads back: one each per refine
    # and per graph solve
    backend_uploads: int = 0
    backend_readbacks: int = 0
    # features the streamed map export wrote when they died, and at the end
    map_streamed: int = 0
    map_alive_at_end: int = 0

    @property
    def ba_iters_per_s(self):
        """Steady-state BA throughput: the first refine is excluded, as
        ``mean_step_ms`` excludes the first frame."""
        runs = self.ba_runs - (1 if self.ba_compile_s > 0 else 0)
        t = self.ba_total_s - self.ba_compile_s
        if runs <= 0 or t <= 0:
            return 0.0
        iters_per_run = self.ba_total_iters / max(self.ba_runs, 1)
        return iters_per_run * runs / t

    @property
    def mean_step_ms(self):
        n = max(self.frame_count - 1, 1)  # exclude the first frame
        return 1000.0 * (self.total_step_s - self.compile_s) / n

    @property
    def fps(self):
        ms = self.mean_step_ms
        return 1000.0 / ms if ms > 0 else 0.0

    def summary(self) -> str:
        return (f"frames={self.frame_count} success={self.success_count} "
                f"lost={self.lost_count} mean_step={self.mean_step_ms:.1f}ms "
                f"fps={self.fps:.1f}")


#: frames per batched summary read: frame 0 is read alone, then frames 1-8,
#: 9-16, ...; keyframe and BA decisions run up to a batch late
SUMMARY_BATCH = 8


def stage_frames(frames, chunk: int = 32, device=None):
    """Upload a (gray, depth[, ts]) sequence to ``device`` (``None``: the card)
    in stacked transfers of ``chunk`` frames, and return per-frame views of the
    stacks, each with the rest of its frame's tuple.

    On a card the stacks are filled in page-locked host buffers and copied with
    ``non_blocking=True``: the copy is queued behind the card's work and the
    host goes on, where ``torch.as_tensor(numpy_array, device=...)`` from
    pageable memory makes the host wait for the card's queue to drain, once for
    the gray image and once for the depth map of every frame.  ``run_frames``
    takes the views as they are."""
    device = resolve_device(device)
    pin = device.type == "cuda"
    staged = []
    for c0 in range(0, len(frames), chunk):
        sub = frames[c0:c0 + chunk]
        stacks = []
        for k in (0, 1):
            first = torch.as_tensor(sub[0][k])
            host = torch.empty((len(sub), *first.shape), dtype=torch.float32, pin_memory=pin)
            for i, f in enumerate(sub):
                host[i] = torch.as_tensor(f[k])
            stacks.append(host.to(device, non_blocking=True))
        for i, f in enumerate(sub):
            staged.append((stacks[0][i], stacks[1][i]) + tuple(f[2:]))
    return staged


def _pack_summary(out: engine.StepOutput):
    """Everything the frame loop reads every frame, as one [12] tensor:
    position, quaternion, success, is_lost, n_evicted, n_plane_merge_dropped,
    n_point_inliers."""
    f32 = torch.float32
    return torch.cat([out.position.to(f32), out.quat.to(f32),
                      torch.stack([out.success.to(f32), out.is_lost.to(f32),
                                   out.n_evicted.to(f32),
                                   out.n_plane_merge_dropped.to(f32),
                                   out.n_point_inliers.to(f32)])])


def _pack_keyframe_obs(out: engine.StepOutput, point_positions):
    """A keyframe's observation record as two tensors (one float32 [M3, 7]:
    matched, u, v, z, map position; one int32 [M3]: feature ids), so that the
    keyframe window reads the host twice, not five times."""
    f32 = torch.float32
    fobs = torch.cat([out.point_matched.to(f32)[:, None], out.point_obs_uv.to(f32),
                      out.point_obs_z.to(f32)[:, None], point_positions.to(f32)], dim=-1)
    return fobs, out.point_fid


def _scatter_kernel(points_pos, points_fid, slots, fids, new_lm, lm_valid):
    """Feature-id-verified landmark scatter on the device.

    Each BA landmark carries the map slot it was last seen in; it is written
    only if that slot still holds the same feature id (the lifecycle may have
    given the slot away between observation and refinement), the landmark was
    valid in the window, and the refinement moved it by no more than 300 mm.
    Rows that fail write the slot's current value back, in row order (the last
    row of a slot wins), as the JAX package's scatter does on a CPU."""
    slots = slots.to(torch.int64)
    cur = points_pos[slots]
    ok = (lm_valid & (points_fid[slots] == fids.to(points_fid.dtype))
          & (torch.linalg.vector_norm(new_lm - cur, dim=-1) <= 300.0))
    return engine._scatter_set(points_pos, slots, torch.where(ok[:, None], new_lm, cur))


def _scatter_ba_landmarks(state: engine.SlamState, device_lm) -> engine.SlamState:
    """Write BA-refined landmark positions back into the live point map, on the
    device.  ``device_lm``: (fids host, slots, new_lm, lm_valid, fids) from
    ``KeyframeWindow.refine``."""
    _, slots, new_lm, lm_valid, fids_dev = device_lm
    new_pos = _scatter_kernel(state.points.pos, state.points.fid, slots, fids_dev, new_lm,
                              lm_valid)
    return state._replace(points=state.points._replace(pos=new_pos))


def _apply_graph_correction(traj: Trajectory, node_fids, new_quats, new_pos):
    """Correct the trajectory from solved pose-graph nodes: each keyframe takes
    its refined pose; the frames between two keyframes are moved by the rigid
    delta of the keyframe before them (host numpy)."""
    n_frames = len(traj.positions)
    order = np.argsort(node_fids)
    for oi, idx in enumerate(order):
        fid = int(node_fids[idx])
        if fid >= n_frames:
            continue
        q_old = np.asarray(traj.quaternions[fid], np.float64)
        p_old = np.asarray(traj.positions[fid], np.float64)
        q_new = np.asarray(new_quats[idx], np.float64)
        p_new = np.asarray(new_pos[idx], np.float64)
        # delta T such that T_new = delta o T_old
        q_old_conj = q_old * np.array([1.0, -1.0, -1.0, -1.0])
        q_d = _np_quat_mul(q_new, q_old_conj)
        p_d = p_new - _np_quat_rotate(q_d, p_old)
        end = int(node_fids[order[oi + 1]]) if oi + 1 < len(order) else n_frames
        traj.quaternions[fid] = q_new
        traj.positions[fid] = p_new
        for f in range(fid + 1, min(end, n_frames)):
            traj.positions[f] = _np_quat_rotate(q_d, traj.positions[f]) + p_d
            traj.quaternions[f] = _np_quat_mul(q_d, traj.quaternions[f])


def _with_refine_servers(run):
    """``run_frames`` over a process group: rank 0 runs ``run`` and, whatever
    happens in it, tells the other ranks to stop at the end; the other ranks
    serve its refines and return ``(None, None, stats)``."""
    signature = inspect.signature(run)

    @functools.wraps(run)
    def wrapper(*args, **kw):
        bound = signature.bind(*args, **kw)
        bound.apply_defaults()
        group = bound.arguments["ba_mesh"]
        if group is None:
            return run(*args, **kw)
        device = resolve_device(bound.arguments["device"])
        if dist.get_rank(group) != 0:
            served = serve_refines(group, bound.arguments["cam"],
                                   anchor_weights=bound.arguments["ba_anchor_weights"],
                                   device=device)
            return None, None, RunStats(ba_runs=served)
        try:
            return run(*args, **kw)
        finally:
            stop_serving(group, device)

    return wrapper


@_with_refine_servers
def run_frames(frames, cam: CameraIntrinsics, cfg: SlamConfig,
               with_planes: bool = True, with_lines: bool = False, seed: int = 0,
               state: engine.SlamState | None = None, on_frame=None,
               ba_every: int | None = None, ba_window: int = 8, ba_iterations: int = 8,
               ba_mesh=None, ba_anchor_weights: tuple | None = None,
               kf_min_trans_mm: float = 20.0, kf_min_rot_deg: float = 1.0,
               with_pose_graph: bool = True, ba_update_map: bool = True,
               ba_correct_traj: bool = True, camera_setup=None,
               export_map: str | None = None, device=None):
    """Run the engine over an iterable of (gray, depth[, timestamp]) frames (numpy
    or tensors), on ``device`` (``None``: the card, see ``resolve_device``).

    The loop reads a frame's summary from the device in batches of
    ``SUMMARY_BATCH`` frames (frame 0 alone), so ``on_frame(i, state, out, dt)``
    and the backend run up to a batch after their frame, with ``dt`` the
    batch's mean time a frame.  Frames that are tensors on ``device`` already
    (``stage_frames``) are taken as they are.

    ``camera_setup`` (a ``config.CameraSetup``) with a depth-to-RGB extrinsic
    other than the identity makes the loop rectify every depth map into the RGB
    camera (``ops.depth_cloud.rectify_depth``); at the identity the warp would
    change nothing and is left out.

    When ``ba_every`` is set, a sliding ``KeyframeWindow`` collects the point
    observations of keyframes, selected by a motion gate (translation >=
    ``kf_min_trans_mm`` or rotation >= ``kf_min_rot_deg`` since the last one),
    and the windowed BA refines poses and landmarks every ``ba_every`` frames.
    A refinement whose costs are finite and fell is accepted: its landmarks are
    scattered back into the live point map (guarded by feature id against slot
    reuse) and its poses correct the trajectory.  With ``with_pose_graph`` the
    refined relative poses feed a ``PoseGraph`` that re-solves the keyframe
    chain and is then the only writer of the trajectory.

    ``ba_mesh`` is a ``torch.distributed`` process group over which every refine
    is sharded by landmarks (``parallel.ba.make_sharded_ba``).  Every rank of
    the group calls ``run_frames`` with the same arguments: rank 0 runs the
    frame loop, the others serve its refines
    (``parallel.keyframes.serve_refines``) until rank 0 is done, or has raised,
    and return ``(None, None, stats)`` with the refines they served in
    ``stats.ba_runs``.

    When ``export_map`` is set, an OBJ map file is streamed during the run:
    every local feature is appended when it dies (the step's eviction record)
    and the surviving local map at the end, so that features lost on the way
    still reach the file.

    Returns (final_state, Trajectory, RunStats)."""
    device = resolve_device(device)
    if state is None:
        state = engine.init_state(cam, cfg, seed=seed, device=device)
    traj = Trajectory()
    stats = RunStats()

    rectify = None
    if camera_setup is not None:
        ext = np.asarray(camera_setup.depth_to_rgb, np.float64)
        if not np.allclose(ext, np.eye(4)):
            ext_dev = torch.tensor(ext, dtype=torch.float32, device=device)
            depth_cam = camera_setup.depth

            def rectify(d):
                return rectify_depth(d, depth_cam, cam, ext_dev)

    window = None
    graph = None
    last_kf_quat = None
    last_kf_pos = None
    pending_kfs = []   # keyframe packs read by the host only when a refine needs them
    if ba_every:
        window = KeyframeWindow(max_keyframes=ba_window, anchor_weights=ba_anchor_weights,
                                device=device)
        if with_pose_graph:
            graph = PoseGraph(device=device)

    def _refine(i):
        nonlocal state
        if pending_kfs:
            # every waiting keyframe's pack in two reads
            fobs = torch.stack([kf[2] for kf in pending_kfs]).cpu().numpy()
            kf_fids = torch.stack([kf[3] for kf in pending_kfs]).cpu().numpy()
            for (q_, p_, _, _, ts_, i_), fo_, fi_ in zip(pending_kfs, fobs, kf_fids):
                window.add_keyframe_packed(q_, p_, fo_, fi_, timestamp=ts_, frame_id=i_)
            pending_kfs.clear()
        t_ba = time.perf_counter()
        res = window.refine(cam, iterations=ba_iterations, mesh=ba_mesh)
        if res is None:
            return
        refined, device_lm, costs = res
        stats.ba_runs += 1
        dt_ba = time.perf_counter() - t_ba
        stats.ba_total_s += dt_ba
        if stats.ba_runs == 1:
            stats.ba_compile_s = dt_ba
        stats.ba_total_iters += ba_iterations
        if np.isfinite(costs).all() and costs[-1] < costs[0]:
            stats.ba_accepted += 1
            if ba_update_map:
                window.apply_refinement(refined, device_lm)
                # the live state may be up to a batch past frame i: the scatter
                # is guarded by feature id
                state = _scatter_ba_landmarks(state, device_lm)
            if ba_correct_traj and graph is None:
                for kf, fi in enumerate(window.frame_ids):
                    q, p = refined[kf]
                    traj.positions[fi] = np.asarray(p, np.float64)
                    traj.quaternions[fi] = np.asarray(q, np.float64)
            if graph is not None:
                graph.add_ba_window(window.frame_ids[:len(refined)], refined)
                t_graph = time.perf_counter()
                solved = graph.solve()
                dt_graph = time.perf_counter() - t_graph
                stats.graph_solves += 1
                stats.graph_total_s += dt_graph
                if stats.graph_solves == 1:
                    stats.graph_first_s = dt_graph
                if solved is not None:
                    _apply_graph_correction(traj, *solved)
        stats.ba_dropped_landmarks = window.dropped_landmarks
        stats.ba_dropped_obs = window.dropped_obs
        moved = [window.transfers] + ([graph.transfers] if graph is not None else [])
        stats.backend_uploads = sum(t["uploads"] for t in moved)
        stats.backend_readbacks = sum(t["readbacks"] for t in moved)

    def _process(i, ts, frame_state, out, summary, dt):
        """Consume one frame's summary: stats, trajectory, keyframes and BA.
        ``frame_state`` is the state of the same step as ``out`` (its slots
        align with ``out``'s records)."""
        nonlocal last_kf_quat, last_kf_pos
        pos_np = summary[0:3]
        quat_np = summary[3:7]
        success = summary[7] > 0.5

        stats.frame_count += 1
        stats.total_step_s += dt
        if i == 0:
            stats.compile_s = dt
        stats.success_count += int(success)
        stats.lost_count += int(summary[8] > 0.5)
        traj.append(ts, pos_np, quat_np)

        if window is not None and success:
            is_kf = last_kf_quat is None
            if not is_kf:
                trans_mm = float(np.linalg.norm(pos_np - last_kf_pos))
                dot = min(abs(float(np.dot(quat_np, last_kf_quat))), 1.0)
                rot_deg = float(np.degrees(2.0 * np.arccos(dot)))
                is_kf = trans_mm >= kf_min_trans_mm or rot_deg >= kf_min_rot_deg
            if is_kf:
                stats.keyframe_count += 1
                last_kf_quat, last_kf_pos = quat_np, pos_np
                fobs, kf_fids = _pack_keyframe_obs(out, frame_state.points.pos)
                pending_kfs.append((quat_np, pos_np, fobs, kf_fids, ts, i))
                if graph is not None:
                    graph.add_keyframe(i, quat_np, pos_np)
            if window.n_keyframes + len(pending_kfs) >= 3 and (i + 1) % ba_every == 0:
                _refine(i)

        if map_writer is not None and summary[9] > 0.5:   # n_evicted
            stats.map_streamed += append_dying_features(map_writer, out)

        if on_frame is not None:
            on_frame(i, frame_state, out, dt)

    pending = []
    t_prev = time.perf_counter()

    def _drain():
        nonlocal t_prev
        if not pending:
            return
        batch = torch.stack([p[4] for p in pending]).cpu().numpy().astype(np.float64)
        now = time.perf_counter()
        per_frame = (now - t_prev) / len(pending)
        t_prev = now
        for row, (pi, pts_, pstate, pout, _) in zip(batch, pending):
            _process(pi, pts_, pstate, pout, row, per_frame)
        pending.clear()

    map_writer = OBJWriter(export_map) if export_map is not None else None
    try:
        for i, frame in enumerate(frames):
            if len(frame) == 3:
                gray, depth, ts = frame
            else:
                (gray, depth), ts = frame, float(i)
            gray = torch.as_tensor(gray, dtype=torch.float32, device=device)
            depth = torch.as_tensor(depth, dtype=torch.float32, device=device)
            if rectify is not None:
                depth = rectify(depth)
            state, out = engine.step(state, gray, depth, cam, cfg, with_planes=with_planes,
                                     with_lines=with_lines)
            pending.append((i, ts, state, out, _pack_summary(out)))
            if i == 0 or len(pending) >= SUMMARY_BATCH:
                _drain()
        _drain()
        if map_writer is not None:
            stats.map_alive_at_end = append_alive_features(map_writer, state,
                                                           only_local=True)
    finally:
        if map_writer is not None:
            map_writer.close()
    return state, traj, stats


def evaluate_against_ground_truth(traj: Trajectory, gt_positions_mm) -> dict:
    """ATE metrics for a run."""
    est = traj.positions_array()
    gt = np.asarray(gt_positions_mm, dtype=np.float64)
    n = min(len(est), len(gt))
    return {"ate_rmse_mm": ate_rmse(est[:n], gt[:n], align=True), "frames": n}
