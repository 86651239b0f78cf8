"""Sequence runner: drive the engine over frames and record the trajectory and
timings (port of ``rgbd_slam_tpu/runner.py``): the frame loop, depth
rectification for a calibrated rig, the keyframe / bundle-adjustment /
pose-graph backend on one device or sharded over a process group, and the
streaming map export.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from . import engine, profiling, step_graph
from .config import CameraIntrinsics, SlamConfig
from .device import resolve_device
from .io.map_writer import OBJWriter, append_alive_features, append_dying_features
from .io.trajectory import Trajectory, ate_rmse
from .ops import stamps_cuda
from .ops.depth_cloud import rectify_depth
from .parallel.keyframes import KeyframeWindow, serve_refines, stop_serving
from .parallel.pose_graph import PoseGraph, _np_quat_mul, _np_quat_rotate


@dataclass
class RunStats:
    """Wall-clock accounting.  ``compile_s`` is the first frame's time: on a card
    the kernels' build, the warm-up step and the capture of the step's CUDA
    graph (``step_graph.StepGraph``, the counterpart of the JAX step's compile)
    and the first replay; on the CPU the first eager step.  ``warmup_steps``
    counts the eager steps the warm-up ran (their kernel launches are counted
    with the frames').  ``ba_compile_s`` and ``graph_first_s`` are the first
    refine's and the first graph solve's time: on a card the solver's warm-up,
    the capture of its CUDA graph (``solve_graph.SolveGraph``, the counterpart
    of the JAX solvers' compile) and the first replay, as ``compile_s`` is the
    step's; on the CPU the first eager solve.

    The run's trace (``run_frames(trace=...)``; empty with ``trace=False``):
    ``spans`` {name: {"count", "total_s", "self_s", "max_s"}} of every host
    span and ``counters`` {name: count} (``profiling.StageTimer``); and, where
    the step runs as a CUDA graph, its device stamps over the frames past the
    first, as µs summed over ``stamped_frames`` replays: each stage
    (``stage_device_us``, the path's ``profiling.stages``; a nested section,
    the cylinders', from its own start stamp), a replay from its
    first stamp to its last (``graph_span_us``), and from the last stamp of the replay
    before to its first (``replay_gap_us``: what the card spends between
    replays, idle or on other work).  Where a frame crosses from the host to
    the card, ``upload_device_us`` sums, over ``upload_frames`` frames, the
    stretch of the card's queue from a stamp before its upload to one after
    it (the copies, the depth's rectification and the host's turns between
    them, without the wait for the replay before).  ``clock_offset_ns`` is the card's clock less the
    host's ``perf_counter_ns``, measured at the capture, to within
    ``clock_offset_err_ns``.  The counters hold what no other field does:
    ``captures`` (CUDA graphs recorded), ``summary_waits`` (frames whose
    summary was still on its way from the card when the loop came for it, so
    that the host waited on its event), ``device_reads.keyframes``,
    ``uploads`` (frame arrays copied from the host) and ``clone_bytes``; the
    frames, refines, graph solves and the
    backend's reads are ``frame_count``, ``ba_runs``, ``graph_solves`` and
    ``backend_readbacks``."""
    frame_count: int = 0
    warmup_steps: int = 0
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
    # line segments detected and line matches kept (RANSAC inliers of tracked
    # frames), summed over the frames; lines alive in the map after the last
    lines_detected: int = 0
    line_matches: int = 0
    lines_alive: int = 0
    # the cylinder stage's selected live region slots (the MSAC's), summed
    # over the frames (``profiling.count_cylinders``; 0 with planes off)
    cylinders_live: int = 0
    # the run's trace
    spans: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    stage_device_us: dict = field(default_factory=dict)
    graph_span_us: float = 0.0
    replay_gap_us: float = 0.0
    stamped_frames: int = 0
    upload_device_us: float = 0.0
    upload_frames: int = 0
    clock_offset_ns: int = 0
    clock_offset_err_ns: int = 0

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

    def backend_ms(self) -> dict:
        """ms of the first refine and the first graph solve, and the mean ms of
        a refine and of a graph solve past the first."""
        return dict(
            first_refine_ms=1e3 * self.ba_compile_s,
            refine_ms=1e3 * (self.ba_total_s - self.ba_compile_s) / max(self.ba_runs - 1, 1),
            first_graph_solve_ms=1e3 * self.graph_first_s,
            graph_solve_ms=1e3 * (self.graph_total_s - self.graph_first_s)
            / max(self.graph_solves - 1, 1))

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


#: the backend's cadence, the JAX runner's batch: frame 0 forms a group alone,
#: then frames 1-8, 9-16, ... (``_HandOver``)
SUMMARY_BATCH = 8
#: float32 entries of a frame's summary before the step's stamps
SUMMARY_WIDTH = 16
#: what a frame source's ``next`` gives at its end
_END = object()


@dataclass
class _Issued:
    """A frame whose step has been issued and that the loop has not processed:
    what ``_HandOver``'s consumer takes, its ``summary`` as ``_HandOver.send``
    sent it, and the summary's ``row`` once it is on the host."""
    i: int
    ts: float
    state: object
    out: object
    kf_obs: object
    uploaded: bool
    summary: object
    row: np.ndarray | None = None


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


def _pack_summary(out: engine.StepOutput, stamps=None, cylinders_live=None):
    """Everything the frame loop reads every frame, as one float32 tensor:
    position, quaternion, success, is_lost, n_evicted, n_plane_merge_dropped,
    n_point_inliers (the JAX runner's summary), n_lines, n_line_matches,
    n_lines_alive, the cylinder stage's live slots (``cylinders_live``; 0 where
    the step counted none) (``SUMMARY_WIDTH``), then the int64 ``stamps`` of the
    step's graph, if given, as their bit patterns (two entries a stamp), so
    that they reach the host in the summary's read and keep every ns."""
    f32 = torch.float32
    live = (torch.zeros_like(out.position[0]) if cylinders_live is None
            else cylinders_live.to(f32))
    parts = [out.position.to(f32), out.quat.to(f32),
             torch.stack([out.success.to(f32), out.is_lost.to(f32),
                          out.n_evicted.to(f32), out.n_plane_merge_dropped.to(f32),
                          out.n_point_inliers.to(f32), out.n_lines.to(f32),
                          out.n_line_matches.to(f32), out.n_lines_alive.to(f32),
                          live])]
    if stamps is not None:
        parts.append(stamps.view(f32))
    return torch.cat(parts)


def _split_summary(row: np.ndarray):
    """Read one summary row [SUMMARY_WIDTH (+ 2 a stamp)] float32: (the summary
    as float64 [SUMMARY_WIDTH], the stamps int64 [k] or None)."""
    summary = row[:SUMMARY_WIDTH].astype(np.float64)
    if row.shape[0] == SUMMARY_WIDTH:
        return summary, None
    return summary, np.ascontiguousarray(row[SUMMARY_WIDTH:]).view(np.int64)


def _on_host(x, device) -> bool:
    """Whether a frame's array crosses from the host to the card ``device``."""
    return device.type == "cuda" and not (isinstance(x, torch.Tensor) and x.is_cuda)


def _upload(x, device):
    """A frame's array as a float32 tensor on ``device``; an array that crosses
    from the host is counted in ``uploads``."""
    if _on_host(x, device):
        profiling.count("uploads")
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _pack_keyframe_obs(out: engine.StepOutput, point_positions):
    """A keyframe's observation record as two new tensors (one float32 [M3, 7]:
    matched, u, v, z, map position; one int32 [M3]: feature ids), so that the
    keyframe window reads the host twice, not five times, and the record
    outlives the step's buffers."""
    f32 = torch.float32
    fobs = torch.cat([out.point_matched.to(f32)[:, None], out.point_obs_uv.to(f32),
                      out.point_obs_z.to(f32)[:, None], point_positions.to(f32)], dim=-1)
    return fobs, out.point_fid.clone()


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


def _receive(frame: _Issued) -> np.ndarray:
    """``frame``'s summary row on the host; where its copy is still under
    way, the host waits on its event (``summary_waits``), which leaves the
    steps queued behind it running."""
    if frame.row is None:
        with profiling.span("deliver.wait"):
            if isinstance(frame.summary, torch.Tensor):
                frame.row = frame.summary.numpy()
            else:
                row, event = frame.summary
                if not event.query():
                    profiling.count("summary_waits")
                    event.synchronize()
                frame.row = row.numpy().copy()
    return frame.row


class _HandOver:
    """The frames whose step has been issued, on their way to the host, handed
    in order to ``consumer.process(frame, row, dt)`` (``dt``: the host's time
    since the frame before was handed over), which returns whether a refine is
    due at the frame; ``consumer.refine()`` runs it once the frame that closes
    its group of ``SUMMARY_BATCH`` has been issued and received, the frames
    after it waiting with it.  ``refine_every``: the backend's cadence or None."""

    def __init__(self, consumer, refine_every: int | None):
        self._consumer, self._refine_every = consumer, refine_every
        self._issued = collections.deque()   # frames whose step is issued, not yet processed
        self._ring = []     # on a card, (page-locked row, event) pairs the summaries come back in
        self._held = None   # the frame that closes a due refine's group, until the refine runs
        self._t_prev = time.perf_counter()

    def send(self, i: int, summary):
        """Start frame ``i``'s summary towards the host (elsewhere than on a
        card it is there already): an asynchronous copy into a row of the
        page-locked ring, an event recorded behind it.  A held refine keeps at
        most ``SUMMARY_BATCH`` frames unprocessed, so a row of the ring's
        ``SUMMARY_BATCH + 1`` is written again only after its frame's read."""
        if summary.device.type != "cuda":
            return summary
        if not self._ring:
            rows = torch.empty((SUMMARY_BATCH + 1, summary.numel()), dtype=summary.dtype,
                               pin_memory=True)
            self._ring.extend((row, torch.cuda.Event()) for row in rows)
        row, event = self._ring[i % len(self._ring)]
        row.copy_(summary, non_blocking=True)
        event.record()
        return row, event

    def issue(self, frame: _Issued):
        """Queue a frame whose step has been issued, and hand over what is due."""
        self._issued.append(frame)
        self.deliver(frame.i)

    def deliver(self, j: int, end: bool = False):
        """Process the issued frames once frame ``j``'s step has been issued:
        those before ``j``, and ``j`` itself where it is frame 0 or closes its
        group with a refine possibly due at it (the refine must write back
        before the next step); at the ``end``, every one."""
        closes = (self._refine_every is not None and j % SUMMARY_BATCH == 0
                  and (j + 1) % self._refine_every == 0)
        bound = j + 1 if end or j == 0 or closes else j
        while True:
            if self._held is not None:
                if self._held > j and not end:
                    return
                if self._issued:
                    _receive(self._issued[-1])   # the frame that closes the group
                self._consumer.refine()
                self._held = None
            if not self._issued or self._issued[0].i >= bound:
                return
            frame = self._issued.popleft()
            with profiling.span("deliver"):
                row = _receive(frame)
                now = time.perf_counter()
                dt, self._t_prev = now - self._t_prev, now
                with profiling.span("deliver.process"):
                    if self._consumer.process(frame, row, dt):
                        self._held = -(-frame.i // SUMMARY_BATCH) * SUMMARY_BATCH


class _Consumer:
    """What a frame handed over goes into: the counts and the device stamps'
    sums of ``RunStats``, the trajectory, the map export, ``on_frame`` and,
    with a ``_Backend``, its keyframe gate and refines."""

    def __init__(self, stats: RunStats, traj: Trajectory, stepper, timer, map_writer,
                 on_frame, backend):
        self._stats, self._traj, self._stepper, self._timer = stats, traj, stepper, timer
        self._map_writer, self._on_frame, self._backend = map_writer, on_frame, backend
        self._last_stamp = None    # the last stamp of the replay before
        self._clone_bytes = None   # what a frame's copies out of the graph's buffers hold

    def keep(self, frame_state, out):
        """Copies of what the next replay overwrites, where they are read."""
        keep_out = self._on_frame is not None or self._map_writer is not None
        with profiling.span("frame.clone"):
            frame_state = (step_graph.clone_tree(frame_state) if self._on_frame is not None
                           else None)
            out = step_graph.clone_tree(out) if keep_out else None
        if self._timer is not None and (frame_state is not None or out is not None):
            if self._clone_bytes is None:
                self._clone_bytes = sum(
                    t.nbytes for t in step_graph.tensor_leaves((frame_state, out)))
            profiling.count("clone_bytes", self._clone_bytes)
        return frame_state, out

    def process(self, frame: _Issued, row: np.ndarray, dt: float) -> bool:
        """Consume one frame's summary row.  ``frame.state`` is the state of the
        same step as ``frame.out`` (its slots align with ``out``'s records) and
        ``frame.kf_obs`` its keyframe observation record; each is None where
        nothing reads it.  Returns whether a refine is due at this frame."""
        summary, stamps = _split_summary(row)
        if stamps is not None:
            self._add_stamps(frame.i, stamps, frame.uploaded)
        stats = self._stats
        stats.frame_count += 1
        stats.total_step_s += dt
        if frame.i == 0:
            stats.compile_s = dt
            stats.warmup_steps = self._stepper.warmup_steps
        stats.success_count += int(summary[7] > 0.5)
        stats.lost_count += int(summary[8] > 0.5)
        stats.lines_detected += int(summary[12])
        stats.line_matches += int(summary[13])
        stats.lines_alive = int(summary[14])
        stats.cylinders_live += int(summary[15])
        self._traj.append(frame.ts, summary[0:3], summary[3:7])
        if self._map_writer is not None and summary[9] > 0.5:   # n_evicted
            with profiling.span("map_export"):
                stats.map_streamed += append_dying_features(self._map_writer, frame.out)
        if self._on_frame is not None:
            # before the backend: a refine delays the frames after it, not its
            # own, whose copies it does not touch
            with profiling.span("on_frame"):
                self._on_frame(frame.i, frame.state, frame.out, dt)
        return self._backend is not None and self._backend.observe(
            frame.i, frame.ts, summary, frame.kf_obs, self._stats)

    def refine(self):
        self._backend.refine(self._stepper, self._traj, self._stats)

    def _add_stamps(self, i: int, stamps, uploaded: bool):
        """Add one replay's stamps (the path's ``profiling.stamps``, ns of the
        card's clock) to the device sums of ``RunStats``, each stage and nested
        section by its name (``profiling.sections``), and where the frame
        crossed from the host its upload.  A sequence's first
        frame gives the clock offset and is left out (its capture runs before)."""
        stats, stepper = self._stats, self._stepper
        if i == 0:
            before, after = stepper.clock_bracket
            stats.clock_offset_ns = int(stamps[stepper.offset_slot]) - (before + after) // 2
            stats.clock_offset_err_ns = (after - before + 1) // 2
        names = stepper.stamp_names
        times = [int(t) for t in stamps[:len(names)]]
        if uploaded:
            start, end = (int(stamps[k]) for k in stepper.upload_slots)
            stats.upload_device_us += 1e-3 * (end - start)
            stats.upload_frames += 1
        if self._last_stamp is not None:
            sums = stats.stage_device_us
            for stage, first, last in profiling.sections(names):
                sums[stage] = sums.get(stage, 0.0) + 1e-3 * (times[last] - times[first])
            stats.graph_span_us += 1e-3 * (times[-1] - times[0])
            stats.replay_gap_us += 1e-3 * (times[0] - self._last_stamp)
            stats.stamped_frames += 1
        self._last_stamp = times[-1]
        self._timer.device_stages(names[1:], stamps[:len(names)], stats.clock_offset_ns)


class _Backend:
    """The keyframe backend of a run (``run_frames``' ``ba_*``, ``kf_*`` and
    pose-graph options): the ``KeyframeWindow`` of the keyframes the motion
    gate selects, and with ``with_pose_graph`` a ``PoseGraph`` over their
    chain.  A keyframe's observation pack stays on the device until a refine."""

    def __init__(self, cam: CameraIntrinsics, device, every: int, window: int, iterations: int,
                 mesh, anchor_weights, min_trans_mm: float, min_rot_deg: float,
                 pose_graph: bool, update_map: bool, correct_traj: bool):
        self._cam, self._mesh, self._every, self._iterations = cam, mesh, every, iterations
        self._min_trans_mm, self._min_rot_deg = min_trans_mm, min_rot_deg
        self._update_map, self._correct_traj = update_map, correct_traj
        self._window = KeyframeWindow(max_keyframes=window, anchor_weights=anchor_weights,
                                      device=device)
        self._graph = PoseGraph(device=device) if pose_graph else None
        self._pending = []   # keyframe packs read by the host only when a refine needs them
        self._last_quat = self._last_pos = None

    def observe(self, i: int, ts: float, summary, kf_obs, stats: RunStats) -> bool:
        """The keyframe gate: a tracked frame that moved far enough from the
        last keyframe becomes one.  Returns whether a refine is due at it."""
        if not summary[7] > 0.5:   # success
            return False
        pos, quat = summary[0:3], summary[3:7]
        is_kf = self._last_quat is None
        if not is_kf:
            trans_mm = float(np.linalg.norm(pos - self._last_pos))
            dot = min(abs(float(np.dot(quat, self._last_quat))), 1.0)
            rot_deg = float(np.degrees(2.0 * np.arccos(dot)))
            is_kf = trans_mm >= self._min_trans_mm or rot_deg >= self._min_rot_deg
        if is_kf:
            stats.keyframe_count += 1
            self._last_quat, self._last_pos = quat, pos
            self._pending.append((quat, pos, *kf_obs, ts, i))
            if self._graph is not None:
                self._graph.add_keyframe(i, quat, pos)
        return self._window.n_keyframes + len(self._pending) >= 3 and (i + 1) % self._every == 0

    def refine(self, stepper, traj: Trajectory, stats: RunStats):
        """Refine the window; an accepted refinement corrects the live map and
        the trajectory, through the pose graph where there is one."""
        window, graph = self._window, self._graph
        with profiling.span("backend"):
            if self._pending:
                with profiling.span("backend.keyframes"):
                    # every waiting keyframe's pack in two reads
                    fobs = torch.stack([kf[2] for kf in self._pending]).cpu().numpy()
                    kf_fids = torch.stack([kf[3] for kf in self._pending]).cpu().numpy()
                    profiling.count("device_reads.keyframes", 2)
                    for (q_, p_, _, _, ts_, i_), fo_, fi_ in zip(self._pending, fobs, kf_fids):
                        window.add_keyframe_packed(q_, p_, fo_, fi_, timestamp=ts_, frame_id=i_)
                    self._pending.clear()
            t_ba = time.perf_counter()
            with profiling.span("backend.refine"):
                res = window.refine(self._cam, iterations=self._iterations, mesh=self._mesh)
            if res is None:
                return
            refined, device_lm, costs = res
            stats.ba_runs += 1
            dt_ba = time.perf_counter() - t_ba
            stats.ba_total_s += dt_ba
            if stats.ba_runs == 1:
                stats.ba_compile_s = dt_ba
            stats.ba_total_iters += self._iterations
            if np.isfinite(costs).all() and costs[-1] < costs[0]:
                stats.ba_accepted += 1
                if self._update_map:
                    with profiling.span("backend.apply"):
                        window.apply_refinement(refined, device_lm)
                        # the live state may be up to a group past the frame the
                        # refine was decided at: the scatter is guarded by feature id
                        stepper.state = _scatter_ba_landmarks(stepper.state, device_lm)
                if self._correct_traj and graph is None:
                    with profiling.span("backend.correct"):
                        for kf, fi in enumerate(window.frame_ids):
                            q, p = refined[kf]
                            traj.positions[fi] = np.asarray(p, np.float64)
                            traj.quaternions[fi] = np.asarray(q, np.float64)
                if graph is not None:
                    with profiling.span("backend.graph_solve"):
                        graph.add_ba_window(window.frame_ids[:len(refined)], refined)
                        t_graph = time.perf_counter()
                        solved = graph.solve()
                        dt_graph = time.perf_counter() - t_graph
                    stats.graph_solves += 1
                    stats.graph_total_s += dt_graph
                    if stats.graph_solves == 1:
                        stats.graph_first_s = dt_graph
                    if solved is not None:
                        with profiling.span("backend.correct"):
                            _apply_graph_correction(traj, *solved)
            stats.ba_dropped_landmarks = window.dropped_landmarks
            stats.ba_dropped_obs = window.dropped_obs
            moved = [window.transfers] + ([graph.transfers] if graph is not None else [])
            stats.backend_uploads = sum(t["uploads"] for t in moved)
            stats.backend_readbacks = sum(t["readbacks"] for t in moved)

    def close(self):
        self._window.close()
        if self._graph is not None:
            self._graph.close()


def run_frames(frames, cam: CameraIntrinsics, cfg: SlamConfig,
               with_planes: bool = True, with_lines: bool = False, seed: int = 0,
               state: engine.SlamState | None = None, on_frame=None,
               ba_every: int | None = None, ba_window: int = 8, ba_iterations: int = 8,
               ba_mesh=None, ba_anchor_weights: tuple | None = None,
               kf_min_trans_mm: float = 20.0, kf_min_rot_deg: float = 1.0,
               with_pose_graph: bool = True, ba_update_map: bool = True,
               ba_correct_traj: bool = True, camera_setup=None,
               export_map: str | None = None, device=None, trace=True):
    """Run the engine over an iterable of (gray, depth[, timestamp]) frames (numpy
    or tensors), on ``device`` (``None``: the card, see ``resolve_device``).

    On a card the step runs as one CUDA graph (``step_graph.StepGraph``),
    recorded at the first frame and freed at the end, and so do the backend's
    refine and graph solve (``solve_graph.SolveGraph``), each recorded at its
    first call; on the CPU all run eagerly.  What the loop keeps of a frame
    past the next one (its summary, a keyframe's observation record, and for
    ``on_frame`` or the map export its state and outputs) is copied out of the
    graph's buffers on the device.

    The loop keeps one step queued ahead of the frame it hands over: each
    frame's summary comes back to the host by an asynchronous copy, and frame
    ``i`` is processed (``on_frame(i, state, out, dt)``, then its keyframe gate)
    once step ``i + 1`` has been issued, with ``dt`` the host's time since the
    frame before was handed over; frame 0 is handed over before frame 1 is
    pulled.  The backend keeps the JAX runner's cadence (``SUMMARY_BATCH``): a
    refine decided at frame ``i`` waits until the step of the frame that closes
    ``i``'s group has been issued and its summary has come back, and the frames
    after ``i`` wait with it.  Frames that are tensors on ``device`` already
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

    ``trace`` (default on) records the run's trace into ``RunStats``: the
    host spans and counters of the loop and of the layers under it
    (``profiling``), and on a card the step graph's device stamps, which ride
    in each frame's summary.  ``False`` records nothing and leaves the
    stamps out of the graph.  A ``profiling.StageTimer`` records into that
    recorder (made with ``log=True``, it keeps the event log for its
    ``export``).

    Returns (final_state, Trajectory, RunStats)."""
    device = resolve_device(device)
    if ba_mesh is not None and dist.get_rank(ba_mesh) != 0:
        served = serve_refines(ba_mesh, cam, anchor_weights=ba_anchor_weights, device=device)
        return None, None, RunStats(ba_runs=served)
    timer = trace if isinstance(trace, profiling.StageTimer) else (
        profiling.StageTimer() if trace else None)
    stats, traj = RunStats(), Trajectory()
    with contextlib.ExitStack() as closing:
        if ba_mesh is not None:
            # whatever happens here, the other ranks stop serving at the end
            closing.callback(stop_serving, ba_mesh, device)
        if state is None:
            state = engine.init_state(cam, cfg, seed=seed, device=device,
                                      with_planes=with_planes)
        stepper = step_graph.stepper(state, cam, cfg, with_planes=with_planes,
                                     with_lines=with_lines)
        closing.callback(stepper.close)
        rectify = None
        if camera_setup is not None:
            ext = np.asarray(camera_setup.depth_to_rgb, np.float64)
            if not np.allclose(ext, np.eye(4)):
                rectify = functools.partial(
                    rectify_depth, depth_cam=camera_setup.depth, rgb_cam=cam,
                    depth_to_rgb_44=torch.tensor(ext, dtype=torch.float32, device=device))
        backend = None
        if ba_every:
            backend = _Backend(cam, device, ba_every, ba_window, ba_iterations, ba_mesh,
                               ba_anchor_weights, kf_min_trans_mm, kf_min_rot_deg,
                               with_pose_graph, ba_update_map, ba_correct_traj)
            closing.callback(backend.close)
        map_writer = (closing.enter_context(OBJWriter(export_map)) if export_map is not None
                      else None)
        consumer = _Consumer(stats, traj, stepper, timer, map_writer, on_frame, backend)
        handover = _HandOver(consumer, ba_every if backend is not None else None)
        if timer is not None:
            closing.enter_context(profiling.recording(timer))
        stamps, frames = None, iter(frames)
        for i in itertools.count():
            with profiling.span("frame.pull"):
                frame = next(frames, _END)
            if frame is _END:
                break
            gray, depth, ts = frame if len(frame) == 3 else (*frame, float(i))
            with profiling.span("frame.upload"):
                # on the card's queue, the upload between two stamps
                uploaded = stamps is not None and (_on_host(gray, device)
                                                   or _on_host(depth, device))
                if uploaded:
                    stamps_cuda.stamp(stamps, stepper.upload_slots[0])
                gray, depth = _upload(gray, device), _upload(depth, device)
                if rectify is not None:
                    depth = rectify(depth)
                if uploaded:
                    stamps_cuda.stamp(stamps, stepper.upload_slots[1])
            frame_state, out = stepper.step(gray, depth)
            if i == 0 and timer is not None:
                stamps = getattr(stepper, "stamps", None)
            with profiling.span("frame.pack"):
                kf_obs = (_pack_keyframe_obs(out, frame_state.points.pos)
                          if backend is not None else None)
                summary = handover.send(i, _pack_summary(out, stamps,
                                                         getattr(stepper, "cylinders_live", None)))
            if stepper.reuses_outputs:
                # the next replay overwrites both: keep copies where they are read
                frame_state, out = consumer.keep(frame_state, out)
            handover.issue(_Issued(i, ts, frame_state, out, kf_obs, uploaded, summary))
        handover.deliver(i - 1, end=True)   # i: the frames' count
        if map_writer is not None:
            with profiling.span("map_export"):
                stats.map_alive_at_end = append_alive_features(map_writer, stepper.state,
                                                               only_local=True)
    if timer is not None:
        stats.spans = timer.aggregates()
        stats.counters = dict(timer.counters)
    return stepper.state, traj, stats


def evaluate_against_ground_truth(traj: Trajectory, gt_positions_mm) -> dict:
    """ATE metrics for a run."""
    est = traj.positions_array()
    gt = np.asarray(gt_positions_mm, dtype=np.float64)
    n = min(len(est), len(gt))
    return {"ate_rmse_mm": ate_rmse(est[:n], gt[:n], align=True), "frames": n}
