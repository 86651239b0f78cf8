"""How ``runner.run_frames`` hands frames over: one step queued ahead of the
frame it delivers, with the backend at the JAX runner's cadence.

On the CPU:

* the order of events, from a stepper that logs each step it is asked for and
  an ``on_frame`` that logs each frame: frame 0 is handed over before step 1
  is issued, and frame ``i >= 1`` after step ``i + 1`` and before step
  ``i + 2``; with ``ba_every=4`` the refine decided at frame 3 waits for
  step 8, which closes its group, and its landmark write-back lands before
  step 9, as the batched runner's;
* a run whose ``ba_every`` is None or 0 makes no backend object;
* the port against the frozen batched runner of the benchmark's reference
  (``slambench/reference/plain/runner.py``), on a short planes-on orbit at the
  160x120 test camera: trajectory, final state and counts equal to the bit,
  with the backend off and at three cadences.

On the card (marked ``cuda``): 40 staged frames at 640x480, each handed over
before the source's pull of the frame two ahead; the host waits on the
summary's event for nearly every frame, and the run makes at most one host
sync.

This file imports no JAX, so that the card can run it (``--noconftest``).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from rgbd_slam_tpu_torch import config, profiling, runner, step_graph
from rgbd_slam_tpu_torch.synthetic import RoomScene, orbit_trajectory

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from slambench import check  # noqa: E402
from slambench import tracing as bench_tracing  # noqa: E402
from slambench.reference.plain import config as ref_config  # noqa: E402
from slambench.reference.plain import runner as ref_runner  # noqa: E402

torch.set_num_threads(2)

CAM = config.CameraIntrinsics(width=160, height=120, fx=130.0, fy=130.0, cx=80.0, cy=60.0)
CFG = config.SlamConfig(
    detection=config.DetectionConfig(optical_flow_pyramid_depth=2,
                                      optical_flow_coarse_window_px=13),
    mapping=config.MappingConfig(max_points_3d=128, max_points_2d=64, max_planes=8,
                                 max_lines=4, max_tracked_points=64),
    engine=config.EngineConfig(pose_covariance_mc_iterations=16, ransac_hypothesis_batch=16,
                               p3p_hypothesis_batch=8))
#: every orbit frame (6 mm apart) a keyframe
KEYFRAME_EVERY_FRAME = dict(kf_min_trans_mm=5.0)


@pytest.fixture(scope="module")
def orbit():
    scene = RoomScene(CAM)
    return [scene.render(q, p) for q, p in orbit_trajectory(12, speed_mm=6.0)]


def _order(frames, monkeypatch, **kw):
    """``run_frames`` over ``frames`` on the CPU with a log of the steps
    issued, the frames handed over and the landmark write-backs."""
    log = []

    class Spy(step_graph.EagerStep):
        def step(self, gray, depth):
            log.append(("step", sum(e[0] == "step" for e in log)))
            return super().step(gray, depth)

    real_scatter = runner._scatter_ba_landmarks

    def scatter(state, device_lm):
        log.append(("write_back", None))
        return real_scatter(state, device_lm)

    monkeypatch.setattr(step_graph, "stepper", Spy)
    monkeypatch.setattr(runner, "_scatter_ba_landmarks", scatter)
    _, _, stats = runner.run_frames(frames, CAM, CFG, device="cpu",
                                    on_frame=lambda i, *a: log.append(("on_frame", i)), **kw)
    return log, stats


@pytest.mark.parametrize("ba_every", [None, 8])
def test_each_frame_is_handed_over_one_step_behind(orbit, monkeypatch, ba_every):
    frames = orbit[:10]
    log, stats = _order(frames, monkeypatch, ba_every=ba_every, **KEYFRAME_EVERY_FRAME)
    at = {e: k for k, e in enumerate(log)}
    n = len(frames)
    assert stats.frame_count == n and sum(e[0] == "on_frame" for e in log) == n
    assert at[("on_frame", 0)] < at[("step", 1)]
    for i in range(1, n - 1):
        assert at[("step", i + 1)] < at[("on_frame", i)], i
        if i + 2 < n:
            assert at[("on_frame", i)] < at[("step", i + 2)], i
    assert log[-1] == ("on_frame", n - 1)
    if ba_every:
        # the refine decided at frame 7 writes back after step 8, before step 9
        assert stats.ba_runs == stats.ba_accepted == 1
        assert at[("step", 8)] < at[("write_back", None)] < at[("step", 9)]


def test_a_refine_waits_for_the_step_that_closes_its_group(orbit, monkeypatch):
    """``ba_every=4``: the refine decided at frame 3 runs once step 8 is
    issued, and writes back before step 9, as the refine decided at frame 7
    does; frame 3 is handed over on time, before the hold, and frames 4-7
    wait with the refine."""
    frames = orbit[:10]
    log, stats = _order(frames, monkeypatch, ba_every=4, **KEYFRAME_EVERY_FRAME)
    at = {e: k for k, e in enumerate(log)}
    assert stats.ba_runs == stats.ba_accepted == 2
    writes = [k for k, e in enumerate(log) if e[0] == "write_back"]
    assert len(writes) == 2
    assert at[("step", 8)] < writes[0] < writes[1] < at[("step", 9)]
    assert at[("step", 4)] < at[("on_frame", 3)] < at[("step", 5)]
    for i in range(4, 8):
        assert writes[0] < at[("on_frame", i)] < at[("step", 9)], i
    assert at[("step", 9)] < at[("on_frame", 8)]


@pytest.mark.parametrize("ba_every, backends", [(None, 0), (0, 0), (8, 1)])
def test_a_run_without_a_cadence_makes_no_backend(orbit, monkeypatch, ba_every, backends):
    made = []

    class Counted(runner._Backend):
        def __init__(self, *args, **kw):
            made.append(self)
            super().__init__(*args, **kw)

    monkeypatch.setattr(runner, "_Backend", Counted)
    _, traj, stats = runner.run_frames(orbit[:3], CAM, CFG, device="cpu", ba_every=ba_every)
    assert len(made) == backends and stats.frame_count == len(traj.positions) == 3


@pytest.mark.parametrize("ba_every", [None, 3, 4, 8])
def test_the_port_equals_the_frozen_batched_runner(orbit, ba_every):
    """The frozen batched runner reads the summaries in blocking batches of 8;
    the port hands each frame over one step behind.  Both refine at the same
    points of the sequence, so everything is equal to the bit.  At 12 frames
    the refines at 3 and 7 (``ba_every=4``) wait for frame 8; at 2, 5 and 8
    (``ba_every=3``) too, frame 8 being the frame that closes its group; the
    refine at 11 closes with the sequence; ``ba_every=8`` refines at 7."""
    kw = dict(ba_every=ba_every, **KEYFRAME_EVERY_FRAME)
    state, traj, stats = runner.run_frames(orbit, CAM, CFG, device="cpu", **kw)
    ref_state, ref_traj, ref_stats = ref_runner.run_frames(
        orbit, ref_config.CameraIntrinsics(**dataclasses.asdict(CAM)),
        check.build_dataclass(ref_config.SlamConfig, dataclasses.asdict(CFG)),
        device="cpu", **kw)
    if ba_every:
        assert stats.ba_runs >= 1 and stats.ba_accepted >= 1
    for key in ("frame_count", "success_count", "lost_count", "keyframe_count", "ba_runs",
                "ba_accepted"):
        assert getattr(stats, key) == getattr(ref_stats, key), key
    np.testing.assert_array_equal(traj.positions_array(), ref_traj.positions_array())
    np.testing.assert_array_equal(np.array(traj.quaternions), np.array(ref_traj.quaternions))
    assert state._fields == ref_state._fields
    leaves, ref_leaves = step_graph.tensor_leaves(state), step_graph.tensor_leaves(ref_state)
    assert len(leaves) == len(ref_leaves)
    for k, (a, b) in enumerate(zip(leaves, ref_leaves)):
        assert a.dtype == b.dtype and torch.equal(a.nan_to_num(), b.nan_to_num()), k
    assert torch.equal(state.generator.get_state(), ref_state.generator.get_state())


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the step graph and the summary's event")
    return torch.device("cuda")


@pytest.mark.cuda
def test_each_frame_is_handed_over_one_replay_behind_on_the_card(cuda):
    """40 frames staged on the card: ``on_frame(i)`` (i >= 1) runs after the
    source's pull of frame ``i + 1`` and before its pull of frame ``i + 2``;
    the host runs ahead of the card, so it waits on the summary's event for
    at least 90% of the frames past the first (``summary_waits``); the run
    makes at most one host sync (after a first run that builds the kernels and
    makes the libraries' handles, as the benchmark's warm-up does)."""
    cam, cfg = config.TUM_FR1, config.SlamConfig()
    scene = RoomScene(cam, depth_noise=config.DepthNoiseModel())
    n = 40
    frames = runner.stage_frames([scene.render(q, p) for q, p in
                                  orbit_trajectory(n, speed_mm=4.0)], device=cuda)
    runner.run_frames(frames[:3], cam, cfg, device=cuda, on_frame=lambda *a: None)
    torch.cuda.synchronize()
    log = []

    def source():
        for k, frame in enumerate(frames):
            log.append(("pull", k))
            yield frame

    with bench_tracing.SyncCounter() as sync:
        _, traj, stats = runner.run_frames(
            source(), cam, cfg, device=cuda, trace=profiling.StageTimer(),
            on_frame=lambda i, *a: log.append(("on_frame", i)))
    at = {e: k for k, e in enumerate(log)}
    assert stats.frame_count == n and len(traj.positions) == n
    assert at[("on_frame", 0)] < at[("pull", 1)]
    for i in range(1, n):
        if i + 1 < n:
            assert at[("pull", i + 1)] < at[("on_frame", i)], i
        if i + 2 < n:
            assert at[("on_frame", i)] < at[("pull", i + 2)], i
    assert stats.counters.get("summary_waits", 0) >= 0.9 * (n - 1), stats.counters
    assert sync.count <= 1, sync.count
    assert stats.stamped_frames == n - 1
