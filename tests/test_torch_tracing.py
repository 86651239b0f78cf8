"""The run's trace: the recorder (``profiling.StageTimer``: nested spans, self
time, counters, profiler ranges, the event log and its Chrome export), the
step's stamp hooks (``profiling.stamp`` in ``engine.step``), the runner's
aggregates in ``RunStats`` from summaries that carry stamps, the benchmark's
readers of them, and the CLI's ``--trace-out``.  The card tests (marked
``cuda``) hold the stamped step graph to the unstamped one to the bit.

This file imports no JAX, so that the card can run it (``--noconftest``).
"""

import dataclasses
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from rgbd_slam_tpu_torch import cli, config, engine, profiling, runner, step_graph
from rgbd_slam_tpu_torch.ops import cylinders_cuda, stamps_cuda
from rgbd_slam_tpu_torch.synthetic import (RoomScene, StripeWallScene, lateral_trajectory,
                                           orbit_trajectory)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402
from slambench import registry  # noqa: E402

torch.set_num_threads(2)

CAM = config.CameraIntrinsics(width=160, height=120, fx=130.0, fy=130.0, cx=80.0, cy=60.0)
CFG = config.SlamConfig(
    detection=config.DetectionConfig(optical_flow_pyramid_depth=2,
                                      optical_flow_coarse_window_px=13),
    mapping=config.MappingConfig(max_points_3d=128, max_points_2d=64, max_planes=8,
                                 max_lines=4, max_tracked_points=64),
    engine=config.EngineConfig(pose_covariance_mc_iterations=16, ransac_hypothesis_batch=16,
                               p3p_hypothesis_batch=8))
#: the four on/off paths of planes and lines
PATHS = [(True, False), (False, False), (True, True), (False, True)]
PATH_IDS = ["planes", "points", "lines", "points_lines"]
#: the readers this trace feeds, and what each reads of ``RunStats``
STAGE_READERS = {f"graph_{s}_us": s for s in profiling.STAGES}
READERS = ["graph_span_us", "replay_gap_us", *STAGE_READERS, "upload_us", "backend_us"]


@pytest.fixture(scope="module")
def frames():
    scene = RoomScene(CAM)
    return [scene.render(q, p) for q, p in orbit_trajectory(5, speed_mm=8.0)]


@pytest.fixture
def clock(monkeypatch):
    """``perf_counter_ns`` as the recorder reads it: each read takes the next
    of the numbers the test appends."""
    ticks = []
    monkeypatch.setattr(profiling.time, "perf_counter_ns", lambda: ticks.pop(0))
    return ticks


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def test_spans_nest_with_self_time_and_the_longest(clock):
    timer = profiling.StageTimer(log=True)
    # outer [0, 100] holds inner [10, 30] and inner [40, 90]; a second outer [200, 210]
    clock.extend([0, 10, 30, 40, 90, 100, 200, 210])
    with timer.stage("outer"):
        with timer.stage("inner"):
            pass
        with timer.stage("inner"):
            pass
    with timer.stage("outer"):
        pass
    agg = timer.aggregates()
    assert agg["outer"]["count"] == 2 and agg["inner"]["count"] == 2
    assert agg["outer"]["total_s"] == pytest.approx(110e-9)
    assert agg["outer"]["self_s"] == pytest.approx(40e-9)
    assert agg["outer"]["max_s"] == pytest.approx(100e-9)
    assert agg["inner"]["total_s"] == agg["inner"]["self_s"] == pytest.approx(70e-9)
    assert agg["inner"]["max_s"] == pytest.approx(50e-9)
    assert [e[1:] for e in timer.events] == [
        ("inner", 10, 30, "outer"), ("inner", 40, 90, "outer"), ("outer", 0, 100, None),
        ("outer", 200, 210, None)]
    # the reference's report reads the spans as it reads ``record``
    assert timer.counts == {"outer": 2, "inner": 2}
    assert "outer" in timer.show_statistics(frame_count=2)


def test_a_span_that_raises_is_recorded_and_closed(clock):
    timer = profiling.StageTimer()
    clock.extend([0, 5, 7, 9])
    with pytest.raises(RuntimeError):
        with timer.stage("outer"):
            with timer.stage("fails"):
                raise RuntimeError("inside")
    assert timer.counts == {"outer": 1, "fails": 1} and timer._open == []
    assert timer.aggregates()["outer"]["self_s"] == pytest.approx(7e-9)


def test_counters_and_the_bounded_event_log(clock, monkeypatch):
    monkeypatch.setattr(profiling, "LOG_LIMIT", 3)
    timer = profiling.StageTimer(log=True)
    clock.extend([1, 2, 3, 4])
    timer.count("uploads")
    timer.count("clone_bytes", 4096)
    timer.count("uploads")
    timer.count("clone_bytes", 4096)
    assert timer.counters == {"uploads": 2, "clone_bytes": 8192}
    assert timer.events == [("counter", "uploads", 1, 1), ("counter", "clone_bytes", 2, 4096),
                            ("counter", "uploads", 3, 2)]
    assert timer.dropped == 1
    plain = profiling.StageTimer()
    plain.count("uploads")
    assert plain.events is None and plain.counters == {"uploads": 1}


def test_profiler_ranges_only_under_the_profiler(monkeypatch, tmp_path):
    opened = []
    real = profiling._range

    def watched(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(profiling, "_range", watched)
    timer = profiling.StageTimer()
    with timer.stage("step.replay"):
        torch.ones(4).sum()
    assert opened == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timer.stage("step.replay"):
            torch.ones(4).sum()
    assert opened == ["step.replay"]
    assert any(e.name == "step.replay" for e in prof.events())
    # an operation's range, not a user annotation (which the profiler copies
    # onto the device's timeline)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    cats = {e.get("cat") for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
            if e.get("name") == "step.replay"}
    assert cats == {"cpu_op"}
    assert timer.counts["step.replay"] == 2


def test_the_module_hooks_do_nothing_without_a_recorder(monkeypatch):
    monkeypatch.setattr(stamps_cuda, "stamp", _refuse)
    assert profiling.active() is None
    with profiling.span("frame.pull") as s:
        assert s is None
    profiling.count("uploads")
    profiling.stamp("start")
    timer = profiling.StageTimer()
    with profiling.recording(timer):
        assert profiling.active() is timer
        with profiling.span("frame.pull"):
            profiling.count("uploads")
        profiling.stamp("start")      # a recorder, but no capture
    assert profiling.active() is None
    assert timer.counts == {"frame.pull": 1} and timer.counters == {"uploads": 1}


def _refuse(*_args, **_kw):
    raise AssertionError("a stamp launched outside a capture")


def test_export_is_chrome_json_with_the_offset_applied(clock, tmp_path):
    timer = profiling.StageTimer(log=True)
    clock.extend([1_000, 1_500, 2_000])
    with timer.stage("deliver"):
        timer.count("summary_waits")
    # the card's clock 10 s ahead of the host's
    offset = 10_000_000_000
    stamps = offset + np.array([1_100, 1_200, 1_250, 1_300, 1_400, 1_500, 1_600, 1_700,
                                1_800, 1_900])
    timer.device_stages(profiling.STAGES, stamps, offset)
    path = tmp_path / "trace.json"
    timer.export(str(path))
    trace = json.loads(path.read_text())
    events = trace["traceEvents"]
    spans = [e for e in events if e["ph"] == "X" and e["tid"] == 1]
    device = [e for e in events if e["ph"] == "X" and e["tid"] == 2]
    counters = [e for e in events if e["ph"] == "C"]
    assert spans == [{"name": "deliver", "ph": "X", "pid": 1, "tid": 1, "ts": 1.0, "dur": 1.0,
                      "args": {"parent": None}}]
    assert [e["name"] for e in device] == list(profiling.STAGES)
    assert device[0]["ts"] == pytest.approx(1.1) and device[0]["dur"] == pytest.approx(0.1)
    assert device[-1]["ts"] + device[-1]["dur"] == pytest.approx(1.9)
    assert counters == [{"name": "summary_waits", "ph": "C", "pid": 1, "ts": 1.5,
                         "args": {"summary_waits": 1}}]
    assert trace["otherData"] == {"dropped": 0}
    assert {e["args"]["name"] for e in events if e["ph"] == "M"} >= {"host"}
    with pytest.raises(ValueError, match="log=True"):
        profiling.StageTimer().export(str(path))


@pytest.mark.parametrize("second_start, frames, found", [
    (2_000, 2, False), (1_050, 2, True), (2_000, 3, True)],
    ids=["in_order", "out_of_order", "a_replay_missing"])
def test_the_smoke_test_holds_the_logged_replays_in_order(clock, second_start, frames,
                                                          found):
    """``chip_smoke.py``'s check of the event log reads each device entry's
    stamps, not its stage names: a replay whose first stamp lies before the
    last of the replay before, or a frame with no replay, is a problem."""
    timer = profiling.StageTimer(log=True)
    stages = profiling.stages(True, False)
    for start in (1_000, second_start):
        timer.device_stages(stages, start + 10 * np.arange(len(stages) + 1), 0)
    assert bool(chip_smoke.replay_order_problems(timer.events, frames)) is found


# ---------------------------------------------------------------------------
# the step's stamp hooks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_planes, with_lines", PATHS, ids=PATH_IDS)
def test_the_step_stamps_each_stage_in_order(frames, with_planes, with_lines, monkeypatch):
    """Under a capture's stamper, ``engine.step`` calls the hook at the start
    and at the end of each of its stages, in the order of the path's
    ``profiling.stamps`` (``commit`` is ``StepGraph._commit``'s); outside one
    it launches no stamp."""
    monkeypatch.setattr(stamps_cuda, "stamp", _refuse)
    state = engine.init_state(CAM, CFG, seed=0, device="cpu")
    called = []
    with profiling.stamping(called.append):
        state, _ = engine.step(state, *map(torch.as_tensor, frames[0]), CAM, CFG,
                               with_planes=with_planes, with_lines=with_lines)
    assert tuple(called) == profiling.stamps(with_lines, with_planes)[:-1]
    with profiling.recording(profiling.StageTimer()):
        engine.step(state, *map(torch.as_tensor, frames[1]), CAM, CFG,
                    with_planes=with_planes, with_lines=with_lines)
    assert len(called) == len(profiling.stamps(with_lines, with_planes)) - 1


#: the stamps and the offset slot of the tree before the line sections: the
#: path with lines and planes off keeps them
LINES_OFF_STAMPS = ("start", "flow", "detect", "associate", "plane_extract", "pose_opt",
                    "map_update", "insert", "next_track", "commit")
LINES_OFF_OFFSET_SLOT = 10
#: the planes path's nested section: its start and its end, before ``plane_extract``
CYLINDER_STAMPS = ("cylinders.start", "cylinders")


@pytest.mark.parametrize("with_planes, with_lines", PATHS, ids=PATH_IDS)
def test_each_path_has_its_stage_list_and_stamp_slots(with_planes, with_lines):
    """A path's stamps are its start and its stages; with lines off they are
    the stamps of the tree before the line sections, and with lines on the
    two line sections follow ``associate``; with planes on the cylinder
    section's two stamps come before ``plane_extract``, and its stage list
    holds ``cylinders`` there.  The stamp buffer's offset slot and its two
    upload slots follow the path's stamps."""
    names = profiling.stamps(with_lines, with_planes)
    stages = profiling.stages(with_lines, with_planes)
    assert tuple(n for n in names if not n.endswith(".start")) == ("start",) + stages
    want = LINES_OFF_STAMPS
    if with_lines:
        want = want[:4] + ("line_tiles", "lines") + want[4:]
    if with_planes:
        k = want.index("plane_extract")
        want = want[:k] + CYLINDER_STAMPS + want[k:]
    assert names == want
    if not with_lines and not with_planes:
        assert stages == profiling.STAGES
    offset, upload = step_graph.stamp_slots(with_lines, with_planes)
    assert offset == len(names) and upload == (offset + 1, offset + 2)
    if not with_lines:
        assert offset == LINES_OFF_OFFSET_SLOT + 2 * with_planes


def test_stamps_cuda_takes_an_int64_buffer_on_a_card_only():
    with pytest.raises(ValueError, match="int64"):
        stamps_cuda.stamp(torch.zeros(11, dtype=torch.int64), 0)
    with pytest.raises(ValueError, match="int64"):
        stamps_cuda.stamp(torch.zeros(11, dtype=torch.float32), 0)


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def test_trace_false_records_nothing(frames):
    _, traj_on, on = runner.run_frames(frames, CAM, CFG, with_planes=False, device="cpu")
    _, traj_off, off = runner.run_frames(frames, CAM, CFG, with_planes=False, device="cpu",
                                         trace=False)
    np.testing.assert_array_equal(traj_on.positions_array(), traj_off.positions_array())
    assert off.spans == {} and off.counters == {} and off.stage_device_us == {}
    assert off.graph_span_us == off.replay_gap_us == 0.0 and off.stamped_frames == 0
    # on the CPU the step is eager: spans and counters, no stamps
    assert on.stage_device_us == {} and on.stamped_frames == 0
    # a frame, a refine, a solve and a backend read are counted in RunStats'
    # own fields, not again among the counters; frames on the CPU upload nothing,
    # and their summaries are on the host already, so no frame waits for one
    assert on.counters == {} and on.frame_count == 5
    assert on.upload_frames == 0 and on.upload_device_us == 0.0
    for name in ("frame.pull", "frame.upload", "frame.pack", "deliver", "deliver.wait",
                 "deliver.process"):
        assert on.spans[name]["count"] == {"frame.pull": 6}.get(name, 5), name
    assert on.spans["deliver"]["self_s"] <= on.spans["deliver"]["total_s"]
    assert json.dumps(dataclasses.asdict(on))     # the CLI's report takes it as it is


class StampedStep(step_graph.EagerStep):
    """``engine.step`` with a stamp buffer as ``StepGraph`` keeps it: each step
    writes the path's stamps as made-up card times (frame ``f`` starts at ``T0
    + 10,000 f`` ns, its stages take ``STAGE_NS``, and with lines on the two
    line stages ``LINE_NS`` after ``associate``) and the offset slot the stamp
    between ``clock_bracket``'s reads; the step's outputs are overwritten at
    every frame, as a replay overwrites them."""

    T0 = 5_000_000_000_000
    STAGE_NS = np.array([100, 200, 300, 400, 500, 600, 700, 800, 900])
    LINE_NS = np.array([1_000, 1_100])
    reuses_outputs = True

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        with_planes, with_lines = self._args[2:]
        self.stamp_names = profiling.stamps(with_lines, with_planes)
        self.offset_slot, self.upload_slots = step_graph.stamp_slots(with_lines, with_planes)
        self.stage_ns = self.stage_times(with_lines)
        self.stamps = torch.zeros(self.upload_slots[-1] + 1, dtype=torch.int64)
        self.clock_bracket = (1_000, 1_400)
        self.stamps[self.offset_slot] = self.T0 - 777
        self.frame = 0

    @classmethod
    def stage_times(cls, with_lines):
        """{stage: ns} of the path, in its order."""
        times = dict(zip(profiling.STAGES, cls.STAGE_NS.tolist()))
        if with_lines:
            times.update(zip(profiling.LINE_STAGES, cls.LINE_NS.tolist()))
        return {s: times[s] for s in profiling.stages(with_lines, False)}

    def step(self, gray, depth):
        start = self.T0 + 10_000 * self.frame
        times = np.concatenate([[start], start + np.cumsum(list(self.stage_ns.values()))])
        self.stamps[:len(times)] = torch.from_numpy(times)
        self.frame += 1
        state, out = super().step(gray, depth)
        return step_graph.clone_tree(state), step_graph.clone_tree(out)


@pytest.mark.parametrize("with_lines", [False, True], ids=["lines_off", "lines_on"])
def test_run_stats_from_summaries_that_carry_stamps(frames, monkeypatch, tmp_path,
                                                    with_lines):
    """The stamps ride in the summary rows as float32 bit patterns; the runner
    sums the path's stages by name and the replay's span and gap over the
    frames past the first, and takes the clock offset from the first frame's
    row; the Chrome export names every stage of the path."""
    monkeypatch.setattr(step_graph, "stepper", StampedStep)
    timer = profiling.StageTimer(log=True)
    _, traj, stats = runner.run_frames(frames, CAM, CFG, with_planes=False,
                                       with_lines=with_lines, device="cpu", trace=timer,
                                       on_frame=lambda *a: None)
    n = len(frames) - 1
    stage_ns = StampedStep.stage_times(with_lines)
    assert stats.stamped_frames == n
    assert stats.stage_device_us == {s: pytest.approx(1e-3 * ns * n)
                                     for s, ns in stage_ns.items()}
    assert list(stats.stage_device_us) == list(profiling.stages(with_lines, False))
    span = sum(stage_ns.values())
    assert stats.graph_span_us == pytest.approx(1e-3 * span * n)
    assert sum(stats.stage_device_us.values()) == pytest.approx(stats.graph_span_us)
    assert stats.replay_gap_us == pytest.approx(1e-3 * (10_000 - span) * n)
    assert stats.clock_offset_ns == StampedStep.T0 - 777 - 1_200
    assert stats.clock_offset_err_ns == 200
    assert stats.counters["clone_bytes"] > 0 and len(traj.positions) == len(frames)
    path = tmp_path / "trace.json"
    timer.export(str(path))
    device = [e for e in json.loads(path.read_text())["traceEvents"]
              if e["ph"] == "X" and e["tid"] == 2]
    assert [e["name"] for e in device] == list(profiling.stages(with_lines, False)) \
        * len(frames)
    # on the host clock: the card's stamp less the offset, in µs
    assert device[0]["ts"] == pytest.approx(1e-3 * (StampedStep.T0 - stats.clock_offset_ns))


def test_summary_rows_keep_every_ns_of_the_stamps():
    """A stamp's int64 goes through the float32 summary as its bit pattern:
    patterns that read as NaN or denormal floats come back exact."""
    stamps = torch.tensor([0x7FC0_0001_7F80_0001, 1, -2, 0x0000_0001_FFFF_FFFF,
                           1_760_000_000_123_456_789], dtype=torch.int64)
    out = types.SimpleNamespace(position=torch.ones(3), quat=torch.ones(4),
                                success=torch.tensor(True), is_lost=torch.tensor(False),
                                n_evicted=torch.tensor(3), n_plane_merge_dropped=torch.tensor(0),
                                n_point_inliers=torch.tensor(42), n_lines=torch.tensor(7),
                                n_line_matches=torch.tensor(5), n_lines_alive=torch.tensor(9))
    summary, got = runner._split_summary(runner._pack_summary(out, stamps).numpy())
    np.testing.assert_array_equal(got, stamps.numpy())
    assert summary.shape == (runner.SUMMARY_WIDTH,) and summary[11] == 42.0
    # the line counts, then the step's live cylinder slots (none given: 0)
    assert list(summary[12:]) == [7.0, 5.0, 9.0, 0.0]
    plain, none = runner._split_summary(runner._pack_summary(out).numpy())
    assert none is None and np.array_equal(plain, summary)


def test_a_frame_from_the_host_is_stamped_around_its_upload(frames, monkeypatch):
    """A frame that crosses from the host is uploaded between two stamps into
    ``UPLOAD_SLOTS``, which ride in its summary row: the runner sums their
    stretch over the uploaded frames past the first (the first frame's
    upload comes before the capture, which makes the stamp buffer)."""
    holder = {}

    class Stepper(StampedStep):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            holder["step"] = self

    def fake_stamp(slots, slot):
        # 300 ns and 100 ns before the start of the step that follows
        start = StampedStep.T0 + 10_000 * holder["step"].frame
        slots[slot] = start - (300 if slot == step_graph.stamp_slots(False, False)[1][0]
                               else 100)

    monkeypatch.setattr(step_graph, "stepper", Stepper)
    monkeypatch.setattr(runner, "_on_host", lambda x, device: True)
    monkeypatch.setattr(stamps_cuda, "stamp", fake_stamp)
    _, _, stats = runner.run_frames(frames, CAM, CFG, with_planes=False, device="cpu")
    assert stats.upload_frames == stats.stamped_frames == len(frames) - 1
    assert stats.upload_device_us == pytest.approx(0.2 * (len(frames) - 1))
    assert stats.counters["uploads"] == 2 * len(frames)
    # the upload lies inside the gap between two replays
    assert stats.replay_gap_us > stats.upload_device_us


class NestedStampedStep(step_graph.EagerStep):
    """``engine.step`` with the planes path's stamps as ``StepGraph`` keeps
    them: each stamp at ``T0 + 10,000 f + OFFSETS[name]`` ns in frame ``f``,
    the cylinder section's two inside ``plane_extract``."""

    T0 = 7_000_000_000_000
    OFFSETS = {"start": 0, "flow": 100, "detect": 300, "associate": 600,
               "cylinders.start": 700, "cylinders": 730, "plane_extract": 1_000,
               "pose_opt": 1_500, "map_update": 2_100, "insert": 2_800,
               "next_track": 3_600, "commit": 4_500}
    reuses_outputs = True

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.stamp_names = profiling.stamps(False, True)
        self.offset_slot, self.upload_slots = step_graph.stamp_slots(False, True)
        self.stamps = torch.zeros(self.upload_slots[-1] + 1, dtype=torch.int64)
        self.clock_bracket = (1_000, 1_400)
        self.frame = 0

    def step(self, gray, depth):
        start = self.T0 + 10_000 * self.frame
        self.stamps[:len(self.stamp_names)] = torch.tensor(
            [start + self.OFFSETS[n] for n in self.stamp_names])
        self.frame += 1
        state, out = super().step(gray, depth)
        return step_graph.clone_tree(state), step_graph.clone_tree(out)


def test_the_planes_path_nests_the_cylinder_section_in_plane_extract(frames, monkeypatch):
    """On the planes path the replay's stamps hold the cylinder section's
    start and end; ``stage_device_us["cylinders"]`` sums the section alone and
    ``stage_device_us["plane_extract"]`` still runs from the ``associate``
    stamp to its own, the section included; the stages without the nested
    section add up to the span."""
    monkeypatch.setattr(step_graph, "stepper", NestedStampedStep)
    names = profiling.stamps(False, True)
    assert names.index("cylinders.start") == names.index("associate") + 1
    assert names.index("cylinders") + 1 == names.index("plane_extract")
    _, _, stats = runner.run_frames(frames, CAM, CFG, device="cpu", on_frame=lambda *a: None)
    n = len(frames) - 1
    at = NestedStampedStep.OFFSETS
    assert stats.stamped_frames == n
    assert list(stats.stage_device_us) == list(profiling.stages(False, True))
    assert stats.stage_device_us["cylinders"] == pytest.approx(1e-3 * 30 * n)
    assert stats.stage_device_us["plane_extract"] == pytest.approx(
        1e-3 * (at["plane_extract"] - at["associate"]) * n)
    outer = {k: v for k, v in stats.stage_device_us.items() if k != "cylinders"}
    assert sum(outer.values()) == pytest.approx(stats.graph_span_us)
    assert stats.graph_span_us == pytest.approx(1e-3 * at["commit"] * n)


def test_run_stats_sum_the_live_cylinder_slots_from_the_summary(frames, monkeypatch):
    """The cylinder stage's selected slots of each frame (``profiling.count_cylinders``
    in ``find_primitives``) ride in the frame's summary row, and ``RunStats``
    sums them over the frames: on the planes path the stage's own counts, on
    the points path 0."""
    counted = []
    stage = cylinders_cuda.cylinder_stage

    def spy(grid, member, try_cyl, cfg, min_activated):
        # every region with cells a candidate, so that slots are taken
        out = stage(grid, member, member.any(dim=-1), cfg, min_activated)
        counted.append(int(out.selected.sum()))
        return out

    monkeypatch.setattr(cylinders_cuda, "cylinder_stage", spy)
    _, _, stats = runner.run_frames(frames, CAM, CFG, device="cpu")
    assert len(counted) == len(frames) and sum(counted) > 0
    assert stats.cylinders_live == sum(counted)
    _, _, points = runner.run_frames(frames, CAM, CFG, with_planes=False, device="cpu")
    assert points.cylinders_live == 0
    # the count is the summary's entry after the line counts
    state = engine.init_state(CAM, CFG, seed=0, device="cpu")
    stepper = step_graph.EagerStep(state, CAM, CFG)
    _, out = stepper.step(*map(torch.as_tensor, frames[0]))
    row = runner._pack_summary(out, None, stepper.cylinders_live).numpy()
    assert row[15] == counted[-1] == int(stepper.cylinders_live)


def test_program_trace_skips_the_sequences_the_harness_profiles():
    """``program_trace.PROFILED`` copies the indexes ``harness._window`` gives
    its two profilers and leaves out of its untraced frames."""
    import inspect

    from slambench import harness, program_trace

    source = inspect.getsource(harness._window)
    first, second = program_trace.PROFILED
    assert f"{{{first}: (profiler, PROFILE_FRAMES), {second}: (idle, IDLE_FRAMES)}}" in source
    assert f"if k not in ({first}, {second})" in source


# ---------------------------------------------------------------------------
# the benchmark's readers
# ---------------------------------------------------------------------------

def _stats(k: int):
    """A sequence's ``RunStats`` with sums that name its index ``k``."""
    return runner.RunStats(
        frame_count=10, stamped_frames=9, graph_span_us=9 * (1000.0 + k),
        replay_gap_us=9 * (100.0 + k),
        stage_device_us={s: 9 * (10.0 * (j + 1) + k) for j, s in enumerate(profiling.STAGES)},
        upload_frames=8, upload_device_us=8 * (50.0 + k),
        spans={"backend": {"count": 1, "total_s": 1e-6 * 10 * (300.0 + k), "self_s": 0.0,
                           "max_s": 0.0}})


def _run(ks):
    return types.SimpleNamespace(sequences=[types.SimpleNamespace(stats=_stats(k))
                                            for k in ks])


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_the_unprofiled_sequences(name):
    """Sequences 1 and 2 of the window ran under the profiler: every reader
    leaves them out (their index would move the mean)."""
    base = {"graph_span_us": 1000.0, "replay_gap_us": 100.0, "upload_us": 50.0,
            "backend_us": 300.0}
    base.update({f"graph_{s}_us": 10.0 * (j + 1) for j, s in enumerate(profiling.STAGES)})
    reader = registry.load_reader(ROOT, name)
    assert reader.NEEDS == ()
    # sequences 0, 3 and 4 are read: their k average to 7/3
    assert reader.read(_run([0, 500, 900, 3, 4])) == pytest.approx(base[name] + 7.0 / 3.0)
    assert reader.read(_run([2])) == pytest.approx(base[name] + 2.0)


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_nothing_where_the_program_records_nothing(name):
    """A program without the trace (no such ``RunStats`` fields), or a run
    with ``trace=False``: None, and no raise."""
    bare = types.SimpleNamespace(frame_count=10)
    reader = registry.load_reader(ROOT, name)
    assert reader.read(types.SimpleNamespace(
        sequences=[types.SimpleNamespace(stats=bare)] * 4)) is None
    assert reader.read(types.SimpleNamespace(
        sequences=[types.SimpleNamespace(stats=runner.RunStats(frame_count=10))] * 4)) is None


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_trace_out_writes_a_chrome_trace(tmp_path, capsys):
    poses = lateral_trajectory(3, speed_mm=4.0)
    scene = RoomScene(CAM)
    dataset, yaml = chip_smoke.write_tum_directory(
        str(tmp_path), CAM, [scene.render(q, p)[0] for q, p in poses], poses)
    path = tmp_path / "trace.json"
    assert cli.main(["-d", dataset, "--camera-yaml", yaml, "--device", "cpu", "--no-planes",
                     "--trace-out", str(path)]) == 0
    assert f"trace -> {path}" in capsys.readouterr().out
    events = json.loads(path.read_text())["traceEvents"]
    names = {e["name"] for e in events if e["ph"] == "X"}
    assert {"frame.pull", "frame.upload", "frame.pack", "deliver", "deliver.wait"} <= names
    assert sum(e["name"] == "frame.upload" for e in events) == 3
    assert sum(e["name"] == "deliver" for e in events) == 3
    # the CPU's summaries are on the host already: no frame waits for one
    assert not [e for e in events if e["name"] == "summary_waits"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the stamp kernel has no CPU mode")
    return torch.device("cuda")


def _room_frames(n, device):
    cam = config.TUM_FR1
    scene = RoomScene(cam, depth_noise=config.DepthNoiseModel())
    return [tuple(torch.as_tensor(a, device=device) for a in scene.render(q, p))
            for q, p in orbit_trajectory(n, speed_mm=4.0)]


def _leaves_equal(a, b, what):
    for k, (x, y) in enumerate(zip(step_graph.tensor_leaves(a), step_graph.tensor_leaves(b),
                                   strict=True)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{what}: leaf {k}"


@pytest.mark.cuda
def test_stamps_change_no_bit_of_the_step(cuda):
    """30 frames at 640x480 through a step graph recorded with stamps (a
    recorder active) and one without: every leaf of the state and of the
    outputs equal to the bit at every frame; twelve stamps a replay (the
    cylinder section's two among them), in order."""
    cam, cfg = config.TUM_FR1, config.SlamConfig()
    frames = _room_frames(30, cuda)
    plain = step_graph.StepGraph(engine.init_state(cam, cfg, seed=0, device=cuda), cam, cfg)
    stamped = step_graph.StepGraph(engine.init_state(cam, cfg, seed=0, device=cuda), cam, cfg)
    try:
        for i, (gray, depth) in enumerate(frames):
            p_state, p_out = plain.step(gray, depth)
            with profiling.recording(profiling.StageTimer()):
                s_state, s_out = stamped.step(gray, depth)
            _leaves_equal(p_state, s_state, f"frame {i} state")
            _leaves_equal(p_out, s_out, f"frame {i} output")
            times = stamped.stamps.cpu().numpy()[:len(profiling.stamps(False, True))]
            assert (np.diff(times) >= 0).all() and times[0] > 0, (i, times)
        assert plain.stamps is None
    finally:
        plain.close()
        stamped.close()


@pytest.mark.cuda
def test_run_frames_stamps_ten_a_replay_on_the_card(cuda):
    """``run_frames`` over 20 frames: twelve stamps a replay (the ten of the
    stages, and the cylinder section's start and end inside ``plane_extract``),
    non-decreasing; the stages sum to the graph's span, the nested section
    lies inside its stage; span and gap together are the frames' wall time on
    the host within 5%."""
    cam, cfg = config.TUM_FR1, config.SlamConfig()
    frames = _room_frames(20, cuda)
    timer = profiling.StageTimer(log=True)
    _, _, stats = runner.run_frames(frames, cam, cfg, device=cuda, trace=timer)
    assert stats.stamped_frames == 19
    stages = {k: v for k, v in stats.stage_device_us.items()
              if k not in profiling.PLANE_SECTIONS}
    assert sum(stages.values()) == pytest.approx(stats.graph_span_us)
    assert all(v >= 0 for v in stats.stage_device_us.values())
    assert 0 < stats.stage_device_us["cylinders"] < stats.stage_device_us["plane_extract"]
    device = [e for e in timer.events if e[0] == "device"]
    assert len(device) == 20
    for _, names, times in device:
        assert names == profiling.stamps(False, True)[1:]
        assert len(times) == 12 and (np.diff(times) >= 0).all()
    wall_us = 1e6 * (stats.total_step_s - stats.compile_s)
    assert stats.graph_span_us + stats.replay_gap_us == pytest.approx(wall_us, rel=0.05)


def _wall_frames(n, device):
    cam = config.TUM_FR1
    scene = StripeWallScene(cam, texture_scale=0.03, stripe_period_z=2400.0)
    return [tuple(torch.as_tensor(a, device=device) for a in scene.render(q, p))
            for q, p in lateral_trajectory(n, speed_mm=4.0)]


@pytest.mark.cuda
def test_the_line_sections_are_stamped_on_the_card(cuda):
    """Points and lines on the low-texture striped wall at 640x480: a step
    graph recorded with stamps equals one recorded without to the bit over
    10 frames, with twelve stamps a replay in order; ``run_frames`` over 20
    frames sums ``line_tiles`` and ``lines`` with the other stages, which add
    up to the graph's span, and counts the lines it detected and matched."""
    cam, cfg = config.TUM_FR1, config.SlamConfig()
    frames = _wall_frames(20, cuda)
    kw = dict(with_planes=False, with_lines=True)
    plain = step_graph.StepGraph(engine.init_state(cam, cfg, seed=0, device=cuda), cam, cfg,
                                 **kw)
    stamped = step_graph.StepGraph(engine.init_state(cam, cfg, seed=0, device=cuda), cam, cfg,
                                   **kw)
    names = profiling.stamps(True, False)
    try:
        for i, (gray, depth) in enumerate(frames[:10]):
            p_state, p_out = plain.step(gray, depth)
            with profiling.recording(profiling.StageTimer()):
                s_state, s_out = stamped.step(gray, depth)
            _leaves_equal(p_state, s_state, f"frame {i} state")
            _leaves_equal(p_out, s_out, f"frame {i} output")
            times = stamped.stamps.cpu().numpy()[:len(names)]
            assert (np.diff(times) >= 0).all() and times[0] > 0, (i, times)
        assert stamped.stamp_names == names and len(names) == 12
    finally:
        plain.close()
        stamped.close()
    timer = profiling.StageTimer(log=True)
    _, _, stats = runner.run_frames(frames, cam, cfg, device=cuda, trace=timer, **kw)
    assert stats.stamped_frames == 19
    assert list(stats.stage_device_us) == list(profiling.stages(True, False))
    assert sum(stats.stage_device_us.values()) == pytest.approx(stats.graph_span_us)
    assert stats.stage_device_us["line_tiles"] > 0 and stats.stage_device_us["lines"] > 0
    assert [len(e[2]) for e in timer.events if e[0] == "device"] == [12] * 20
    assert stats.lines_detected > 0 and stats.line_matches > 0 and stats.lines_alive > 0


@pytest.mark.cuda
def test_a_frame_from_the_host_is_stamped_around_its_upload_on_the_card(cuda):
    """Frames as host arrays: each frame past the first is uploaded between two
    stamps, a stretch inside the gap between its replay and the one before."""
    cam, cfg = config.TUM_FR1, config.SlamConfig()
    frames = [tuple(t.cpu().numpy() for t in f) for f in _room_frames(12, cuda)]
    _, _, stats = runner.run_frames(frames, cam, cfg, device=cuda)
    assert stats.upload_frames == stats.stamped_frames == 11
    assert 0 < stats.upload_device_us < stats.replay_gap_us
    assert stats.counters["uploads"] == 24


@pytest.mark.cuda
def test_the_clock_offset_is_read_within_100_us(cuda):
    cam, cfg = config.TUM_FR1, config.SlamConfig()
    frames = _room_frames(3, cuda)
    for _ in range(2):
        _, _, stats = runner.run_frames(frames, cam, cfg, device=cuda)
        assert 0 < stats.clock_offset_err_ns < 50_000, stats.clock_offset_err_ns
