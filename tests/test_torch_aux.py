"""Checkpoint and resume, determinism, stage timing and logging of the port
(mirrors ``tests/test_aux.py``).  The port's engine runs on the CPU at that
file's small configuration; where the JAX package is the yardstick (the leaf
order of a checkpoint, ``StageTimer``'s report) it gets the same inputs.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from rgbd_slam_tpu import engine as j_engine
from rgbd_slam_tpu.config import CameraIntrinsics as JCam
from rgbd_slam_tpu.config import SlamConfig as JCfg
from rgbd_slam_tpu.profiling import StageTimer as JStageTimer
from rgbd_slam_tpu_torch import engine, profiling, runner
from rgbd_slam_tpu_torch.config import (CameraIntrinsics, DetectionConfig, EngineConfig,
                                        MappingConfig, SlamConfig)
from rgbd_slam_tpu_torch.io import checkpoint
from rgbd_slam_tpu_torch.synthetic import WallScene, lateral_trajectory
from rgbd_slam_tpu_torch.utils import logging as port_logging

CAM = CameraIntrinsics(width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0)
CFG = SlamConfig(
    mapping=MappingConfig(max_points_3d=128, max_points_2d=32, max_planes=8,
                          max_tracked_points=64),
    engine=EngineConfig(pose_covariance_mc_iterations=8, lm_iterations=8,
                        ransac_hypothesis_batch=16),
)


@pytest.fixture(scope="module")
def frames():
    scene = WallScene(CAM)
    return [scene.render(q, p) for q, p in lateral_trajectory(4)]


def _run(frames, state=None, seed=0):
    if state is None:
        state = engine.init_state(CAM, CFG, seed=seed, device="cpu")
    outs = []
    for g, d in frames:
        state, out = engine.step(state, torch.from_numpy(g), torch.from_numpy(d), CAM, CFG)
        outs.append(out)
    return state, outs


def _assert_states_equal(a, b):
    la, lb = checkpoint._leaves(a), checkpoint._leaves(b)
    assert len(la) == len(lb) > 50
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y) or (x.dtype.is_floating_point
                                     and torch.equal(torch.nan_to_num(x), torch.nan_to_num(y))
                                     and torch.equal(torch.isnan(x), torch.isnan(y)))
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.fixture(scope="module")
def straight(frames):
    return _run(frames)


@pytest.fixture(scope="module")
def halfway(frames):
    return _run(frames[:2])[0]


def test_round_trip_bit_exact(halfway, tmp_path):
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_state(halfway, path)
    loaded = checkpoint.load_state(path, engine.init_state(CAM, CFG, seed=9, device="cpu"))
    _assert_states_equal(halfway, loaded)
    assert type(loaded.points) is type(halfway.points)
    assert isinstance(loaded.prev_pyramid, tuple) and loaded.position.device.type == "cpu"
    explicit = checkpoint.load_state(path, loaded, device="cpu")
    _assert_states_equal(halfway, explicit)


def test_resume_continues_bit_exact(frames, straight, halfway, tmp_path):
    """2 frames, a checkpoint, a fresh template, 2 more frames: the state, the
    generator and every output of the last frames equal the straight run's to
    the last bit."""
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_state(halfway, path)
    resumed = checkpoint.load_state(path, engine.init_state(CAM, CFG, seed=5, device="cpu"))
    state, outs = _run(frames[2:], state=resumed)
    _assert_states_equal(straight[0], state)
    for want, got in zip(straight[1][2:], outs):
        for name in ("position", "quat", "pose_cov", "n_point_inliers", "point_fid"):
            assert torch.equal(getattr(want, name), getattr(got, name)), name
    # and the draws do matter: another generator state gives another pose
    other = checkpoint.load_state(path, engine.init_state(CAM, CFG, device="cpu"))
    other.generator.manual_seed(1234)
    assert not torch.equal(_run(frames[2:], state=other)[1][-1].position,
                           outs[-1].position)


def test_capacity_mismatch_rejected(halfway, tmp_path):
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_state(halfway, path)
    deeper = dataclasses.replace(CFG, detection=DetectionConfig(
        optical_flow_pyramid_depth=CFG.detection.optical_flow_pyramid_depth + 1))
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load_state(path, engine.init_state(CAM, deeper, device="cpu"))
    np.savez(str(tmp_path / "two.npz"), n_leaves=2, leaf_0=np.zeros(4), leaf_1=np.zeros(3))
    with pytest.raises(ValueError, match="2 leaves"):
        checkpoint.load_state(str(tmp_path / "two.npz"), halfway)


def test_leaves_are_in_the_jax_package_s_order(halfway):
    """Leaf i of the port's checkpoint is leaf i of the JAX package's (same
    shape; descriptors uint32 there, int32 here), but for the last: the key
    there, the generator's state here."""
    j_cfg = JCfg(mapping=type(JCfg().mapping)(**dataclasses.asdict(CFG.mapping)))
    j_state = j_engine.init_state(JCam(**dataclasses.asdict(CAM)), j_cfg)
    j_leaves = jax.tree.leaves(j_state)
    leaves = checkpoint._leaves(halfway)
    assert len(j_leaves) == len(leaves) + 1
    for i, (a, b) in enumerate(zip(j_leaves[:-1], leaves)):
        assert tuple(a.shape) == tuple(b.shape), i
    assert j_leaves[-1] is j_state.key


def test_same_seed_same_trajectory(frames):
    positions = []
    for seed in (42, 42, 43):
        _, outs = _run(frames[:3], seed=seed)
        positions.append(torch.stack([o.position for o in outs]))
    assert torch.equal(positions[0], positions[1])
    assert not torch.equal(positions[0], positions[2])


def test_runner_repeats_and_stages_frames(frames):
    """``run_frames`` twice with one seed gives one trajectory; frames staged by
    ``stage_frames`` (stacked uploads, views per frame) give the same again."""
    timed = [(g, d, 10.0 + i) for i, (g, d) in enumerate(frames[:3])]
    runs = [runner.run_frames(f, CAM, CFG, with_planes=False, seed=3, device="cpu")
            for f in (timed, timed, runner.stage_frames(timed, chunk=2, device="cpu"))]
    for _, traj, stats in runs[1:]:
        np.testing.assert_array_equal(traj.positions_array(), runs[0][1].positions_array())
        assert traj.timestamps == [10.0, 11.0, 12.0] and stats.frame_count == 3
    staged = runner.stage_frames(timed, chunk=2, device="cpu")
    assert len(staged) == 3 and all(len(f) == 3 for f in staged)
    assert staged[0][0].dtype == torch.float32 and staged[2][1].shape == (240, 320)
    assert staged[0][0].untyped_storage().data_ptr() == staged[1][0].untyped_storage().data_ptr()
    assert staged[0][0].untyped_storage().data_ptr() != staged[2][0].untyped_storage().data_ptr()
    np.testing.assert_array_equal(staged[1][1].numpy(), frames[1][1])


def test_stage_timer_report_matches_jax():
    ours, theirs = profiling.StageTimer(), JStageTimer()
    for t in (ours, theirs):
        t.record("extract", 0.010)
        t.record("extract", 0.020)
        t.record("optimize", 0.030)
        t.record("io", 0.0005)
    assert ours.show_statistics(frame_count=2) == theirs.show_statistics(frame_count=2)
    assert ours.show_statistics() == theirs.show_statistics()
    report = ours.show_statistics(frame_count=2)
    assert "extract" in report and "50.0%" not in report.splitlines()[0]
    assert report.splitlines()[0].startswith("Mean frame treatment duration: 30.25 ms")


@pytest.mark.parametrize("block", [True, False])
def test_stage_timer_stage_counts(block):
    timer = profiling.StageTimer(device="cpu")
    for _ in range(3):
        with timer.stage("work", block=block):
            torch.ones(8).sum()
    with pytest.raises(RuntimeError):
        with timer.stage("fails"):
            raise RuntimeError("inside")
    assert timer.counts == {"work": 3, "fails": 1}
    assert timer.totals["work"] > 0 and timer.totals["fails"] >= 0


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert prof.key_averages()


@pytest.mark.parametrize("level, shown", [
    (port_logging.ALL, ["INFO", "WARN", "ERROR"]), (port_logging.LOW, ["INFO", "WARN", "ERROR"]),
    (port_logging.MEDIUM, ["WARN", "ERROR"]), (port_logging.HIGH, ["ERROR"]),
    (port_logging.NONE, [])])
def test_logging_levels(level, shown, monkeypatch, capsys):
    monkeypatch.setattr(port_logging, "_LEVEL", level)
    port_logging.log("an info")
    port_logging.log_warning("a warning")
    port_logging.log_error("an error")
    out = capsys.readouterr().out
    assert [tag for tag in ("INFO", "WARN", "ERROR") if f"[{tag}]" in out] == shown
    if shown:
        assert f"({os.path.basename(__file__)}:" in out      # the call site


def test_logging_is_the_jax_package_s():
    from rgbd_slam_tpu.utils import logging as j_logging

    with open(port_logging.__file__) as a, open(j_logging.__file__) as b:
        assert a.read() == b.read()
