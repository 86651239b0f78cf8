"""The harness's run, on the CPU at a cut sequence, with the timed path sound
and broken: the check has to call every fault incorrect.  It skips the look
for a card (``harness.run(..., device="cpu")``) and drives the rest of a run;
the program runs its plain versions on the CPU, which the reference equals to
the bit.  Each run steps its frames in about a second each, so the file takes
a few minutes.  Without a card the command itself refuses to run."""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from rgbd_slam_tpu_torch import cli, engine  # noqa: E402
from rgbd_slam_tpu_torch.tracking import kalman  # noqa: E402
from slambench import harness  # noqa: E402
from slambench.tests.cpu_root import make_root  # noqa: E402

SEED = 2 ** 31 + 4242


def _run(tmp_path, capsys, workload, frames=6, seconds=1.0):
    root = make_root(tmp_path, frames=frames, warmup=3, checked=4)
    args = argparse.Namespace(workload=workload, seed=SEED, seconds=seconds, trace=0,
                              tf32=False)
    torch.set_num_threads(4)
    rc = harness.run(args, time.perf_counter(), root=root, device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


def _stuck(real):
    """A step that returns its state unchanged."""
    def step(state, gray, depth, cam, cfg, **kw):
        _, out = real(state, gray, depth, cam, cfg, **kw)
        return state, out._replace(position=state.position, quat=state.quat)
    return step


def _altered(real):
    """A pose altered where the step produces it: 1 mm along x."""
    def step(state, gray, depth, cam, cfg, **kw):
        new_state, out = real(state, gray, depth, cam, cfg, **kw)
        moved = out.position + torch.tensor([1.0, 0.0, 0.0], dtype=out.position.dtype)
        return new_state, out._replace(position=moved)
    return step


def _cov_doubled(real):
    """The pose covariance the step hands on, doubled."""
    def step(state, gray, depth, cam, cfg, **kw):
        new_state, out = real(state, gray, depth, cam, cfg, **kw)
        return new_state._replace(pose_cov=2.0 * new_state.pose_cov), out
    return step


def _map_unmoved(real):
    """The point map's Kalman update left out: matched points keep their
    positions (the covariances still shrink)."""
    def track_points(positions, covariances, observations, obs_covariances, **kw):
        _, cov, score, moving = real(positions, covariances, observations, obs_covariances,
                                     **kw)
        return positions, cov, score, moving
    return track_points


#: fault: (module, function, the function broken)
FAULTS = {"state_unchanged": (engine, "step", _stuck),
          "pose_altered": (engine, "step", _altered),
          "pose_cov_doubled": (engine, "step", _cov_doubled),
          "point_map_not_updated": (kalman, "track_points", _map_unmoved)}


def test_a_sound_run_is_correct(tmp_path, capsys):
    result = _run(tmp_path, capsys, "fr1_vo.room")
    assert result["correct"] is True
    assert result["checks"]["step_gap_mm"]["value"] == 0.0
    assert result["checks"]["traj_gap_mm"]["value"] == 0.0
    assert result["checks"]["leaf_gap"]["value"] == 0.0
    assert result["checks"]["steps_off"]["value"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"fps", "frame_latency_p95_ms", "ate_mm", "setup_s"}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_step_is_incorrect(tmp_path, capsys, monkeypatch, fault):
    module, name, broken = FAULTS[fault]
    monkeypatch.setattr(module, name, broken(getattr(module, name)))
    result = _run(tmp_path, capsys, "fr1_vo.room")
    assert result["correct"] is False
    shown = result["checks"]
    assert any(v["limit"] is not None and v["value"] > v["limit"] for v in shown.values())
    if fault in ("pose_cov_doubled", "point_map_not_updated"):
        # the pose is sound: only the state's leaves show the fault
        assert shown["step_gap_mm"]["value"] == 0.0
        assert shown["leaf_gap"]["value"] > shown["leaf_gap"]["limit"]


def test_a_frame_altered_in_the_decode_is_incorrect(tmp_path, capsys, monkeypatch):
    real = cli.open_frames

    def open_frames(index, cam, native):
        for gray, depth, ts in real(index, cam, native):
            yield gray, depth + 1.0, ts

    monkeypatch.setattr(cli, "open_frames", open_frames)
    result = _run(tmp_path, capsys, "fr1_vo.tum_files")
    assert result["correct"] is False
    assert result["checks"]["frame_gap"]["value"] == 1.0


def _command(cwd, env=None):
    return subprocess.run([sys.executable, "slambench/run.py", "--workload", "fr1_vo.room",
                           "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, capture_output=True, text=True, timeout=600, env=env)


def test_without_a_card_the_command_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    proc = _command(REPO)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr


def test_with_only_the_benchmark_files_the_command_fails(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "slambench", tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _command(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
