"""The dataset-to-map entry point end to end: ``python -m rgbd_slam_tpu_torch.cli``
on a generated TUM directory with ``--device cpu`` (mirrors
``tests/test_tum_e2e.py``), and ``run_frames`` on a calibrated rig against the JAX
runner.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_slam_tpu import runner as j_runner
from rgbd_slam_tpu.config import CameraSetup as JCameraSetup
from rgbd_slam_tpu.ops import depth_cloud as j_dc
from rgbd_slam_tpu_torch import runner
from rgbd_slam_tpu_torch.config import CameraIntrinsics, CameraSetup, DepthNoiseModel
from rgbd_slam_tpu_torch.ops import depth_cloud as dc
from rgbd_slam_tpu_torch.synthetic import RoomScene, lateral_trajectory, orbit_trajectory
from test_torch_engine import CAM as J_SMALL_CAM
from test_torch_engine import CFG as J_SMALL_CFG
from test_torch_engine import T_CAM as SMALL_CAM
from test_torch_engine import T_CFG as SMALL_CFG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

CLI_CAM = CameraIntrinsics(width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0)
N_FRAMES = 5


@pytest.fixture(scope="module")
def tum_dataset(tmp_path_factory):
    """5 RoomScene frames at 320x240 as a TUM directory, the depth camera 25 mm
    off the RGB camera (``chip_smoke.write_tum_directory``)."""
    root = tmp_path_factory.mktemp("tum")
    poses = lateral_trajectory(N_FRAMES, speed_mm=4.0)
    scene = RoomScene(CLI_CAM)
    grays = [scene.render(q, p)[0] for q, p in poses]
    return chip_smoke.write_tum_directory(str(root), CLI_CAM, grays, poses)


def _cli(args, env=None):
    return subprocess.run([sys.executable, "-m", "rgbd_slam_tpu_torch.cli", *args],
                          capture_output=True, text=True, timeout=600, cwd=ROOT,
                          env={**os.environ, **(env or {})})


def _check_outputs(proc, traj_out, map_out):
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert f"{N_FRAMES} frames in " in proc.stdout and "frame 0: success=True" in proc.stdout
    assert f"trajectory -> {traj_out}" in proc.stdout and f"map -> {map_out}" in proc.stdout
    ate_mm = float(proc.stdout.split("ATE-RMSE:")[1].split("mm")[0])
    assert ate_mm < 10.0, proc.stdout[-3000:]
    assert f"mm over {N_FRAMES} frames" in proc.stdout
    lines = [ln for ln in open(traj_out).read().splitlines() if ln and not ln.startswith("#")]
    assert len(lines) == N_FRAMES and all(len(ln.split()) == 8 for ln in lines)
    assert "v " in open(map_out).read()


def test_cli_end_to_end_on_the_cpu(tum_dataset, tmp_path):
    dataset, yaml = tum_dataset
    traj_out, map_out = str(tmp_path / "traj.txt"), str(tmp_path / "map.obj")
    proc = _cli(["-d", dataset, "--camera-yaml", yaml, "-n", str(N_FRAMES), "-o", traj_out,
                 "-m", map_out, "--device", "cpu"])
    _check_outputs(proc, traj_out, map_out)
    assert "BA:" not in proc.stdout


def test_cli_native_loader_streamed_map_and_backend(tum_dataset, tmp_path):
    dataset, yaml = tum_dataset
    traj_out, map_out = str(tmp_path / "traj.txt"), str(tmp_path / "map.obj")
    report = str(tmp_path / "report.json")
    proc = _cli(["-d", dataset, "--camera-yaml", yaml, "-o", traj_out, "-m", map_out,
                 "--native-loader", "--stream-map", "--ba", "2", "--device", "cpu"],
                env={"RGBD_SLAM_RUN_REPORT": report})
    _check_outputs(proc, traj_out, map_out)
    assert "BA: runs=" in proc.stdout
    with open(report) as f:
        got = json.load(f)
    assert got["stats"]["frame_count"] == N_FRAMES and got["stats"]["lost_count"] == 0
    assert got["lk_launches"] == {"lk_fwd_bwd": 0, "lk_pyramid": 0, "lk_level": 0}  # CPU
    features = sum(ln.startswith(("p ", "l ", "f ")) for ln in open(map_out))
    assert features == got["stats"]["map_streamed"] + got["stats"]["map_alive_at_end"] > 0


def test_cli_needs_a_card_unless_told_otherwise(tum_dataset):
    dataset, yaml = tum_dataset
    proc = _cli(["-d", dataset, "--camera-yaml", yaml], env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
    assert "ATE-RMSE" not in proc.stdout


def test_cli_without_frames_and_launcher_help(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "rgb.txt").write_text("# rgb\n")
    (empty / "depth.txt").write_text("# depth\n")
    proc = _cli(["-d", str(empty), "--device", "cpu"])
    assert proc.returncode == 1 and "no frames found" in proc.stderr
    launcher = subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                            "run_tum_torch.py"), "-h"],
                              capture_output=True, text=True, timeout=120)
    assert launcher.returncode == 0
    for option in ("-d", "-c", "--camera-yaml", "-n", "-o", "-m", "--no-planes", "--lines",
                   "--ba", "--stream-map", "--native-loader", "--device"):
        assert option in launcher.stdout


# ---------------------------------------------------------------------------
# run_frames on a calibrated rig, against the JAX runner
# ---------------------------------------------------------------------------

RIG = ((1.0, 0.0, 0.0, 12.0), (0.0, 1.0, 0.0, 0.0), (0.0, 0.0, 1.0, 0.0),
       (0.0, 0.0, 0.0, 1.0))


@pytest.fixture(scope="module")
def rig_frames():
    """3 frames of a rig whose depth camera sits 12 mm along the RGB camera's x."""
    poses = orbit_trajectory(3, speed_mm=6.0)
    rgb_scene = RoomScene(SMALL_CAM)
    depth_scene = RoomScene(SMALL_CAM, depth_noise=DepthNoiseModel())
    frames = []
    for q, p in poses:
        p_depth = np.asarray(p) + chip_smoke._np_quat_rotate(q, [RIG[0][3], 0.0, 0.0])
        frames.append((rgb_scene.render(q, p)[0], depth_scene.render(q, p_depth)[1]))
    return frames, np.stack([p for _, p in poses])


def test_run_frames_rectifies_like_the_jax_runner(rig_frames):
    """The same frames and rig through both runners.  The depth map the step
    sees is the same (to 1e-3 mm, same holes); the runners draw other random
    numbers, so their poses are held to each other by 3 mm an axis, and the
    port's ATE to the JAX runner's."""
    frames, gt = rig_frames
    for _, depth in frames:
        want = np.asarray(j_dc.rectify_depth(jnp.asarray(depth), J_SMALL_CAM, J_SMALL_CAM,
                                             jnp.asarray(RIG)))
        got = dc.rectify_depth(torch.from_numpy(depth), SMALL_CAM, SMALL_CAM, RIG).numpy()
        assert ((got == 0) != (want == 0)).sum() <= 2
        both = (got != 0) & (want != 0)
        assert (np.abs(got - want)[both] > 1e-3).sum() <= 2
        assert (got == 0).sum() > (depth == 0).sum()

    seen = []
    setup = CameraSetup(rgb=SMALL_CAM, depth=SMALL_CAM, depth_to_rgb=RIG)
    _, traj, stats = runner.run_frames(frames, SMALL_CAM, SMALL_CFG, camera_setup=setup,
                                       device="cpu", on_frame=lambda i, s, o, dt:
                                       seen.append(int(o.n_point_inliers)))
    j_setup = JCameraSetup(rgb=J_SMALL_CAM, depth=J_SMALL_CAM, depth_to_rgb=RIG)
    _, j_traj, j_stats = j_runner.run_frames(frames, J_SMALL_CAM, J_SMALL_CFG,
                                             camera_setup=j_setup)
    assert stats.frame_count == j_stats.frame_count == 3
    assert stats.success_count == j_stats.success_count == 3 and stats.lost_count == 0
    assert min(seen[1:]) >= 10
    ours, theirs = traj.positions_array(), j_traj.positions_array()
    np.testing.assert_allclose(ours, theirs, atol=3.0)
    ate = runner.evaluate_against_ground_truth(traj, gt)["ate_rmse_mm"]
    j_ate = j_runner.evaluate_against_ground_truth(j_traj, gt)["ate_rmse_mm"]
    print(f"ATE port {ate} mm, JAX {j_ate} mm")
    assert ate < j_ate + 3.0 and ate < 15.0      # 160x120: a pixel is 23 mm at 3 m

    # an identity rig is not rectified: the run equals the run without a rig
    plain = runner.run_frames(frames, SMALL_CAM, SMALL_CFG, device="cpu")[1]
    same = runner.run_frames(frames, SMALL_CAM, SMALL_CFG, device="cpu",
                             camera_setup=CameraSetup(rgb=SMALL_CAM, depth=SMALL_CAM))[1]
    np.testing.assert_array_equal(plain.positions_array(), same.positions_array())
    assert not np.array_equal(plain.positions_array(), ours)
