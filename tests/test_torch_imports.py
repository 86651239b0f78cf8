"""The port stands alone: it imports no jax, and ``chip_smoke.py`` refuses to run
without a CUDA card or without the package beside it."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True,
                          text=True, timeout=240, env=env)


@pytest.mark.parametrize("module", ["rgbd_slam_tpu_torch", "rgbd_slam_tpu_torch.engine",
                                    "rgbd_slam_tpu_torch.runner",
                                    "rgbd_slam_tpu_torch.features.lines",
                                    "rgbd_slam_tpu_torch.parallel.ba",
                                    "rgbd_slam_tpu_torch.parallel.keyframes",
                                    "rgbd_slam_tpu_torch.parallel.pose_graph", "chip_smoke"])
def test_port_imports_no_jax(module):
    code = (f"import sys, importlib; importlib.import_module({module!r}); "
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('rgbd_slam_tpu.') or m == 'rgbd_slam_tpu'); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = _run(["-c", code], cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_fails_without_a_card():
    # this suite runs where torch has no CUDA device
    proc = _run(["chip_smoke.py"], cwd=ROOT,
                env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_without_the_package(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
