"""The port stands alone: it imports no jax, and ``chip_smoke.py`` and
``bench_torch.py`` refuse to run without a CUDA card (``chip_smoke.py`` also
without the package beside it)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True,
                          text=True, timeout=240, env=env)


def _port_modules():
    """Every module of the port, by its files: the package's, ``chip_smoke``,
    ``bench_torch`` and the stage profiler it imports, the backend and plane
    kernel profilers, and the example launcher."""
    names = []
    package = os.path.join(ROOT, "rgbd_slam_tpu_torch")
    for folder, dirs, files in os.walk(package):
        dirs[:] = sorted(d for d in dirs if d not in ("__pycache__", "_build", "csrc"))
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(folder, f), ROOT)[:-3]
                names.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return names + ["chip_smoke", "bench_torch", "tools.profile_torch_step",
                    "tools.profile_torch_backend", "tools.profile_plane_kernels",
                    "examples/run_tum_torch.py"]


#: imports every module in one interpreter under a watch on the import system:
#: whoever asks for jax or for the JAX package is recorded by name
_WATCH = """
import importlib, importlib.util, json, sys

def forbidden(name):
    return name in ("jax", "jaxlib", "rgbd_slam_tpu") or name.startswith(
        ("jax.", "jaxlib.", "rgbd_slam_tpu."))

asked = {}

class Watch:
    def find_spec(self, name, path=None, target=None):
        if forbidden(name):
            frame = sys._getframe(1)
            while frame is not None:
                who = frame.f_globals.get("__name__", "")
                if who.startswith("rgbd_slam_tpu_torch") or who in (
                        "chip_smoke", "bench_torch", "tools.profile_torch_step",
                        "tools.profile_torch_backend", "tools.profile_plane_kernels",
                        "profile_torch_step",
                        "run_tum_torch"):
                    asked.setdefault(who, []).append(name)
                    break
                frame = frame.f_back
        return None

sys.meta_path.insert(0, Watch())
failed = {}
for module in sys.argv[1:]:
    try:
        if module.endswith(".py"):
            spec = importlib.util.spec_from_file_location("run_tum_torch", module)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        else:
            importlib.import_module(module)
    except Exception as e:
        failed[module] = repr(e)
print(json.dumps({"asked": asked, "failed": failed,
                  "loaded": sorted(m for m in sys.modules if forbidden(m))}))
"""


@pytest.fixture(scope="module")
def import_report():
    proc = _run(["-c", _WATCH, *_port_modules()], cwd=ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.splitlines()[-1])


@pytest.mark.parametrize("module", _port_modules())
def test_port_imports_no_jax(module, import_report):
    name = "run_tum_torch" if module.endswith(".py") else module
    assert module not in import_report["failed"], import_report["failed"][module]
    assert name not in import_report["asked"], import_report["asked"][name]
    assert import_report["loaded"] == []


def test_the_import_watch_sees_an_import_of_jax(tmp_path):
    """The watch itself: a module named like the port's that imports jax is
    reported, by name."""
    package = tmp_path / "rgbd_slam_tpu_torch_probe"
    package.mkdir()
    (package / "__init__.py").write_text("import jax.numpy\n")
    proc = _run(["-c", _WATCH, "rgbd_slam_tpu_torch_probe"], cwd=str(tmp_path))
    report = json.loads(proc.stdout.splitlines()[-1])
    assert "jax.numpy" in report["asked"]["rgbd_slam_tpu_torch_probe"]
    assert "jax" in report["loaded"]


def test_chip_smoke_fails_without_a_card():
    # this suite runs where torch has no CUDA device
    proc = _run(["chip_smoke.py"], cwd=ROOT,
                env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_bench_torch_fails_without_a_card():
    proc = _run(["bench_torch.py"], cwd=ROOT,
                env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 1
    assert proc.stdout == "" and "no CUDA device" in proc.stderr


def test_chip_smoke_fails_without_the_package(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
