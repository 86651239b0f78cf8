"""What the benchmark may import: never JAX or the JAX package, and, in the
reference, nothing but the standard library, numpy, PyTorch and itself."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "slambench"
REFERENCE = BENCH / "reference"
FORBIDDEN = {"jax", "jaxlib", "flax", "rgbd_slam_tpu"}
REFERENCE_MAY = set(sys.stdlib_module_names) | {"numpy", "torch"}


def _imports(path: Path):
    """(top-level name, level) of every import in a file."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


SOURCES = sorted(BENCH.rglob("*.py"))


def test_the_walk_sees_every_part():
    names = {p.relative_to(BENCH).parts[0] for p in SOURCES}
    assert {"run.py", "harness.py", "metrics", "reference", "tests"} <= names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    found = {name for name, level in _imports(path) if level == 0} & FORBIDDEN
    assert not found, f"{path} imports {found}"


def test_the_program_prefix_is_compared_whole():
    # the port's name begins with the JAX package's: only whole names match
    assert "rgbd_slam_tpu_torch".split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("path", sorted(REFERENCE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(REFERENCE)))
def test_the_reference_imports_only_plain_modules(path):
    absolute = {name for name, level in _imports(path) if level == 0}
    assert absolute <= REFERENCE_MAY, f"{path} imports {absolute - REFERENCE_MAY}"


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from slambench.reference.plain import runner, engine\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('rgbd_slam_tpu_torch', 'rgbd_slam_tpu', 'jax', 'jaxlib', 'flax'))\n"
            "print(bad)\n" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def test_the_reference_sets_no_global_flag_on_import():
    code = ("import sys; sys.path.insert(0, %r)\nimport torch\n"
            "torch.backends.cuda.matmul.allow_tf32 = True\n"
            "from slambench.reference.plain import runner\n"
            "print(torch.backends.cuda.matmul.allow_tf32)\n" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "True"
