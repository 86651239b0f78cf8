"""The check's control on the card, at each cell's own size: the program with
TF32 products (the nearest precision below the configuration's float32) has
to come out incorrect on every seed, and the program as configured correct.
Marked ``cuda``: it skips without a card.  Run on the card:

    python -m pytest -m cuda slambench/tests/test_slambench_card.py
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
CELLS = [c["name"] for c in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
#: seeds the limits were not set from
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)
#: a window that finishes the mix's sequences and compares as many as a run does
SECONDS = 5


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _result(workload, seed, *extra):
    proc = subprocess.run([sys.executable, "slambench/run.py", "--workload", workload,
                           "--seed", str(seed), "--seconds", str(SECONDS), "--trace", "0",
                           *extra], cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_incorrect(card, workload, seed):
    result = _result(workload, seed, "--tf32")
    print("control", workload, seed, json.dumps(result["checks"]))
    assert result["correct"] is False, result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_program_is_correct(card, workload):
    result = _result(workload, SEEDS[0])
    print("program", workload, SEEDS[0], json.dumps(result["checks"]))
    assert result["correct"] is True, result["checks"]
