"""The points + lines step (planes off, lines on: the benchmark's ``fr1_lines``
configuration) against the benchmark's plain reference
(``slambench/reference/plain/``, a frozen copy of the port's plain path), on
the low-texture striped wall that the cell ``fr1_lines.stripe_wall`` runs, at a
320x240 camera with the fr1 intrinsics halved (300 line tiles).

On the CPU the port's path equals the frozen copy to the bit, so every leaf of
the state and of the step's outputs at every frame is held equal: the line
map's endpoints, covariances, ids and counts with the rest.  A changed
rounding fails here.  The runner's line counts (``RunStats.lines_detected``,
``line_matches``, ``lines_alive``) are held to the reference's outputs.

This file imports no JAX.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from rgbd_slam_tpu_torch import config, runner, step_graph
from rgbd_slam_tpu_torch.synthetic import StripeWallScene, lateral_trajectory

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from slambench import check  # noqa: E402
from slambench.reference.plain import config as ref_config  # noqa: E402
from slambench.reference.plain import runner as ref_runner  # noqa: E402

torch.set_num_threads(2)

FR1 = config.TUM_FR1
CAM = config.CameraIntrinsics(width=FR1.width // 2, height=FR1.height // 2, fx=FR1.fx / 2,
                              fy=FR1.fy / 2, cx=FR1.cx / 2, cy=FR1.cy / 2)
CFG = config.SlamConfig()
FRAMES = 6
SEED = 3


@pytest.fixture(scope="module")
def runs():
    """The port's and the reference's ``run_frames`` over the same frames from
    the same state seed, each frame's (state, outputs) kept."""
    scene = StripeWallScene(CAM, texture_scale=0.03, stripe_period_z=2400.0)
    frames = [scene.render(q, p) for q, p in lateral_trajectory(FRAMES, speed_mm=4.0)]
    kw = dict(with_planes=False, with_lines=True, seed=SEED, device="cpu")
    port_kept, ref_kept = [], []
    port = runner.run_frames(frames, CAM, CFG,
                             on_frame=lambda i, s, o, dt: port_kept.append((s, o)), **kw)
    ref = ref_runner.run_frames(
        frames, ref_config.CameraIntrinsics(**dataclasses.asdict(CAM)),
        check.build_dataclass(ref_config.SlamConfig, dataclasses.asdict(CFG)),
        on_frame=lambda i, s, o, dt: ref_kept.append((s, o)), **kw)
    return port, ref, port_kept, ref_kept


def _named_leaves(state, out):
    return [*check.tensor_leaves(state, "state"), *check.tensor_leaves(out, "out")]


@pytest.mark.parametrize("frame", range(FRAMES))
def test_every_leaf_equals_the_reference(runs, frame):
    _, _, port_kept, ref_kept = runs
    port = _named_leaves(*port_kept[frame])
    ref = _named_leaves(*ref_kept[frame])
    assert [n for n, _ in port] == [n for n, _ in ref]
    for (name, a), (_, b) in zip(port, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a.nan_to_num(), b.nan_to_num()), name
        assert torch.equal(a.isnan(), b.isnan()), name


def test_the_run_ends_equal_with_lines_in_the_map(runs):
    """The final state and trajectories equal to the bit, and the run does
    what the cell measures: lines detected on every frame, matched from the
    second, alive in the map at the end."""
    (state, traj, stats), (ref_state, ref_traj, ref_stats), _, ref_kept = runs
    np.testing.assert_array_equal(traj.positions_array(), ref_traj.positions_array())
    np.testing.assert_array_equal(np.array(traj.quaternions), np.array(ref_traj.quaternions))
    for a, b in zip(step_graph.tensor_leaves(state), step_graph.tensor_leaves(ref_state),
                    strict=True):
        assert a.dtype == b.dtype and torch.equal(a.nan_to_num(), b.nan_to_num())
    assert stats.success_count == ref_stats.success_count == FRAMES
    outs = [o for _, o in ref_kept]
    assert all(int(o.n_lines) > 0 for o in outs)
    assert all(int(o.n_line_matches) > 0 for o in outs[1:])
    assert int(outs[-1].n_lines_alive) > 0


def test_the_runner_counts_the_lines_the_reference_detects_and_matches(runs):
    (_, _, stats), _, _, ref_kept = runs
    outs = [o for _, o in ref_kept]
    assert stats.lines_detected == sum(int(o.n_lines) for o in outs)
    assert stats.line_matches == sum(int(o.n_line_matches) for o in outs)
    assert stats.lines_alive == int(outs[-1].n_lines_alive)
    assert stats.frame_count == FRAMES
