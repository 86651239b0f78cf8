"""The benchmark's arithmetic on synthetic stamps and trajectories."""

from __future__ import annotations

import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from slambench import check, measure  # noqa: E402


def test_fps_counts_frames_done_in_the_window():
    done = [0.5, 1.0, 1.5, 2.0, 2.5]
    assert measure.frames_in_window(done, 2.0) == 4
    assert measure.fps(done, 0.0, 2.0) == 2.0
    assert measure.fps(done, 0.0, 3.0) == 5 / 3


def test_latency_of_counted_frames_and_its_tail():
    pulls = np.arange(100) * 0.01
    done = pulls + np.where(np.arange(100) % 10 == 0, 0.2, 0.1)
    lat = measure.latencies_s(pulls, done, window_end=10.0)
    assert lat.size == 100
    assert measure.percentile(lat, 50) == pytest.approx(0.1)
    assert measure.percentile(lat, 95) == pytest.approx(0.2)
    assert measure.latencies_s(pulls, done, window_end=0.505).size == 40


def test_percentile_is_linear_between_order_statistics():
    assert measure.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 95) == pytest.approx(4.8)


def test_union_gaps_and_idle_share():
    intervals = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.7), (6.0, 7.0)]
    assert measure.union_length(intervals) == pytest.approx(4.0)
    assert measure.idle_gaps(intervals) == [(2.0, 3.0), (4.0, 6.0)]
    busy, window = measure.busy_and_window(intervals)
    assert (busy, window) == (pytest.approx(4.0), pytest.approx(7.0))
    assert measure.busy_and_window([]) == (0.0, 0.0)


def _independent_ate(est, gt):
    """Horn's closed form through the quaternion of the rotation: another road
    to the rigid alignment than the SVD of ``measure.umeyama_alignment``."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    a, b = est - mu_e, gt - mu_g
    s = a.T @ b
    n = np.array([
        [s[0, 0] + s[1, 1] + s[2, 2], s[1, 2] - s[2, 1], s[2, 0] - s[0, 2], s[0, 1] - s[1, 0]],
        [s[1, 2] - s[2, 1], s[0, 0] - s[1, 1] - s[2, 2], s[0, 1] + s[1, 0], s[2, 0] + s[0, 2]],
        [s[2, 0] - s[0, 2], s[0, 1] + s[1, 0], -s[0, 0] + s[1, 1] - s[2, 2], s[1, 2] + s[2, 1]],
        [s[0, 1] - s[1, 0], s[2, 0] + s[0, 2], s[1, 2] + s[2, 1], -s[0, 0] - s[1, 1] + s[2, 2]]])
    w, v = np.linalg.eigh(n)
    q0, qx, qy, qz = v[:, -1]
    r = np.array([
        [q0 * q0 + qx * qx - qy * qy - qz * qz, 2 * (qx * qy - q0 * qz), 2 * (qx * qz + q0 * qy)],
        [2 * (qy * qx + q0 * qz), q0 * q0 - qx * qx + qy * qy - qz * qz, 2 * (qy * qz - q0 * qx)],
        [2 * (qz * qx - q0 * qy), 2 * (qz * qy + q0 * qx), q0 * q0 - qx * qx - qy * qy + qz * qz]])
    aligned = (r @ a.T).T + mu_g
    return float(np.sqrt(((aligned - gt) ** 2).sum(1).mean()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ate_against_an_independent_alignment(seed):
    rng = np.random.default_rng(seed)
    gt = np.cumsum(rng.normal(0, 4.0, (120, 3)), axis=0)
    angle = rng.uniform(0, np.pi)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    rot = np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k
    est = (rot @ gt.T).T + rng.normal(0, 100.0, 3) + rng.normal(0, 2.0, gt.shape)
    assert measure.ate_rmse(est, gt) == pytest.approx(_independent_ate(est, gt), rel=1e-9)
    exact = (rot @ gt.T).T + 7.0
    assert measure.ate_rmse(exact, gt) < 1e-9


def test_ate_over_sequences_pools_their_frames():
    rng = np.random.default_rng(4)
    gt = np.cumsum(rng.normal(0, 4.0, (60, 3)), axis=0)
    a = gt + rng.normal(0, 1.0, gt.shape)
    b = gt + rng.normal(0, 3.0, gt.shape)
    pooled = measure.ate_over_sequences([a, b], gt)
    ea, eb = measure.ate_rmse(a, gt), measure.ate_rmse(b, gt)
    assert pooled == pytest.approx(np.sqrt((ea ** 2 + eb ** 2) / 2))
    assert measure.ate_over_sequences([a, a], gt) == pytest.approx(ea)


def test_cells_work_is_frozen():
    work = measure.cells_work(480, 640, 20)
    assert work == {"cells": 768, "bytes": 4 * 480 * 640 + 102 * 768,
                    "flops": 27 * 480 * 640 + 768 * (200 + 8 * 2 * 19) + 2 * (480 + 640)}
    least, by = measure.least_time_s(work)
    assert by == "bytes" and least == pytest.approx(work["bytes"] / 3.35e12)


def test_cells_work_matches_the_program_it_was_copied_from():
    from rgbd_slam_tpu_torch.ops import cells_cuda

    for h, w, patch in ((480, 640, 20), (480, 640, 33), (120, 160, 8)):
        assert measure.cells_work(h, w, patch) == cells_cuda.cells_work(h, w, patch)


def test_rotation_gap_is_exact_for_small_and_large_angles():
    for deg in (1e-6, 1e-3, 1.0, 90.0, 179.0):
        th = np.radians(deg)
        q = [np.cos(th / 2), 0.0, np.sin(th / 2), 0.0]
        assert check.rotation_gap_deg([1, 0, 0, 0], q) == pytest.approx(deg, rel=1e-6)
    assert check.rotation_gap_deg([1, 0, 0, 0], [-1, 0, 0, 0]) == 0.0


def test_checked_frames_are_drawn_from_the_seed():
    a = check.checked_frames(2 ** 31 + 77, 120, 12)
    assert a == check.checked_frames(2 ** 31 + 77, 120, 12)
    assert a[0] == 0 and len(a) == 12 and len(set(a)) == 12
    assert sum(i % 8 == 1 for i in a) == 4
    assert a != check.checked_frames(5, 120, 12)


def test_a_leaf_gap_is_relative_for_floats_and_a_share_for_flags():
    ref = torch.tensor([[1000.0, -2000.0], [0.5, float("nan")]])
    assert check.leaf_gap(ref.clone(), ref) == 0.0
    moved = ref.clone()
    moved[0, 0] += 0.25
    assert check.leaf_gap(moved, ref) == 0.25 / 2000.0
    lost = ref.clone()
    lost[1, 0] = float("inf")
    assert check.leaf_gap(lost, ref) == pytest.approx(0.25)
    flags = torch.tensor([True, False, True, True])
    assert check.leaf_gap(~flags, flags) == 1.0
    assert check.leaf_gap(torch.tensor([1, 2, 3, 5], dtype=torch.int32),
                          torch.tensor([1, 2, 3, 4], dtype=torch.int32)) == 0.25
    assert check.leaf_gap(ref[:1], ref) == check.SHAPE_GAP
    assert check.leaf_gap(None, ref) == check.SHAPE_GAP
    zero = torch.zeros(3)
    assert check.leaf_gap(zero + 1e-9, zero) == 1.0


def test_leaf_ratios_compare_a_leaf_without_a_limit_exactly():
    ratios = check.leaf_ratios({"a": 1e-6, "b": 0.0, "c": 1e-9}, {"a": 1e-5})
    assert ratios["a"] == pytest.approx(0.1)
    assert ratios["b"] == 0.0 and ratios["c"] > 1e3


def test_the_leaf_numbers_take_medians_and_count_the_steps_off():
    found = check.Found()
    lim = {"x": 1.0, "y": 1.0}
    for k, (x, y) in enumerate([(0.1, 0.2), (5.0, 0.1), (0.3, 0.2), (0.2, 9.0), (0.1, 0.1)]):
        found.steps.append((k, 0.0, 0.0, None))
        found.leaves.append({"x": x, "y": y})
    stats = types.SimpleNamespace(success_count=5, lost_count=0)
    numbers = check.compare_sequences([(_Traj(5), stats)], _Traj(5), stats, found,
                                      [0, 1, 2, 3, 4], lim)
    assert numbers["leaf_gap"] == pytest.approx(0.2)
    assert numbers["steps_off"] == 2


def test_the_idle_share_divides_the_traced_device_time_by_the_untraced_frames():
    from slambench import registry

    reader = registry.load_reader(REPO, "device_idle_pct")
    run = types.SimpleNamespace(idle={"frames": 100, "busy_s": 1.0, "window_s": 3.0,
                                      "ms_a_frame": 30.0, "ms_a_frame_untraced": 12.5})
    assert reader.read(run) == pytest.approx(20.0)
    assert reader.read(types.SimpleNamespace(idle=None)) is None


class _Traj:
    def __init__(self, n):
        self.n = n

    def positions_array(self):
        return np.zeros((self.n, 3))


def test_judge_holds_the_numbers_of_the_limits_file():
    ok, shown = check.judge({"a": 0.1, "b": 0, "c": 5.0},
                            {"a": {"limit": 0.2}, "b": {"limit": 0}})
    assert ok and shown["a"] == {"value": 0.1, "limit": 0.2}
    assert shown["c"] == {"value": 5.0, "limit": None}
    assert not check.judge({"a": 0.3}, {"a": {"limit": 0.2}})[0]
    assert not check.judge({"b": 0.1}, {"a": {"limit": 0.2}})[0]
    assert not check.judge({"a": 0.1}, {})[0]
    # the leaves' own limits are no number
    assert check.judge({"a": 0.1}, {"a": {"limit": 0.2}, "leaves": {"x": 1.0}})[0]
