"""The benchmark's arithmetic: from time stamps, intervals and trajectories to
numbers.  Pure numpy, so that the CPU tests hold every formula.

Frozen copies, each from commit 01a0d89:

* :func:`umeyama_alignment`, :func:`ate_rmse`: ``rgbd_slam_tpu_torch/io/trajectory.py``;
* :func:`cells_work` and its constants: ``rgbd_slam_tpu_torch/ops/cells_cuda.py``;
* ``PEAK_F32_FLOPS``, ``PEAK_BYTES_PER_S``: ``chip_smoke.py`` (NVIDIA's data
  sheet for the H100 SXM at 700 W: float32 outside the tensor cores, HBM3).
"""

from __future__ import annotations

import numpy as np

#: one H100 SXM's published float32 rate outside the tensor cores, and its
#: memory bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

#: ``cells_cuda``'s counts: float operations a pixel, a cell and a continuity
#: pair, and bytes written a cell
CELLS_FLOPS_PER_PIXEL = 27
CELLS_FLOPS_PER_CELL = 200
CELLS_FLOPS_PER_PAIR = 8
CELLS_BYTES_PER_CELL = 102


def cells_work(h: int, w: int, patch: int) -> dict:
    """What the per-cell pass needs at an H x W depth map, for the kernels'
    roofline bound: bytes (the depth read once, ``CELLS_BYTES_PER_CELL`` written
    a cell) and float operations (``CELLS_FLOPS_PER_PIXEL`` a pixel,
    ``CELLS_FLOPS_PER_CELL`` and ``CELLS_FLOPS_PER_PAIR`` for each of its
    2 (patch - 1) continuity pairs a cell, and the two ray factors of every
    column and row).  The work does not depend on the depth values."""
    gh, gw = h // patch, w // patch
    c = gh * gw
    return {"cells": c, "bytes": 4 * h * w + CELLS_BYTES_PER_CELL * c,
            "flops": CELLS_FLOPS_PER_PIXEL * h * w
            + c * (CELLS_FLOPS_PER_CELL + CELLS_FLOPS_PER_PAIR * 2 * (patch - 1))
            + 2 * (h + w)}


def least_time_s(work: dict) -> tuple[float, str]:
    """The least time the card could take for ``work`` (``flops``, ``bytes``)
    and which of the two bounds it."""
    by_ops = work["flops"] / PEAK_F32_FLOPS
    by_bytes = work["bytes"] / PEAK_BYTES_PER_S
    return (by_ops, "flops") if by_ops >= by_bytes else (by_bytes, "bytes")


def umeyama_alignment(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (or similarity) alignment est -> gt.

    Returns (rotation 3x3, translation 3, scale)."""
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    e = est - mu_e
    g = gt - mu_g
    cov = g.T @ e / est.shape[0]
    u, d, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1.0
    r = u @ s @ vt
    scale = 1.0
    if with_scale:
        var_e = (e ** 2).sum() / est.shape[0]
        scale = np.trace(np.diag(d) @ s) / var_e
    t = mu_g - scale * r @ mu_e
    return r, t, scale


def aligned_errors(est_positions, gt_positions) -> np.ndarray:
    """Squared position error of every frame after the rigid Umeyama alignment
    of the whole trajectory onto the ground truth."""
    est = np.asarray(est_positions, dtype=np.float64)
    gt = np.asarray(gt_positions, dtype=np.float64)
    if est.shape != gt.shape or est.ndim != 2 or est.shape[0] < 3:
        raise ValueError(f"trajectories of {est.shape} and {gt.shape}")
    r, t, s = umeyama_alignment(est, gt)
    est = (s * (r @ est.T)).T + t
    return ((est - gt) ** 2).sum(axis=1)


def ate_rmse(est_positions, gt_positions) -> float:
    """Absolute trajectory error RMSE after rigid alignment."""
    return float(np.sqrt(aligned_errors(est_positions, gt_positions).mean()))


def ate_over_sequences(trajectories, gt_positions) -> float:
    """ATE-RMSE over the frames of several runs of one sequence: each run is
    aligned on its own, and the root of the mean squared error is taken over
    all their frames together."""
    errs = np.concatenate([aligned_errors(t, gt_positions) for t in trajectories])
    return float(np.sqrt(errs.mean()))


def frames_in_window(done_stamps, window_end: float) -> int:
    """Frames whose pose reached the host by ``window_end``."""
    return int(np.count_nonzero(np.asarray(done_stamps, np.float64) <= window_end))


def fps(done_stamps, window_start: float, window_end: float) -> float:
    """Frames whose pose reached the host in the window, over its seconds."""
    return frames_in_window(done_stamps, window_end) / (window_end - window_start)


def latencies_s(pull_stamps, done_stamps, window_end: float) -> np.ndarray:
    """Each counted frame's latency: from when it was pulled from its source to
    when its pose reached the host."""
    pulls = np.asarray(pull_stamps, np.float64)
    done = np.asarray(done_stamps, np.float64)
    keep = done <= window_end
    return done[keep] - pulls[keep]


def percentile(values, q: float) -> float:
    """The ``q``-th percentile, linear between the order statistics."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def union_length(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, reach = 0.0, -np.inf
    for start, end in sorted(intervals):
        if end <= reach:
            continue
        total += end - max(start, reach)
        reach = end
    return total


def idle_gaps(intervals):
    """The gaps between the merged intervals, as (start, end), in order."""
    gaps, reach = [], None
    for start, end in sorted(intervals):
        if reach is not None and start > reach:
            gaps.append((reach, start))
        reach = end if reach is None else max(reach, end)
    return gaps


def busy_and_window(intervals) -> tuple[float, float]:
    """(time covered by some interval, from the first start to the last end)."""
    if not intervals:
        return 0.0, 0.0
    first = min(s for s, _ in intervals)
    last = max(e for _, e in intervals)
    return union_length(intervals), last - first
