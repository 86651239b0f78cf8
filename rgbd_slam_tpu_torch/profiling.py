"""Per-stage timing statistics and device profiling hooks (port of
``rgbd_slam_tpu/profiling.py``).

``StageTimer`` keeps the reference's wall-clock accounting and report;
``device_trace`` captures a ``torch.profiler`` trace of the card around a block.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class StageTimer:
    """Accumulates host wall-clock per named stage and prints a percentage
    breakdown.  ``device``: the card whose queue a blocking stage drains; None
    (or a CPU device) drains nothing."""

    def __init__(self, device=None):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        device = torch.device(device) if device is not None else None
        self._cuda = device if device is not None and device.type == "cuda" else None

    def _sync(self):
        if self._cuda is not None:
            torch.cuda.synchronize(self._cuda)

    @contextlib.contextmanager
    def stage(self, name: str, block: bool = True):
        """Time a block.  With ``block`` the card's queue is drained before the
        clock starts and before it stops, so the stage is charged the device
        work it enqueued and none of its predecessor's."""
        if block:
            self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block:
                self._sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def record(self, name: str, seconds: float):
        self.totals[name] += seconds
        self.counts[name] += 1

    def show_statistics(self, frame_count: int | None = None) -> str:
        """Formatted breakdown, stages by falling total time."""
        total = sum(self.totals.values())
        lines = []
        if frame_count:
            lines.append(f"Mean frame treatment duration: "
                         f"{total / max(frame_count, 1) * 1000:.2f} ms "
                         f"over {frame_count} frames")
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * t / total if total > 0 else 0.0
            mean_ms = 1000.0 * t / max(self.counts[name], 1)
            lines.append(f"\t{name}: {mean_ms:.2f} ms mean ({pct:.1f}%)")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a ``torch.profiler`` trace (host and, where there is one, the
    card) around a block and write it as ``trace.json`` into ``log_dir``, in
    Chrome's trace format (chrome://tracing, Perfetto).  Yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
