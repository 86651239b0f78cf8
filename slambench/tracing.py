"""What a ``--trace 1`` run reads besides the clock: host syncs, and the
profiler's device timeline.  Frozen copies, each from commit 01a0d89:

* :class:`SyncCounter`: ``chip_smoke.host_sync_sites``' counting
  (``torch.cuda.set_sync_debug_mode("warn")``), without the site names;
* :class:`StageRanges`, :func:`device_breakdown`, ``OWN_KERNELS``:
  ``tools/profile_torch_step.py``;
* the kernels and device µs a frame of :func:`read_slice`:
  ``chip_smoke.profile_replays``' arithmetic, over the step's own ranges.

Ranges are the benchmark's: :class:`Ranges` opens a ``record_function`` range
around each call of the program's functions that it is given, from outside the
program.  A range cannot live inside a CUDA graph, so the stages' ranges
(:class:`StageRanges`) run over eager steps only.
"""

from __future__ import annotations

import warnings
from collections import defaultdict

import torch

from . import measure

#: prefix of the benchmark's own profiler ranges around calls into the program
RANGE_PREFIX = "slambench:"
#: prefix of the ranges around the eager step's stages
STAGE_PREFIX = "stage:"
#: the port's own kernels by name prefix, and the stage that launches each.
#: They launch through ctypes, outside every PyTorch op, so the profiler charges
#: them to no range: they are charged to their stage by name.
OWN_KERNELS = {"lk_": "optical_flow", "components_kernel": "plane_extract",
               "cells_": "plane_extract", "cylinders_kernel": "plane_extract",
               "lm_solve_kernel": "pose_opt"}
#: the per-cell pass's kernels (``csrc/cells.cu``)
CELLS_KERNELS = ("cells_fit_kernel", "cells_edges_kernel")
#: how many device operations and idle gaps the breakdown lists
BREAKDOWN_ENTRIES = 10


class SyncCounter:
    """Counts the host syncs of the code run inside it, by the warnings of
    ``torch.cuda.set_sync_debug_mode("warn")``."""

    def __init__(self):
        self.count = 0
        self._inside = False
        self._catch = None

    def _record(self, message, *_args, **_kw):
        # a warning the mode's own switch raises is not the code's
        if self._inside and "synchroniz" in str(message):
            self.count += 1

    def __enter__(self):
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter("always")
        warnings.showwarning = self._record
        torch.cuda.set_sync_debug_mode("warn")
        self._inside = True
        return self

    def __exit__(self, *exc):
        self._inside = False
        torch.cuda.set_sync_debug_mode("default")
        self._catch.__exit__(*exc)
        return False


class Ranges:
    """A ``record_function`` range named ``RANGE_PREFIX + name`` around every
    call of each ``(owner, attribute, name)`` given, while installed."""

    def __init__(self, targets):
        self.targets = targets
        self.saved = []

    def __enter__(self):
        for owner, attr, name in self.targets:
            fn = getattr(owner, attr)
            self.saved.append((owner, attr, fn))
            setattr(owner, attr, _ranged(RANGE_PREFIX + name, fn))
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self.saved):
            setattr(owner, attr, fn)
        self.saved = []
        return False


def _ranged(label, fn):
    def ranged(*args, **kw):
        with torch.profiler.record_function(label):
            return fn(*args, **kw)
    return ranged


class StageRanges:
    """A ``record_function`` range named ``STAGE_PREFIX + stage`` around the
    outermost call of each stage function of ``stages`` ({stage: [(module,
    function name)]}), with no sync and no clock: under ``torch.profiler`` the
    kernels a stage launches are charged to it (:func:`device_breakdown`)."""

    def __init__(self, stages):
        self.stages = stages
        self.active = False
        self.saved = []

    def __enter__(self):
        for stage, targets in self.stages.items():
            for module, name in targets:
                fn = getattr(module, name)
                self.saved.append((module, name, fn))
                setattr(module, name, self._wrap(stage, fn))
        return self

    def __exit__(self, *exc):
        for module, name, fn in reversed(self.saved):
            setattr(module, name, fn)
        self.saved = []
        return False

    def _wrap(self, stage, fn):
        def ranged(*args, **kw):
            if self.active:
                return fn(*args, **kw)
            self.active = True
            try:
                with torch.profiler.record_function(STAGE_PREFIX + stage):
                    return fn(*args, **kw)
            finally:
                self.active = False
        return ranged


def own_stage(name: str):
    """The stage of one of the port's own kernels (``OWN_KERNELS``), or None."""
    return next((stage for prefix, stage in OWN_KERNELS.items() if name.startswith(prefix)),
                None)


def _on_device(evt) -> bool:
    from torch.autograd import DeviceType

    return evt.device_type == DeviceType.CUDA


def device_breakdown(prof, n_frames: int) -> tuple[dict, float]:
    """Device time of a ``torch.profiler`` run over ``n_frames`` eager frames
    under :class:`StageRanges`.  Returns (device µs a frame by stage, ``other``
    for the kernels launched outside every stage; device µs a frame in all)."""
    stages = defaultdict(float)
    total_us = 0.0
    for evt in prof.events():
        if _on_device(evt):
            # a range also shows on the device's timeline: it is not a kernel
            if not evt.name.startswith(STAGE_PREFIX):
                total_us += evt.time_range.elapsed_us()
                stage = own_stage(evt.name)
                if stage is not None:
                    stages[stage] += evt.time_range.elapsed_us()
            continue
        if evt.name.startswith(STAGE_PREFIX):
            under = getattr(evt, "device_time_total", None)
            stages[evt.name[len(STAGE_PREFIX):]] += (
                evt.cuda_time_total if under is None else under)
    per_frame = {k: v / n_frames for k, v in sorted(stages.items(), key=lambda kv: -kv[1])}
    per_frame["other"] = (total_us - sum(stages.values())) / n_frames
    return per_frame, total_us / n_frames


def _raw_events(prof):
    """(device operations, host events) of a profiler run, from its raw
    events: (start s, end s, name, correlation id) each."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        row = (start, start + e.duration_ns() * 1e-9, e.name(), e.correlation_id())
        if e.device_type() != DeviceType.CUDA:
            host.append(row)
        elif not row[2].startswith((RANGE_PREFIX, STAGE_PREFIX)):
            # a range also shows on the device's timeline: it is not an operation
            device.append(row)
    return device, host


def read_slice(prof, n_frames: int) -> dict:
    """What the profiled part of the window holds, over its ``n_frames``
    frames: the device's busy and window seconds (the union of its operations,
    and the span from the first to the last); the step's device µs and
    operations a frame, those whose launch on the host (the runtime call of the
    same correlation id: a graph's kernels share their ``cudaGraphLaunch``'s)
    lies inside the benchmark's ``step`` range; the per-cell pass's kernel µs
    a frame; the device operations that took most time; and the longest idle
    gaps, named by what the host was doing then (the innermost of the
    benchmark's ranges, else of the profiler's host events, open across the
    gap's middle)."""
    device, host = _raw_events(prof)
    ranges = sorted((s, e, n) for s, e, n, _ in host if n.startswith(RANGE_PREFIX))
    launched = {c: s for s, _, n, c in host if c > 0 and n.startswith("cu")}
    steps = [(s, e) for s, e, n in ranges if n == RANGE_PREFIX + "step"]
    intervals = [(s, e) for s, e, _, _ in device]
    busy_s, window_s = measure.busy_and_window(intervals)
    by_name = defaultdict(float)
    cells_s = step_s = 0.0
    step_ops = unlaunched = 0
    for s, e, name, corr in device:
        by_name[name[:160]] += e - s
        if name.startswith(CELLS_KERNELS):
            cells_s += e - s
        t = launched.get(corr)
        if t is None:
            unlaunched += 1
        elif any(a <= t <= b for a, b in steps):
            step_s += e - s
            step_ops += 1
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    gaps = sorted(measure.idle_gaps(intervals), key=lambda g: g[0] - g[1])
    named = [(s, e, n) for s, e, n, _ in host]
    idle = [[_host_doing(named, 0.5 * (a + b)), b - a] for a, b in gaps[:BREAKDOWN_ENTRIES]]
    return {"frames": n_frames, "device_ops_total": len(device),
            "device_ops_unmatched": unlaunched, "step_ranges": len(steps),
            "busy_s": busy_s, "window_s": window_s,
            "step_device_us": 1e6 * step_s / n_frames if step_ops else None,
            "step_kernels": step_ops / n_frames if step_ops else None,
            "device_ops_per_frame": len(device) / n_frames,
            "device_us_per_frame": 1e6 * sum(e - s for s, e in intervals) / n_frames,
            "cells_us": 1e6 * cells_s / n_frames if cells_s > 0 else None,
            "breakdown": {"device_ops": [[n, t] for n, t in device_ops], "idle_gaps": idle}}


def read_idle(prof, n_frames: int) -> dict:
    """The device's busy and window seconds of a device-only trace over
    ``n_frames`` frames: the union of its operations, and the span from the
    first to the last."""
    device, _ = _raw_events(prof)
    busy_s, window_s = measure.busy_and_window([(s, e) for s, e, _, _ in device])
    return {"frames": n_frames, "device_ops": len(device), "busy_s": busy_s,
            "window_s": window_s}


def _host_doing(host, t: float) -> str:
    """The innermost of the benchmark's ranges open at ``t``, else the innermost
    host operation, else ``host``."""
    open_at = [(e - s, name) for s, e, name in host if s <= t <= e]
    ours = [x for x in open_at if x[1].startswith(RANGE_PREFIX)]
    for pick in (ours, open_at):
        if pick:
            return min(pick)[1][:160]
    return "host"
