"""A run's trace: host spans, counters and the step graph's device stamps (port of
``rgbd_slam_tpu/profiling.py``).

``StageTimer`` keeps the reference's wall-clock accounting and report (``record``,
``show_statistics``) and is the run's recorder:

* spans (:meth:`StageTimer.stage`), nested: each has a name, a start, an end and
  a parent; by name the recorder keeps the count, the total, the self time (the
  total less what its children cover) and the longest.  While ``torch.profiler``
  records, a span also opens a range of its name (:func:`_range`), so that it
  sits in the profiler's trace on the trace's own clock;
* counters (:meth:`StageTimer.count`);
* on request (``log=True``), an event log of every span, counter and device
  stage, written as one Chrome trace (:meth:`StageTimer.export`).

``runner.run_frames`` makes a recorder the active one for its run
(:func:`recording`), and the layers below it open spans with :func:`span` and
count with :func:`count` without being handed it; with no active recorder both
do nothing.

The step's device stamps: :func:`stamp` is called at ``engine.step``'s section
boundaries, in the order of the path's :func:`stamps`.  It does nothing unless a
``step_graph.StepGraph`` capture with an active recorder is under way
(:func:`stamping`); there each call records a node into the graph that writes
the card's ``%globaltimer`` (ns) into the next slot of the graph's stamp buffer.

The cylinder stage's count of live slots: :func:`count_cylinders` hands it (a
device scalar) to the stepper that runs the step (:func:`counting`), whose
``cylinders_live`` the runner puts in the frame's summary.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import time
from collections import defaultdict

import torch

#: the step's stages in their order with lines off; each ends at a stamp of its
#: name (``commit``: ``StepGraph._commit``'s copies into the static state).  With
#: planes off ``plane_extract`` stays, and holds only the empty plane rows
STAGES = ("flow", "detect", "associate", "plane_extract", "pose_opt", "map_update",
          "insert", "next_track", "commit")
#: the line path's own sections, after ``associate``: the tile pass, the tile
#: graph and its search from the seeds (``features.lines.detect_lines``), then
#: the segments, the endpoint depths and the matching to the line map
LINE_STAGES = ("line_tiles", "lines")
#: sections nested in a stage, with planes on: the cylinder stage of
#: ``features.primitives.find_primitives`` (``ops.cylinders_cuda``), inside
#: ``plane_extract``.  A nested section has a stamp at its start,
#: ``<name>.start``, and one at its end, named as the section; the stage that
#: holds it still runs from the stamp before that start to its own end
PLANE_SECTIONS = ("cylinders",)


def stages(with_lines: bool, with_planes: bool = True) -> tuple:
    """The step's stages on a path, in the order of their ends: ``STAGES``,
    with lines on ``LINE_STAGES`` after ``associate``, and with planes on
    ``PLANE_SECTIONS`` inside ``plane_extract``, before it.  Planes keep their
    section either way; with them off it holds only the empty plane rows."""
    out = STAGES
    if with_lines:
        k = out.index("associate") + 1
        out = out[:k] + LINE_STAGES + out[k:]
    if with_planes:
        k = out.index("plane_extract")
        out = out[:k] + PLANE_SECTIONS + out[k:]
    return out


def stamps(with_lines: bool, with_planes: bool = True) -> tuple:
    """The stamps of one replay on a path: its start, then the end of each of
    :func:`stages`, a nested section's own start before its end."""
    out = ("start",)
    for name in stages(with_lines, with_planes):
        if name in PLANE_SECTIONS:
            out += (f"{name}.start",)
        out += (name,)
    return out


def sections(names) -> list:
    """(section, index of its first stamp, index of its last) of each stage
    and nested section of a replay's stamps ``names`` (:func:`stamps`), in the
    order of their ends: a stage runs from the end of the stage before it (the
    replay's start for the first), a nested section from its own start."""
    out, last, opened = [], 0, {}
    for i, name in enumerate(names[1:], 1):
        if name.endswith(".start"):
            opened[name[:-len(".start")]] = i
        elif name in opened:
            out.append((name, opened.pop(name), i))
        else:
            out.append((name, last, i))
            last = i
    return out


#: entries the event log holds; later ones are counted in ``dropped``
LOG_LIMIT = 1_000_000

#: the recorder of the run under way, and the stamp writer of the capture
#: under way, in this thread
_active = contextvars.ContextVar("recorder", default=None)
_stamper = contextvars.ContextVar("stamper", default=None)
_counter = contextvars.ContextVar("counter", default=None)
_NOTHING = contextlib.nullcontext()


#: the profiler's operation range, a private class of torch (tested with torch
#: 2.11 on the card and 2.13 on the CPU): where a torch release lacks it, spans
#: open no profiler range and stay host spans.
_FAST_RANGE = getattr(getattr(torch._C, "_profiler", None), "_RecordFunctionFast", None)


def _range(name: str):
    """A profiler range named ``name``, recorded as an operation (``cpu_op``)
    on the host's timeline.  A ``record_function`` range is a user annotation,
    which the profiler also copies onto the device's timeline over the kernels
    launched inside it, where a reader of device operations would count it as
    one."""
    return _FAST_RANGE(name)


class _Span:
    """One open span of a :class:`StageTimer`."""

    __slots__ = ("timer", "name", "start", "children", "range")

    def __init__(self, timer, name):
        self.timer = timer
        self.name = name

    def __enter__(self):
        self.range = None
        if _FAST_RANGE is not None and torch.autograd._profiler_enabled():
            self.range = _range(self.name)
            self.range.__enter__()
        self.children = 0
        self.timer._open.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        timer = self.timer
        timer._open.pop()
        ns = end - self.start
        name = self.name
        timer.totals[name] += 1e-9 * ns
        timer.counts[name] += 1
        timer.self_s[name] += 1e-9 * (ns - self.children)
        if ns > timer.max_ns[name]:
            timer.max_ns[name] = ns
        parent = timer._open[-1] if timer._open else None
        if parent is not None:
            parent.children += ns
        if timer.events is not None:
            timer._log(("span", name, self.start, end, parent.name if parent else None))
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


class StageTimer:
    """A run's recorder: nested host spans, counters and, with ``log``, an event
    log of at most ``LOG_LIMIT`` entries for :meth:`export`.  ``totals`` and
    ``counts`` hold every span's and every :meth:`record`'s seconds and calls
    by name, as the reference's report reads them."""

    def __init__(self, log: bool = False):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.self_s = defaultdict(float)
        self.max_ns = defaultdict(int)
        self.counters = defaultdict(int)
        #: the event log (None: off), and the entries it had no room for
        self.events = [] if log else None
        self.dropped = 0
        self._open = []

    def stage(self, name: str):
        """A span named ``name`` around a block, a child of the span open
        around it.  It reads the host clock once at each end and drains
        nothing: work it enqueues on the card is not waited for."""
        return _Span(self, name)

    def record(self, name: str, seconds: float):
        self.totals[name] += seconds
        self.counts[name] += 1

    def count(self, name: str, n: int = 1):
        self.counters[name] += n
        if self.events is not None:
            self._log(("counter", name, time.perf_counter_ns(), self.counters[name]))

    def device_stages(self, names, stamps, offset_ns: int):
        """One replay's stamps (ns of the card's ``%globaltimer``; ``names``
        the path's :func:`stamps` less ``start``) into the event log, as
        stages on the host clock: ``offset_ns`` is the card's clock less
        ``time.perf_counter_ns``."""
        if self.events is not None:
            self._log(("device", names, [int(t) - offset_ns for t in stamps]))

    def _log(self, entry):
        if len(self.events) < LOG_LIMIT:
            self.events.append(entry)
        else:
            self.dropped += 1

    def aggregates(self) -> dict:
        """{span name: {"count", "total_s", "self_s", "max_s"}} of every span."""
        return {name: {"count": self.counts[name], "total_s": self.totals[name],
                       "self_s": self.self_s[name], "max_s": 1e-9 * self.max_ns[name]}
                for name in self.max_ns}

    def export(self, path: str):
        """The event log as one Chrome trace (chrome://tracing, Perfetto): host
        spans on one track, the step graph's device stages on another, on the
        host clock in µs, and the counters."""
        if self.events is None:
            raise ValueError("the recorder was made without its event log (log=True)")
        pid = 1
        out = [{"name": "process_name", "ph": "M", "pid": pid, "args": {"name": "run_frames"}},
               {"name": "thread_name", "ph": "M", "pid": pid, "tid": 1,
                "args": {"name": "host"}},
               {"name": "thread_name", "ph": "M", "pid": pid, "tid": 2,
                "args": {"name": "device: step graph"}}]
        for entry in self.events:
            kind = entry[0]
            if kind == "span":
                _, name, start, end, parent = entry
                out.append({"name": name, "ph": "X", "pid": pid, "tid": 1, "ts": 1e-3 * start,
                            "dur": 1e-3 * (end - start), "args": {"parent": parent}})
            elif kind == "device":
                _, names, times = entry
                for stage, first, last in sections(("start", *names)):
                    out.append({"name": stage, "ph": "X", "pid": pid, "tid": 2,
                                "ts": 1e-3 * times[first],
                                "dur": 1e-3 * (times[last] - times[first])})
            else:
                _, name, t, value = entry
                out.append({"name": name, "ph": "C", "pid": pid, "ts": 1e-3 * t,
                            "args": {name: value}})
        with open(path, "w") as f:
            json.dump({"traceEvents": out, "displayTimeUnit": "ms",
                       "otherData": {"dropped": self.dropped}}, f)

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
def recording(timer: StageTimer):
    """Make ``timer`` the active recorder inside the block, in this thread."""
    token = _active.set(timer)
    try:
        yield timer
    finally:
        _active.reset(token)


def active() -> StageTimer | None:
    """The active recorder, or None."""
    return _active.get()


def span(name: str):
    """A span of the active recorder; with none, a block that records nothing."""
    timer = _active.get()
    return _NOTHING if timer is None else _Span(timer, name)


def count(name: str, n: int = 1):
    """Add ``n`` to a counter of the active recorder, if there is one."""
    timer = _active.get()
    if timer is not None:
        timer.count(name, n)


@contextlib.contextmanager
def stamping(stamper):
    """Inside the block, :func:`stamp` calls ``stamper(name)``: what a
    ``StepGraph`` capture with a recorder does."""
    token = _stamper.set(stamper)
    try:
        yield stamper
    finally:
        _stamper.reset(token)


def stamp(name: str):
    """The end of the step's section ``name`` (:func:`stamps`): a stamp node in the
    step graph under capture, and nothing anywhere else."""
    stamper = _stamper.get()
    if stamper is not None:
        stamper(name)


@contextlib.contextmanager
def counting(stepper):
    """Inside the block, :func:`count_cylinders` sets
    ``stepper.cylinders_live``: what a stepper does around the step it runs
    (in a ``StepGraph``, around the capture, so that it keeps the graph's own
    tensor, which each replay rewrites)."""
    token = _counter.set(stepper)
    try:
        yield
    finally:
        _counter.reset(token)


def count_cylinders(live):
    """The cylinder stage's selected live region slots (a device scalar), for
    the frame's summary; it is no ``StepOutput`` field, which stay the JAX
    package's.  Without a stepper counting, nothing."""
    stepper = _counter.get()
    if stepper is not None:
        stepper.cylinders_live = live
