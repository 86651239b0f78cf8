"""What the program's own trace left in ``RunStats``: the runner's host spans,
and the device stamps of the step's CUDA graph (``graph_span_us``,
``replay_gap_us``, ``stage_device_us``, over ``stamped_frames``) and of the
frames' uploads (``upload_device_us`` over ``upload_frames``).

The per-layer metrics that read them (``graph_span_us``, ``replay_gap_us``,
``graph_<stage>_us``, ``upload_us``, ``backend_us``) take the window's
sequences that ran no profiler: all but the second and the third, which a
traced run profiles and which the profiler slows.  Where the program records
none of it (a program before its trace), each reads None.
"""

from __future__ import annotations

#: the window's sequences a traced run profiles: ``harness._window`` names them
#: inline (its ``one_sequence`` and its untraced ``plain`` frames), with no
#: constant to import; a test holds the two to the same indexes
PROFILED = (1, 2)


def untraced(run) -> list:
    """The ``RunStats`` of the sequences that ran no profiler."""
    return [s.stats for k, s in enumerate(run.sequences) if k not in PROFILED]


def stamped_us(run, field: str, stage: str | None = None, frames: str = "stamped_frames"):
    """Device µs a frame of a stamp sum of ``RunStats`` (``field``; with
    ``stage``, that stage of ``stage_device_us``) over the frames it sums
    (``frames``: by default the stamped frames, every frame past a
    sequence's first)."""
    stats = untraced(run)
    frames = sum(getattr(s, frames, 0) for s in stats)
    if not frames:
        return None
    if stage is None:
        return sum(getattr(s, field) for s in stats) / frames
    return sum(getattr(s, field).get(stage, 0.0) for s in stats) / frames


def span_us(run, name: str, per_frame: bool = False):
    """Host µs of the span ``name``: a call (or, with ``per_frame``, a frame
    of every sequence's frames)."""
    stats = untraced(run)
    found = [s.spans[name] for s in stats if name in getattr(s, "spans", {})]
    if not found:
        return None
    over = sum(s.frame_count for s in stats) if per_frame else sum(f["count"] for f in found)
    return 1e6 * sum(f["total_s"] for f in found) / over if over else None
