"""device (H100): the share of a steady frame's wall time in which no
operation runs on the card, in %: one less the device's busy time a frame in
the device-only trace (frames 8 to 120 of the window's third sequence, the
union of its operations) over the wall time a frame of the same frames in the
untraced sequences (the median over them, host clock).  The trace slows the
host, so the traced frames' own wall time would measure the profiler."""

NEEDS = ("idle",)


def read(run):
    idle = run.idle
    if idle is None or idle["busy_s"] <= 0 or not idle.get("ms_a_frame_untraced"):
        return None
    return 100.0 * (1.0 - (idle["busy_s"] / idle["frames"]) / (1e-3 * idle["ms_a_frame_untraced"]))
