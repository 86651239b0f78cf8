"""engine stages (``features.primitives.find_primitives``): device µs a frame
of the plane extraction, over eager steps after the window (a range cannot
live in the CUDA graph that the window replays)."""

NEEDS = ("stages",)


def read(run):
    if run.stages is None:
        return None
    return run.stages["stages_us"].get("plane_extract")
