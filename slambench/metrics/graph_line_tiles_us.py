"""engine stages (``engine.step``'s section ``line_tiles``, lines on): device µs a
frame between the ``associate`` stamp and the ``line_tiles`` stamp in
``features.lines.detect_lines`` in the replayed step graph
(``RunStats.stage_device_us``), over the frames past each sequence's first in
the sequences that ran no profiler.  The section: the image's gradients, the
tiles' edge statistics, the tile graph's edges and its reach closure.  None
where no such sequence stamped the section (lines off, or a program whose
step has no such section)."""

from slambench import program_trace

NEEDS = ()
STAGE = "line_tiles"


def read(run):
    if not any(STAGE in getattr(s, "stage_device_us", {}) for s in program_trace.untraced(run)):
        return None
    return program_trace.stamped_us(run, "stage_device_us", STAGE)
