"""engine stages (``engine.step``'s section ``lines``, lines on): device µs a
frame between the ``line_tiles`` stamp and the ``lines`` stamp in the replayed
step graph (``RunStats.stage_device_us``), over the frames past each
sequence's first in the sequences that ran no profiler.  The section: the
seeds' growth over the closure, the segments, their endpoint depths and the
matching to the line map.  None where no such sequence stamped the section."""

from slambench import program_trace

NEEDS = ()
STAGE = "lines"


def read(run):
    if not any(STAGE in getattr(s, "stage_device_us", {}) for s in program_trace.untraced(run)):
        return None
    return program_trace.stamped_us(run, "stage_device_us", STAGE)
