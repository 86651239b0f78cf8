"""engine stages (``engine.step``'s section ``associate``): device µs a frame between
the section's two stamps in the replayed step graph (``RunStats.stage_device_us``),
over the frames past each sequence's first in the sequences that ran no
profiler.  The section: projection, descriptor and 2D matching, depth samples, lines."""

from slambench import program_trace

NEEDS = ()


def read(run):
    return program_trace.stamped_us(run, "stage_device_us", "associate")
