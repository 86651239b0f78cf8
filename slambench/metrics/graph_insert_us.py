"""engine stages (``engine.step``'s section ``insert``): device µs a frame between
the section's two stamps in the replayed step graph (``RunStats.stage_device_us``),
over the frames past each sequence's first in the sequences that ran no
profiler.  The section: the lifecycle, the 2D-to-3D upgrade and the insertion."""

from slambench import program_trace

NEEDS = ()


def read(run):
    return program_trace.stamped_us(run, "stage_device_us", "insert")
