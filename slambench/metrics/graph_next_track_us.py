"""engine stages (``engine.step``'s section ``next_track``): device µs a frame between
the section's two stamps in the replayed step graph (``RunStats.stage_device_us``),
over the frames past each sequence's first in the sequences that ran no
profiler.  The section: the next tracked set and the tracking state."""

from slambench import program_trace

NEEDS = ()


def read(run):
    return program_trace.stamped_us(run, "stage_device_us", "next_track")
