"""engine stages (``engine.step``'s section ``detect``): device µs a frame between
the section's two stamps in the replayed step graph (``RunStats.stage_device_us``),
over the frames past each sequence's first in the sequences that ran no
profiler.  The section: FAST, BRIEF and their selection."""

from slambench import program_trace

NEEDS = ()


def read(run):
    return program_trace.stamped_us(run, "stage_device_us", "detect")
