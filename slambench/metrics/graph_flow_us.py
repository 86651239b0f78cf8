"""engine stages (``engine.step``'s section ``flow``): device µs a frame between
the section's two stamps in the replayed step graph (``RunStats.stage_device_us``),
over the frames past each sequence's first in the sequences that ran no
profiler.  The section: the predicted pose, the pyramid and ``track_forward_backward``."""

from slambench import program_trace

NEEDS = ()


def read(run):
    return program_trace.stamped_us(run, "stage_device_us", "flow")
