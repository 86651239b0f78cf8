"""engine stages (the cylinder stage, nested in ``plane_extract``): device µs a
frame between the ``cylinders.start`` and ``cylinders`` stamps around
``ops.cylinders_cuda.cylinder_stage`` in ``features.primitives.find_primitives``
in the replayed step graph (``RunStats.stage_device_us["cylinders"]``: the
kernel and the gaps around its node), over the frames past each sequence's
first in the sequences that ran no profiler.  None where no such sequence
stamped the section (planes off, or a program whose step has no such
section)."""

from slambench import program_trace

NEEDS = ()
STAGE = "cylinders"


def read(run):
    if not any(STAGE in getattr(s, "stage_device_us", {}) for s in program_trace.untraced(run)):
        return None
    return program_trace.stamped_us(run, "stage_device_us", STAGE)
