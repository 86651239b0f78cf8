"""kernels (``ops/cylinders_cuda`` → ``csrc/cylinders.cu``, the cylinder stage):
its share of its roofline, in %: the least time the stage's work needs on the
card (``cylinders_work.stage_work`` at the frame's grid with the sequences'
mean live region slots a frame, ``RunStats.cylinders_live``, over 67 TFLOP/s
or 3.35 TB/s, ``measure.least_time_s``; with no live slot its bytes bound it)
over the section's device µs a frame in the replayed graph
(``graph_cylinders_us``).  None where that reads nothing, or where the program
counts no live slots."""

from slambench import cylinders_work, measure, program_trace

NEEDS = ()
STAGE = "cylinders"


def read(run):
    stats = program_trace.untraced(run)
    if not any(STAGE in getattr(s, "stage_device_us", {}) for s in stats):
        return None
    if not all(hasattr(s, "cylinders_live") for s in stats):
        return None
    section_us = program_trace.stamped_us(run, "stage_device_us", STAGE)
    frames = sum(s.frame_count for s in stats)
    if not section_us or not frames:
        return None
    live = sum(s.cylinders_live for s in stats) / frames
    least_s, _ = measure.least_time_s(cylinders_work.stage_work(*run.frame_hw, run.patch_px,
                                                                live))
    return 100.0 * least_s / (1e-6 * section_us)
