"""kernels (the section ``line_tiles``: the tile pass and the tile graph's reach
closure): its share of its roofline, in %: the least time the section's
function needs on the card (``lines_work.line_tiles_work`` at the frame's size
over 67 TFLOP/s or 3.35 TB/s, ``measure.least_time_s``: bound by its bytes,
the image read once and the tile statistics and the closure written once)
over the section's device µs a frame in the replayed graph
(``graph_line_tiles_us``: its kernels and the gaps between its nodes).  None
where that reads nothing."""

from slambench import lines_work, measure, program_trace

NEEDS = ()
STAGE = "line_tiles"


def read(run):
    stats = program_trace.untraced(run)
    if not any(STAGE in getattr(s, "stage_device_us", {}) for s in stats):
        return None
    section_us = program_trace.stamped_us(run, "stage_device_us", STAGE)
    if not section_us:
        return None
    least_s, _ = measure.least_time_s(lines_work.line_tiles_work(*run.frame_hw))
    return 100.0 * least_s / (1e-6 * section_us)
