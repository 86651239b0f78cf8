"""engine stages (``engine.step``'s line matching and pose): line matches kept a
frame (``StepOutput.n_line_matches``: map lines matched and RANSAC inliers of a
tracked frame, summed in ``RunStats.line_matches``), over every frame of the
sequences that ran no profiler.  A speed-up that came from matching fewer
lines shows here.  None where no such sequence counted them (a program
without the count)."""

from slambench import program_trace

NEEDS = ()


def read(run):
    stats = [s for s in program_trace.untraced(run) if hasattr(s, "line_matches")]
    frames = sum(s.frame_count for s in stats)
    if not frames:
        return None
    return sum(s.line_matches for s in stats) / frames
