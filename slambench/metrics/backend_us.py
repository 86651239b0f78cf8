"""backend (``runner.run_frames``' refine step): host µs a frame in the span
``backend`` (the keyframe packs' read, the refine, its write-back, the pose-graph
solve and the trajectory's correction), over every frame of the sequences that
ran no profiler, each sequence's first refine and first solve included
(``RunStats.spans``)."""

from slambench import program_trace

NEEDS = ()


def read(run):
    return program_trace.span_us(run, "backend", per_frame=True)
