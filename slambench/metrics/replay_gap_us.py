"""step graph (``step_graph.StepGraph``): device µs a frame from one replay's
last stamp to the next replay's first (``RunStats.replay_gap_us``): what the
card spends between replays, idle while the host draws, loads, drains and runs
the backend, or on the draws' copies and the backend's own graphs; over the
frames past each sequence's first in the sequences that ran no profiler."""

from slambench import program_trace

NEEDS = ()


def read(run):
    return program_trace.stamped_us(run, "replay_gap_us")
