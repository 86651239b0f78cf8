"""step graph (``step_graph.StepGraph``): device µs a frame from a replay's first
stamp (the start of ``engine.step``) to its last (the end of the copies into the
static state), on the card's clock (``RunStats.graph_span_us``), over the frames
past each sequence's first in the sequences that ran no profiler."""

from slambench import program_trace

NEEDS = ()


def read(run):
    return program_trace.stamped_us(run, "graph_span_us")
