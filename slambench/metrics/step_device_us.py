"""step graph (``step_graph.StepGraph``): device µs a frame of the operations
launched under the step's calls (its draws, the frame's copy and the graph's
replay), in the profiled part of the window."""

NEEDS = ("profile",)


def read(run):
    return None if run.profile is None else run.profile["step_device_us"]
