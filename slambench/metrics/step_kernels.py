"""step graph (``step_graph.StepGraph``): device operations a frame launched
under the step's calls, in the profiled part of the window."""

NEEDS = ("profile",)


def read(run):
    return None if run.profile is None else run.profile["step_kernels"]
