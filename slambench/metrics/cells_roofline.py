"""kernels (``ops/cells_cuda`` → ``csrc/cells.cu``): the per-cell pass's share
of its roofline, in %: the least time its work needs on the card (the larger
of its float operations over 67 TFLOP/s and its bytes over 3.35 TB/s,
``measure.cells_work``) over the device time of ``cells_fit_kernel`` and
``cells_edges_kernel`` a frame in the profiled graph replays."""

from slambench import measure

NEEDS = ("profile",)


def read(run):
    if run.profile is None or not run.profile["cells_us"]:
        return None
    h, w = run.frame_hw
    least_s, _ = measure.least_time_s(measure.cells_work(h, w, run.patch_px))
    return 100.0 * least_s / (1e-6 * run.profile["cells_us"])
