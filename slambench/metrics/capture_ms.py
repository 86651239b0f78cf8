"""runner (``runner.run_frames``): ms of a timed sequence's first frame, which
holds the step's warm-up, the capture of its CUDA graph and the first replay
(``RunStats.compile_s``), the mean over the window's sequences."""

NEEDS = ()


def read(run):
    if not run.sequences:
        return None
    return 1e3 * sum(s.stats.compile_s for s in run.sequences) / len(run.sequences)
