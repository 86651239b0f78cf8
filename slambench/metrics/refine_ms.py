"""backend (``parallel.keyframes.KeyframeWindow.refine``): ms of a windowed
bundle adjustment past each sequence's first (which records its CUDA graph),
on the host clock (``RunStats``), over the window's sequences."""

NEEDS = ()


def read(run):
    runs = sum(max(s.stats.ba_runs - 1, 0) for s in run.sequences)
    if runs == 0:
        return None
    total = sum(s.stats.ba_total_s - s.stats.ba_compile_s for s in run.sequences
                if s.stats.ba_runs > 1)
    return 1e3 * total / runs
