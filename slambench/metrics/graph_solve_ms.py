"""backend (``parallel.pose_graph.PoseGraph.solve``): ms of a pose-graph solve
past each sequence's first (which records its CUDA graph), on the host clock
(``RunStats``), over the window's sequences."""

NEEDS = ()


def read(run):
    solves = sum(max(s.stats.graph_solves - 1, 0) for s in run.sequences)
    if solves == 0:
        return None
    total = sum(s.stats.graph_total_s - s.stats.graph_first_s for s in run.sequences
                if s.stats.graph_solves > 1)
    return 1e3 * total / solves
