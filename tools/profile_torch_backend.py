"""Device time of the backend's solves on one NVIDIA card: the windowed BA's
refine and the pose graph's solve, as CUDA graph replays and eagerly.

    python tools/profile_torch_backend.py [--reps 4]

Builds the full-count problems of ``chip_smoke.py``'s ``backend_graph`` phase
(a window of 8 keyframes x 512 landmarks x 8 observations,
``chip_smoke.full_window``, and a pose graph of 64 nodes and 256 edges,
``chip_smoke.full_pose_graph``, two of each) and solves each, with the
runner's 8 BA and 10 graph iterations:

* as the graph: the ``solve_graph.SolveGraph`` that ``KeyframeWindow.refine``
  and ``PoseGraph.solve`` replay, recorded at its first call, then ``--reps``
  replays under ``torch.profiler``: kernels and device µs a solve; ms a solve
  on the host clock, the read back included (median of ``--reps``);
* eagerly (``solve_graph.EagerSolve``), the same, with the device time and
  kernels split into ``torch.profiler.record_function`` ranges that follow one
  another.  The BA: ``linearization`` (``parallel/ba._ba_blocks``: the
  residuals, the ``vmap(jvp)`` Jacobians and the Huber weights),
  ``assembly`` (the normal equations, the landmark blocks' inverses and the
  Schur complement), ``cholesky`` (``cholesky_ex`` and ``cholesky_solve`` of
  the reduced system), ``back_substitution`` (the landmarks' back-substitution
  and the update), ``other`` (unpacking the buffer, packing the result).  The
  pose graph: ``jacobians`` (the ``vmap`` of the edge residual's ``jvp``),
  ``assembly`` (the dense Jacobian, ``H = JᵀJ``, ``g = Jᵀr``, gauge and
  damping), ``cholesky``, ``update`` (the step and the cost), ``other``.  The
  ranges are opened by wrapping the functions at the phases' borders for the
  profiled calls only (``ba._ba_blocks``, ``ba.ba_solve``, ``pose_graph.vmap``,
  ``pose_graph.solve_pose_graph``, ``torch.linalg.cholesky_ex``,
  ``torch.cholesky_solve``): the library code carries no ranges.

Prints the card's name and power limit, then one JSON line.  Without a card it
exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import sys
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke  # noqa: E402
from profile_torch_step import range_breakdown  # noqa: E402
from rgbd_slam_tpu_torch import config, solve_graph  # noqa: E402
from rgbd_slam_tpu_torch.parallel import ba, keyframes, pose_graph  # noqa: E402


class Phases:
    """``record_function`` ranges named ``prefix`` + a phase, one after the
    other: opening one closes the one before."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self._open = None

    def enter(self, name: str):
        self.close()
        self._open = torch.profiler.record_function(self.prefix + name)
        self._open.__enter__()

    def close(self):
        if self._open is not None:
            self._open.__exit__(None, None, None)
            self._open = None

    def around(self, fn, before=None, after=None):
        """``fn`` that opens phase ``before`` before it runs and ``after``
        once it has returned (None: neither)."""
        @functools.wraps(fn)
        def call(*args, **kw):
            if before is not None:
                self.enter(before)
            out = fn(*args, **kw)
            if after is not None:
                self.enter(after)
            return out
        return call


@contextlib.contextmanager
def patched(*swaps):
    """Sets each ``(owner, name, value)`` for the block and restores it."""
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in swaps]
    for owner, name, value in swaps:
        setattr(owner, name, value)
    try:
        yield
    finally:
        for owner, name, value in reversed(saved):
            setattr(owner, name, value)


def ba_phases(phases: Phases):
    return patched(
        (ba, "_ba_blocks", phases.around(ba._ba_blocks, "linearization", "assembly")),
        (ba, "ba_solve", phases.around(ba.ba_solve, None, "other")),
        (torch.linalg, "cholesky_ex", phases.around(torch.linalg.cholesky_ex, "cholesky")),
        (torch, "cholesky_solve", phases.around(torch.cholesky_solve, None,
                                                "back_substitution")))


def pose_graph_phases(phases: Phases):
    real_vmap = pose_graph.vmap

    def vmap(*args, **kw):
        return phases.around(real_vmap(*args, **kw), "jacobians", "assembly")

    return patched(
        (pose_graph, "vmap", vmap),
        (pose_graph, "solve_pose_graph",
         phases.around(pose_graph.solve_pose_graph, None, "other")),
        (torch.linalg, "cholesky_ex", phases.around(torch.linalg.cholesky_ex, "cholesky")),
        (torch, "cholesky_solve", phases.around(torch.cholesky_solve, None, "update")))


def profiled_phases(fn, bufs, reps: int, phases: Phases, marks) -> dict:
    """``fn`` over ``reps`` calls (the buffers in turn) under the profiler,
    each call's phases marked by ``marks``: kernels and device µs a call, in
    all and by phase."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for r in range(reps):
            with marks(phases):
                phases.enter("other")
                fn(bufs[r % len(bufs)])
                phases.close()
        torch.cuda.synchronize()
    # a range also shows on the device's timeline: it is not a kernel
    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith(phases.prefix)]
    return dict(kernels=len(on_card) / reps,
                device_us=sum(e.time_range.elapsed_us() for e in on_card) / reps,
                phases=range_breakdown(prof, reps, phases.prefix))


def profile_solve(graph, fn, bufs, reps: int, prefix: str, marks) -> dict:
    """The solve ``graph`` replays, and ``fn`` eagerly, over ``bufs``."""
    eager = solve_graph.EagerSolve(fn, graph.device)
    graph(bufs[0])                       # records the graph
    eager(bufs[0])                       # and warms the eager path alike
    torch.cuda.synchronize()
    return dict(
        record_s=graph.record_s,
        graph=dict(ms=chip_smoke._ms_a_call(graph, bufs, reps),
                   **chip_smoke.profile_solves(graph, (bufs * reps)[:reps])),
        eager=dict(ms=chip_smoke._ms_a_call(eager, bufs, reps),
                   **profiled_phases(eager, bufs, reps, Phases(prefix), marks)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_backend: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = chip_smoke._card_line()
    print(card, flush=True)
    cam = config.TUM_FR1
    windows = [chip_smoke.full_window(cam, seed, device) for seed in (0, 1)]
    graphs = [chip_smoke.full_pose_graph(seed, device) for seed in (0, 1)]
    n_ba, n_pg = chip_smoke.BA_ITERATIONS, chip_smoke.GRAPH_ITERATIONS
    try:
        ba_solve = profile_solve(
            windows[0]._get_solver(cam, n_ba, None),
            functools.partial(windows[0]._solve, cam=cam, iterations=n_ba),
            [torch.from_numpy(keyframes._pack_problem(w.build_problem())) for w in windows],
            args.reps, "ba.", ba_phases)
        graph_solve = profile_solve(
            graphs[0]._get_solver(n_pg),
            functools.partial(pose_graph._solve_packed, max_nodes=graphs[0].max_nodes,
                              max_edges=graphs[0].max_edges, iterations=n_pg),
            [torch.from_numpy(g._pack()) for g in graphs], args.reps, "pose_graph.",
            pose_graph_phases)
    finally:
        windows[0].close()
        graphs[0].close()
    result = {"card": card, "torch": torch.__version__,
              "ba": dict(shape="8x512x8", iterations=n_ba, **ba_solve),
              "pose_graph": dict(shape="64x256", iterations=n_pg, **graph_solve)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
