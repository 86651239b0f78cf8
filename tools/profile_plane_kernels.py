"""Times, output hashes and phase split of the plane extraction's three kernels
on the card.

``python tools/profile_plane_kernels.py time`` times the per-cell pass
(``csrc/cells.cu``), the connected components (``csrc/components.cu``) and
the cylinder stage (``csrc/cylinders.cu``) on the three depth maps at 640x480
of ``chip_smoke.TIMED_FRAMES`` (``frame_kinds``: a RoomScene orbit frame whose
cylinder stage holds no live region, one that holds two, and a tunnel frame
that holds one; the components kernel on the cell graph the card's cell pass
makes of each, and on ``chip_smoke.serpentine_grid``'s 32x24 snake).  For each it
prints the device µs a launch replayed from a CUDA graph of 50
(``chip_smoke``'s ``graph_launch_us``: the kernel warm in the caches) and
``chip_smoke.output_digest`` of the kernels' inputs and outputs (the cylinder
stage's inputs are what the card's ``find_primitives`` makes); then each
kernel's device µs a frame inside the plane step's CUDA graph
(``in_graph_step_us``), where it runs between the step's other kernels.  Run
from another tree, it times that tree's kernels: copy it and ``chip_smoke.py``
into a ``git archive`` of another commit and run both trees in one call to
compare them on one card.

``python tools/profile_plane_kernels.py graph`` runs ``chip_smoke.py``'s
``graph`` phase alone (the plane step over 30 frames eagerly and as one CUDA
graph, 4 replays profiled: device µs and kernels a frame), after building
every kernel; like ``time``, it runs that of the tree it is copied into.

``python tools/profile_plane_kernels.py variants [NAME ...]`` times the
design's alternatives (``VARIANTS``: other CTA and cluster sizes, rolled
loops, the components kernel without its pointer jump or with two, with
volatile label reads or its flags read again every round, built from text
edits of the tree's sources) beside the tree's kernels, in the order tree,
variants, the variants reversed, tree, with each one's output hash and its
device µs a frame inside the plane step's graph.

``python tools/profile_plane_kernels.py split`` splits the kernels' device
time into their phases.  It builds a copy of each source with ``clock64()``
stamps at the phase boundaries (``STAMPS``), inserted by text edits into the
git-ignored build directory (the tree's sources stay as they are), runs them
on the three frames and prints the mean µs of each phase by row: for the
cells a warp's fit (lane 0 of one warp in 16), for the cylinders a CTA's
(thread 0, one row a slot; the rounds' phases summed over the rounds), for the
components the CTA's thread 0 (a phase whose name ends in ``_count`` counts
events a launch, not µs), at the SM clock measured by a spinning kernel.  It
also times the cell pass without its edges launch, so the edges' share shows.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from rgbd_slam_tpu_torch import config  # noqa: E402
from rgbd_slam_tpu_torch.ops import cells_cuda, components_cuda, cylinders_cuda  # noqa: E402

#: the stamps' macros and readers, put after the sources' includes
_SPLIT_HEAD = r"""
__device__ unsigned long long g_split[8][16];
#define SPLIT_BEGIN(cond) const bool _split_on = (cond); \
  long long _split_acc[15] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}; \
  long long _split_last = clock64();
#define SPLIT(p) do { if (_split_on) { const long long _n = clock64(); \
  _split_acc[p] += _n - _split_last; _split_last = _n; } } while (0)
#define SPLIT_COUNT(p) do { if (_split_on) _split_acc[p] += 1; } while (0)
#define SPLIT_END(row) do { if (_split_on) { \
  _Pragma("unroll") for (int _p = 0; _p < 15; ++_p) \
    atomicAdd(&g_split[row][_p], (unsigned long long)_split_acc[_p]); \
  atomicAdd(&g_split[row][15], 1ull); } } while (0)
extern "C" int split_read(unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(out, g_split, sizeof(g_split));
  static unsigned long long zero[8][16];
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_split, zero, sizeof(zero));
  return (int)e;
}
__global__ void split_spin(long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {}
}
extern "C" int split_spin_launch(long long cycles, void* stream) {
  split_spin<<<1, 32, 0, (cudaStream_t)stream>>>(cycles);
  return (int)cudaGetLastError();
}
"""
_INCLUDE = '#include "eig3.cuh"\n'
#: {source: ([(text, replacement)], phase names)}: the ``clock64()`` stamps
#: of the tree's sources; the cells' on one warp in 16, to keep the stamps'
#: own atomics few
STAMPS = {
    "cells.cu": ([
        (_INCLUDE, _INCLUDE + _SPLIT_HEAD),
        ("  const float inv_p = 1.0f / (float)P;\n",   # one warp in 16: fewer atomics
         "  const float inv_p = 1.0f / (float)P;\n  SPLIT_BEGIN(lane == 0 && cell % 16 == 0);\n"),
        ("      if (32 * j < ppc) patch_px[lane + 32 * j] = dep[j];\n  }\n",
         "      if (32 * j < ppc) patch_px[lane + 32 * j] = dep[j];\n  }\n  SPLIT(0);\n"),
        ("  const float mu0 = s0 / safe, mu1 = s1 / safe, mu2 = s2 / safe;\n",
         "  const float mu0 = s0 / safe, mu1 = s1 / safe, mu2 = s2 / safe;\n  SPLIT(1);\n"),
        ("  m22 = warp_sum(m22);\n", "  m22 = warp_sum(m22);\n  SPLIT(2);\n"),
        ("  const bool continuous = __ballot_sync(FULL_MASK, broken) == 0u;\n",
         "  const bool continuous = __ballot_sync(FULL_MASK, broken) == 0u;\n  SPLIT(3);\n"),
        ("  sym_eig3_smallest(c00, c11, c22, c01, c02, c12, vals, n);\n",
         "  sym_eig3_smallest(c00, c11, c22, c01, c02, c12, vals, n);\n  SPLIT(4);\n"),
        ("  // polar-angle histogram bin of the normal (_normal_bins)",
         "  SPLIT(5);\n  // polar-angle histogram bin of the normal (_normal_bins)"),
        ("    a.centers_valid[cell] = cvalid ? 1 : 0;\n  }\n}",
         "    a.centers_valid[cell] = cvalid ? 1 : 0;\n  }\n  SPLIT(6);\n  SPLIT_END(0);\n}"),
    ], ("loads", "pass1", "pass2", "continuity", "eig3", "gates_and_tolerance",
        "bin_and_stores")),
    "cylinders.cu": ([
        (_INCLUDE, _INCLUDE + _SPLIT_HEAD),
        ("  const int n_slots = gridDim.x / CYL_CLUSTER;\n",
         "  const int n_slots = gridDim.x / CYL_CLUSTER;\n  SPLIT_BEGIN(threadIdx.x == 0);\n"),
        ("    stage_wait();\n    __syncthreads();\n  }\n",
         "    stage_wait();\n    __syncthreads();\n  }\n  SPLIT(0);\n"),
        ("    for (int j = 0; j < 7; ++j) acc[j] = warp_sum(acc[j]);\n",
         "    for (int j = 0; j < 7; ++j) acc[j] = warp_sum(acc[j]);\n    SPLIT(1);\n"),
        ("    gate_ok = (score >= a.min_score) && (acc[6] >= 3.0f);\n",
         "    gate_ok = (score >= a.min_score) && (acc[6] >= 3.0f);\n    SPLIT(2);\n"),
        ("  cluster.sync();\n\n  // ---- the selection",
         "  cluster.sync();\n  SPLIT(3);\n\n  // ---- the selection"),
        ("  const int s_n = a.subsegments;\n", "  const int s_n = a.subsegments;\n  SPLIT(4);\n"),
        ("  if (slot >= s_nsel) return;\n",
         "  SPLIT(5);\n  if (slot >= s_nsel) { SPLIT_END(slot); return; }\n"),
        ("  }\n  __syncthreads();\n\n  float cnt0 = 0.0f;",
         "  }\n  __syncthreads();\n  SPLIT(6);\n\n  float cnt0 = 0.0f;"),
        ("    if (si == 0) cnt0 = (float)n_rem;\n    __syncthreads();\n",
         "    if (si == 0) cnt0 = (float)n_rem;\n    __syncthreads();\n    SPLIT(7);\n"),
        ("      continue;   // n_rem", "      SPLIT(14);\n      continue;   // n_rem"),
        ("      s_hyp[b][4] = hb.hs;\n    }\n    __syncthreads();\n",
         "      s_hyp[b][4] = hb.hs;\n    }\n    __syncthreads();\n    SPLIT(8);\n"),
        ("    cluster.sync();\n\n    // the first minimum",
         "    cluster.sync();\n    SPLIT(9);\n\n    // the first minimum"),
        ("    const Hypothesis hbest = stored_hypothesis(s_hyp[s_best]);\n",
         "    const Hypothesis hbest = stored_hypothesis(s_hyp[s_best]);\n    SPLIT(10);\n"),
        ("    block_sums(sums, 8, s_red[0]);\n",
         "    block_sums(sums, 8, s_red[0]);\n    SPLIT(11);\n"),
        ("    block_sums(&sq, 1, s_red[1]);\n",
         "    block_sums(&sq, 1, s_red[1]);\n    SPLIT(12);\n"),
        ("      if (lane == 0) s_mask[i0 >> 5] = bits;\n    }\n    __syncthreads();\n  }\n}",
         "      if (lane == 0) s_mask[i0 >> 5] = bits;\n    }\n    __syncthreads();\n"
         "    SPLIT(13);\n"
         "  }\n  SPLIT_END(slot);\n}"),
    ], ("staging", "gate_sums", "gate_eig3", "gate_sync", "selection", "fills", "projection",
        "compaction", "hypotheses", "scoring", "argmin", "refit", "mse", "writes",
        "empty_round")),
}
STAMPS["components.cu"] = ([
    ("#include <stdint.h>\n", "#include <stdint.h>\n" + _SPLIT_HEAD),
    ("  const int lane = threadIdx.x & 31;\n\n",
     "  const int lane = threadIdx.x & 31;\n  SPLIT_BEGIN(threadIdx.x == 0);\n\n"),
    ("  __syncthreads();\n\n  // the flags of a lane past the grid",
     "  __syncthreads();\n  SPLIT(0);\n\n  // the flags of a lane past the grid"),
    ("    while (__syncthreads_or(cc_step(lbl, i, f, own, gw, lane))) {}\n",
     "    while (true) {\n"
     "      const int changed = __syncthreads_or(cc_step(lbl, i, f, own, gw, lane));\n"
     "      if (changed) SPLIT(1); else SPLIT(2);\n      SPLIT_COUNT(4);\n"
     "      if (!changed) break;\n    }\n"),
    ("labels[i] = (int64_t)lbl[i];\n}",
     "labels[i] = (int64_t)lbl[i];\n  SPLIT(3);\n  SPLIT_END(0);\n}"),
], ("flags", "rounds_that_changed", "last_round", "labels", "round_count"))
#: the cell pass's second launch, removed to time the fit kernel alone
_EDGES_LAUNCH = ("  cells_edges_kernel<<<(c + EDGES_THREADS - 1) / EDGES_THREADS, EDGES_THREADS, "
                 "0, s>>>(a);\n  return (int)cudaGetLastError();")
#: the spinning kernel's cycles, to measure the SM clock
_SPIN_CYCLES = 4_000_000


def frame_kinds(device):
    """{kind: (name, depth on the card, cylinder-stage inputs, live slots, cell
    graph)} of ``chip_smoke.TIMED_FRAMES``; the cell graph is the components
    kernel's input (``chip_smoke.cell_graph``: edges, planar, gh, gw)."""
    import chip_smoke

    cam, det = config.TUM_FR1, config.SlamConfig().detection
    n = {src: 1 + max(i for s, i in chip_smoke.TIMED_FRAMES.values() if s == src)
         for src, _ in chip_smoke.TIMED_FRAMES.values()}
    room, _ = chip_smoke.room_frames(cam, n["room"])
    depths = chip_smoke.timed_depths(room, chip_smoke._tunnel_depths(cam, n["tunnel"]), device)
    found = {}
    for kind, dep in depths.items():
        inputs = chip_smoke.cylinder_inputs(cam, det, dep)
        grid, member, try_cyl, min_act = inputs
        live = int(cylinders_cuda.cylinder_stage(grid, member, try_cyl, det, min_act)
                   .selected.sum())
        found[kind] = ("%s%d" % chip_smoke.TIMED_FRAMES[kind], dep, inputs, live,
                       chip_smoke.cell_graph(cam, config.SlamConfig(), dep, device))
    return found


def component_graphs(kinds, device):
    """{kind: cell graph} of the components kernel's timed inputs: the three
    frames' and the serpentine's through the same 32x24 grid."""
    import chip_smoke

    graphs = {kind: graph for kind, (*_, graph) in kinds.items()}
    gh, gw = next(iter(graphs.values()))[2:]
    return {**graphs, "serpentine": chip_smoke.grid_tensors(chip_smoke.serpentine_grid(gh, gw),
                                                            device)}


def _calls(module, kinds):
    """{kind: a call of ``module``'s kernel that returns its outputs} on the
    timed inputs: ``frame_kinds``' three frames, and for the components
    kernel also the serpentine (``component_graphs``)."""
    cam, det = config.TUM_FR1, config.SlamConfig().detection
    if module is components_cuda:
        return {kind: (lambda g=graph: [components_cuda.connected_components(*g)])
                for kind, graph in component_graphs(kinds, torch.device("cuda", 0)).items()}
    if module is cells_cuda:
        return {kind: (lambda d=depth: cells_cuda.cell_pass(d, cam, det))
                for kind, (_, depth, *_) in kinds.items()}
    return {kind: (lambda x=inputs: cylinders_cuda.cylinder_stage(*x[:3], det, x[3]))
            for kind, (_, _, inputs, *_) in kinds.items()}


def _time_kinds(kinds, with_hashes=True):
    import chip_smoke

    cam, det = config.TUM_FR1, config.SlamConfig().detection
    for kind, (name, depth, (grid, member, try_cyl, min_act), live, _) in kinds.items():
        def cells():
            return cells_cuda.cell_pass(depth, cam, det)

        def cylinders():
            return cylinders_cuda.cylinder_stage(grid, member, try_cyl, det, min_act)

        out = dict(kind=kind, frame=name, live=live,
                   cells_device_us=chip_smoke.graph_launch_us(cells),
                   cylinders_device_us=chip_smoke.graph_launch_us(cylinders))
        if with_hashes:
            digest = chip_smoke.output_digest
            out.update(cells_inputs=digest([depth]), cells_outputs=digest(cells()),
                       cylinders_inputs=digest([grid.normal, grid.mean, grid.planar, member,
                                                try_cyl, torch.tensor(min_act)]),
                       cylinders_outputs=digest(cylinders()))
        print(json.dumps(out), flush=True)
    graphs = component_graphs(kinds, torch.device("cuda", 0))
    for kind, components in _calls(components_cuda, kinds).items():
        out = dict(kind=kind, components_device_us=chip_smoke.graph_launch_us(components))
        if with_hashes:
            out.update(components_inputs=chip_smoke.output_digest(graphs[kind][:2]),
                       components_outputs=chip_smoke.output_digest(components()))
        print(json.dumps(out), flush=True)


def in_graph_step_us(n_frames: int = 16, profiled: int = 8) -> dict:
    """Device µs a frame of each of the three kernels where the main path runs
    them: inside the plane step's CUDA graph (``step_graph.StepGraph``) over
    the plane path's first ``n_frames`` room frames, the last ``profiled``
    under the profiler.  There the kernels run between the step's other
    kernels, with their code and inputs as those leave the caches, where the
    graph of 50 launches of one kernel (``time``) runs them warm."""
    import chip_smoke
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rgbd_slam_tpu_torch import engine, runner, step_graph

    device = torch.device("cuda", 0)
    cam, cfg = config.TUM_FR1, config.SlamConfig()
    frames, _ = chip_smoke.room_frames(cam, n_frames)
    staged = runner.stage_frames(frames, device=device)
    graph = step_graph.StepGraph(engine.init_state(cam, cfg, seed=0, device=device), cam, cfg)
    try:
        for gray, depth in staged[:-profiled]:
            graph.step(gray, depth)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for gray, depth in staged[-profiled:]:
                graph.step(gray, depth)
            torch.cuda.synchronize()
    finally:
        graph.close()
    out = {"cells": 0.0, "components": 0.0, "cylinders": 0.0}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for name in out:
                if e.name.startswith(name + "_"):
                    out[name] += e.time_range.elapsed_us() / profiled
    return out


def run_time():
    import chip_smoke

    device = torch.device("cuda", 0)
    print(json.dumps(dict(card=chip_smoke._card_line(), torch=torch.__version__,
                          build_s=[m.LIBRARY.build() for m in _MODULES.values()],
                          ptxas=_ptxas())),
          flush=True)
    _time_kinds(frame_kinds(device))
    print(json.dumps(dict(in_graph_step_us_a_frame=in_graph_step_us())), flush=True)


#: the tool's kernels by source
_MODULES = {"cells.cu": cells_cuda, "components.cu": components_cuda,
            "cylinders.cu": cylinders_cuda}


def _ptxas() -> dict:
    import chip_smoke

    return {kernel: usage for m in _MODULES.values()
            for kernel, usage in chip_smoke.ptxas_usage(m.LIBRARY.log).items()}


def _sm_cycles_per_us(lib) -> float:
    lib.split_spin_launch.argtypes = [ctypes.c_longlong, ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    lib.split_spin_launch(_SPIN_CYCLES, stream)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    lib.split_spin_launch(_SPIN_CYCLES, stream)
    end.record()
    end.synchronize()
    return _SPIN_CYCLES / (start.elapsed_time(end) * 1e3)


def _read_split(lib):
    buf = np.zeros((8, 16), dtype=np.uint64)
    lib.split_read.argtypes = [ctypes.c_void_p]
    err = lib.split_read(buf.ctypes.data)
    if err:
        raise RuntimeError(f"split_read: cudaError {err}")
    return buf


def _build_edited(module, source: str, edits, tmp: str):
    from rgbd_slam_tpu_torch.ops import nvcc

    with open(os.path.join(nvcc.CSRC, source)) as f:
        text = f.read()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{source}: {old!r} is not in the source")
        text = text.replace(old, new)
    for name in os.listdir(nvcc.CSRC):
        if name.endswith(".cuh"):
            with open(os.path.join(nvcc.CSRC, name)) as f, \
                    open(os.path.join(tmp, name), "w") as g:
                g.write(f.read())
    with open(os.path.join(tmp, source), "w") as f:
        f.write(text)
    csrc = nvcc.CSRC
    nvcc.CSRC, module.LIBRARY.lib = tmp, None
    try:
        module.LIBRARY.build()
    finally:
        nvcc.CSRC = csrc
    return module.LIBRARY.lib


def _rows(buf, phases, rate):
    """{row: {phase: mean µs (a ``*_count`` phase: mean events), "count": n}}
    of the rows that counted anything."""
    return {f"row{r}": {"count": int(buf[r, 15]),
                        **{p: float(buf[r, i]) / float(buf[r, 15])
                           / (1.0 if p.endswith("_count") else rate)
                           for i, p in enumerate(phases)}}
            for r in range(buf.shape[0]) if buf[r, 15]}


def run_split(reps: int = 20):
    import chip_smoke
    from rgbd_slam_tpu_torch.ops import nvcc

    device = torch.device("cuda", 0)
    cam, det = config.TUM_FR1, config.SlamConfig().detection
    kinds = frame_kinds(device)   # with the tree's kernels as they are
    print(json.dumps(dict(card=chip_smoke._card_line(), torch=torch.__version__)), flush=True)
    os.makedirs(nvcc.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=nvcc.BUILD_DIR) as tmp:
        try:
            cells_lib = _build_edited(cells_cuda, "cells.cu", STAMPS["cells.cu"][0], tmp)
            cyl_lib = _build_edited(cylinders_cuda, "cylinders.cu", STAMPS["cylinders.cu"][0],
                                    tmp)
            cc_lib = _build_edited(components_cuda, "components.cu",
                                   STAMPS["components.cu"][0], tmp)
            rate = _sm_cycles_per_us(cells_lib)
            print(json.dumps(dict(sm_cycles_per_us=rate, ptxas=_ptxas())), flush=True)
            for kind, graph in component_graphs(kinds, device).items():
                _read_split(cc_lib)
                for _ in range(reps):
                    components_cuda.connected_components(*graph)
                print(json.dumps(dict(kind=kind, unit="us", components=_rows(
                    _read_split(cc_lib), STAMPS["components.cu"][1], rate))), flush=True)
            for kind, (frame, depth, (grid, member, try_cyl, min_act), live, _) in kinds.items():
                _read_split(cells_lib)
                for _ in range(reps):
                    cells_cuda.cell_pass(depth, cam, det)
                cells = _rows(_read_split(cells_lib), STAMPS["cells.cu"][1], rate)
                _read_split(cyl_lib)
                for _ in range(reps):
                    cylinders_cuda.cylinder_stage(grid, member, try_cyl, det, min_act)
                cylinders = _rows(_read_split(cyl_lib), STAMPS["cylinders.cu"][1], rate)
                print(json.dumps(dict(kind=kind, frame=frame, live=live, unit="us", cells=cells,
                                      cylinders=cylinders)), flush=True)
            # the fit kernel alone: the edges' share of the cell pass
            stamps = STAMPS["cells.cu"][0]
            no_edges = [(_EDGES_LAUNCH, "  return (int)cudaSuccess;")]
            timed = {}
            for variant, edits in (("stamped", stamps),
                                   ("stamped_without_edges", stamps + no_edges),
                                   ("without_edges", stamps[:1] + no_edges)):
                sub = os.path.join(tmp, variant)
                os.makedirs(sub)
                _build_edited(cells_cuda, "cells.cu", edits, sub)
                depth = kinds["room_none"][1]
                timed[f"{variant}_us"] = chip_smoke.graph_launch_us(
                    lambda: cells_cuda.cell_pass(depth, cam, det))
            print(json.dumps(dict(cells_pass=timed)), flush=True)
        finally:
            for module in _MODULES.values():
                module.LIBRARY.lib = None
    _time_kinds(kinds, with_hashes=False)


#: {name: (source, [(text, replacement)])}: the design's alternatives that
#: ``variants`` times beside the tree's kernels (their outputs must keep the
#: tree's bits)
VARIANTS = {
    "cylinders_gate_rolled": ("cylinders.cu", [(
        "#pragma unroll 4\n    for (int i = lane; i < c; i += 32) {\n      const float wt",
        "#pragma unroll 1\n    for (int i = lane; i < c; i += 32) {\n      const float wt")]),
    "cylinders_scoring_rolled": ("cylinders.cu", [(
        "#pragma unroll 4\n      for (int i = lane; i < c; i += 32) {\n        const float d2",
        "#pragma unroll 1\n      for (int i = lane; i < c; i += 32) {\n        const float d2")]),
    "cells_warps_4": ("cells.cu", [("#define CELLS_WARPS 6", "#define CELLS_WARPS 4")]),
    "cells_warps_8": ("cells.cu", [("#define CELLS_WARPS 6", "#define CELLS_WARPS 8")]),
    "cylinders_cluster_2": ("cylinders.cu", [("#define CYL_CLUSTER 4", "#define CYL_CLUSTER 2")]),
    "cylinders_cluster_8": ("cylinders.cu", [("#define CYL_CLUSTER 4", "#define CYL_CLUSTER 8")]),
    # no pointer jump, and two a round as the JAX loop takes
    "components_no_jump": ("components.cu", [(
        "  m = min(m, lbl[m]);   // pointer jump: a cell may adopt its label's own label\n", "")]),
    "components_two_jumps": ("components.cu", [(
        "  m = min(m, lbl[m]);   // pointer jump: a cell may adopt its label's own label\n",
        "  m = min(m, lbl[m]);\n  m = min(m, lbl[m]);\n")]),
    # the labels read as volatile, as the first design read them
    "components_volatile_reads": ("components.cu", [
        ("__device__ __forceinline__ int cc_step(int* lbl,",
         "__device__ __forceinline__ int cc_step(volatile int* lbl,"),
        ("  int* lbl = reinterpret_cast<int*>(cc_smem);",
         "  volatile int* lbl = reinterpret_cast<int*>(cc_smem);")]),
    # a lone cell's flags read again every round, as a thread of several cells does
    "components_flags_reloaded": ("components.cu", [
        ("  if (c <= (int)blockDim.x) {", "  if (false) {")]),
}


def run_variants(names):
    """Time the ``VARIANTS`` named beside the tree's kernels, in the order
    tree, variants, variants reversed, tree, on the three frames."""
    import chip_smoke
    from rgbd_slam_tpu_torch.ops import nvcc

    device = torch.device("cuda", 0)
    kinds = frame_kinds(device)
    print(json.dumps(dict(card=chip_smoke._card_line(), torch=torch.__version__)), flush=True)
    modules = _MODULES
    os.makedirs(nvcc.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=nvcc.BUILD_DIR) as tmp:
        try:
            for name in ["tree", *names, *reversed(names), "tree"]:
                sources = [VARIANTS[name][0]] if name in VARIANTS else list(modules)
                out = dict(variant=name)
                for source in sources:
                    module = modules[source]
                    sub = os.path.join(tmp, str(len(os.listdir(tmp))))
                    os.makedirs(sub)
                    _build_edited(module, source, VARIANTS[name][1] if name in VARIANTS else [],
                                  sub)
                    out[f"{source}_ptxas"] = chip_smoke.ptxas_usage(module.LIBRARY.log)
                    for kind, call in _calls(module, kinds).items():
                        out[f"{source}_{kind}_us"] = chip_smoke.graph_launch_us(call)
                        out[f"{source}_{kind}_bits"] = chip_smoke.output_digest(call())
                out["in_graph_step_us_a_frame"] = in_graph_step_us()
                print(json.dumps(out), flush=True)
        finally:
            for module in modules.values():
                module.LIBRARY.lib = None


def run_graph():
    from concurrent.futures import ThreadPoolExecutor

    import chip_smoke
    from rgbd_slam_tpu_torch.ops import components_cuda, lk_cuda, lm_cuda

    with ThreadPoolExecutor(5) as pool:
        for job in [pool.submit(m.build) for m in (lk_cuda, components_cuda, cells_cuda,
                                                    cylinders_cuda, lm_cuda)]:
            job.result()
    cam, cfg = config.TUM_FR1, config.SlamConfig()
    frames, _ = chip_smoke.room_frames(cam, chip_smoke.GRAPH_FRAMES)
    chip_smoke.run_graph_phase(cam, cfg, torch.device("cuda", 0), frames,
                               chip_smoke._card_line())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="what", required=True)
    sub.add_parser("time", help="device µs a launch and output hashes on the three frames")
    sub.add_parser("graph", help="chip_smoke.py's graph phase alone")
    variants = sub.add_parser("variants", help="time alternatives of the design")
    variants.add_argument("names", nargs="*", metavar="VARIANT",
                          help=f"of {', '.join(VARIANTS)} (default: all)")
    sub.add_parser("split", help="the kernels' phases, from clock64() stamps")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_plane_kernels: no CUDA device", file=sys.stderr)
        return 1
    if args.what == "time":
        run_time()
    elif args.what == "graph":
        run_graph()
    elif args.what == "variants":
        unknown = set(args.names) - set(VARIANTS)
        if unknown:
            parser.error(f"unknown variants {sorted(unknown)}")
        run_variants(args.names or list(VARIANTS))
    else:
        run_split()
    return 0


if __name__ == "__main__":
    sys.exit(main())
