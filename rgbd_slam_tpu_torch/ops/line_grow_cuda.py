"""The line detector's seeds grown over the directed tile graph: the CUDA
kernel's wrapper and its plain PyTorch version.

``grow_seeds(edges, is_line, weight, min_tiles)`` runs the seed loop of
``rgbd_slam_tpu/features/lines.py`` (``seed_step`` over the ``lax.while_loop``
of ``_propagate``): each of the ``MAX_LINE_SEEDS`` seeds in turn takes the
heaviest available line tile (the first on equal weights, as ``argmax``
does), proceeds if its weight is over 0, grows along the in-edges through
available tiles to the fixpoint, keeps the grown set's available line tiles
as its members, and consumes them all if they are at least ``min_tiles``,
else itself alone.  It returns the members [MAX_LINE_SEEDS, T] bool and
``proceed`` [MAX_LINE_SEEDS] bool.  For CUDA tensors it launches
``line_grow_kernel`` (``csrc/line_grow.cu``: one CTA packs the planes into bit
rows, then one warp, a row a lane, grows each seed in rounds that carry the
set along whole rows and columns at once) or raises; for CPU tensors it runs
:func:`grow_seeds_reference`.

Growth without host reads on the CPU.  A loop to a fixpoint costs a host read
per test (:func:`_propagate` keeps that form, with one read per ``GROW_CHUNK``
rounds), so the plain version takes the reflexive-transitive closure of the
directed tile graph once (:func:`_reach_closure`: ``ceil(log2(T))`` boolean
squarings of the [T, T] adjacency, which cover every path of a T-node graph)
and reads a seed's members off its row.  That is exact because every set a
seed consumes is forward-closed: with ``min_tiles <= 2`` a seed consumes
either all it reaches or, when it reaches nothing else, itself, so a path that
enters a consumed set never leaves it, and what a later seed reaches among the
available tiles is its closure row less the consumed tiles.  With
``min_tiles > 2`` a seed can consume itself alone and cut paths through it, so
the plain version then grows each seed with :func:`_propagate`.  The kernel
grows through the available tiles as ``_propagate`` does, for any
``min_tiles``, and gives the same outputs.

Inputs as ``_line_edge_maps`` gives them: no edge across the grid's border
(the plain version's ``roll`` would follow one; the kernel reads none), and a
weight over 0 on every line tile (a line tile has at least ``min_edges``
pixels over the magnitude threshold).

The kernel is compiled with ``nvcc`` on first use (:mod:`.nvcc`) and bound
with ctypes; it launches on the current stream and reads nothing back, so a
CUDA graph can record it.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import nvcc

MAX_LINE_SEEDS = 16
#: growth rounds of :func:`_propagate` between two host reads
GROW_CHUNK = 8
#: edge plane s: tile (y, x) may join from (y, x) - SHIFTS[s]
SHIFTS = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1), (-1, -1))
#: the largest grid the kernel takes: a lane of its warp holds a row of each
#: chunk of 32 rows, in 32-tile words (1920x1080's 120x67 tiles among them)
MAX_ROWS = 3 * 32
MAX_COLS = 4 * 32
#: shared memory a CTA may hold on Hopper (227 KB); the kernel keeps
#: ``PLANES`` bit planes of ``gh * ceil(gw / 32)`` words, a 64-bit key a tile
#: and ``HEAD_BYTES`` of the seeds' outcomes
MAX_SMEM_BYTES = 232448
PLANES = 9 + MAX_LINE_SEEDS
HEAD_BYTES = 8 * MAX_LINE_SEEDS


def _bind(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.line_grow_launch.argtypes = [ptr, ptr, ptr, i32, i32, i32, ptr, ptr, ptr, ptr]
    lib.line_grow_launch.restype = ctypes.c_int


LIBRARY = nvcc.Library("line_grow.cu", _bind, launches=("line_grow",))
#: launches of the CUDA kernel since import (``LIBRARY.launches``)
LAUNCHES = LIBRARY.launches


def smem_bytes(gh: int, gw: int) -> int:
    """Dynamic shared memory of the kernel on a gh x gw tile grid."""
    return HEAD_BYTES + 8 * gh * gw + 4 * PLANES * gh * math.ceil(gw / 32)


def check_grid(gh: int, gw: int):
    """Raise on a grid the kernel does not take: empty, past ``MAX_ROWS`` x
    ``MAX_COLS`` tiles, or past the shared memory of one CTA."""
    if gh < 1 or gw < 1:
        raise ValueError(f"an empty {gh}x{gw} tile grid")
    if gh > MAX_ROWS or gw > MAX_COLS:
        raise ValueError(f"a {gh}x{gw} tile grid: the kernel takes at most {MAX_ROWS} rows "
                         f"and {MAX_COLS} columns")
    if smem_bytes(gh, gw) > MAX_SMEM_BYTES:
        raise ValueError(
            f"a {gh}x{gw} tile grid needs {smem_bytes(gh, gw)} bytes of shared memory, more "
            f"than the {MAX_SMEM_BYTES} one CTA holds")


def grow_seeds(edges, is_line, weight, min_tiles: int):
    """(members [MAX_LINE_SEEDS, T] bool, proceed [MAX_LINE_SEEDS] bool) of the
    seeds grown over ``edges`` [8, gh, gw] bool among the ``is_line`` [T] bool
    tiles, heaviest ``weight`` [T] float32 first: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if is_line.device.type == "cuda":
        return grow_seeds_cuda(edges, is_line, weight, min_tiles)
    if is_line.device.type == "cpu":
        return grow_seeds_reference(edges, is_line, weight, min_tiles)
    raise ValueError(f"unsupported device {is_line.device}")


def grow_seeds_cuda(edges, is_line, weight, min_tiles: int, details: bool = False):
    """Launch the kernel on the current stream.  With ``details``, also return
    each seed's growth rounds [MAX_LINE_SEEDS] int32 (the last, which changed
    nothing, counted; 0 for a seed that did not proceed)."""
    device = is_line.device
    if device.type != "cuda":
        raise ValueError("the line growth kernel takes CUDA tensors")
    if edges.dim() != 3:
        raise ValueError(f"edges must be [8, gh, gw], got {tuple(edges.shape)}")
    gh, gw = edges.shape[1:]
    check_grid(gh, gw)
    t = gh * gw
    for name, x, dtype, shape in (("edges", edges, torch.bool, (8, gh, gw)),
                                  ("is_line", is_line, torch.bool, (t,)),
                                  ("weight", weight, torch.float32, (t,))):
        if x.device != device or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be a {dtype} tensor {shape} on {device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    # the kernel reads its inputs 16 bytes at a time
    edges, is_line, weight = (x.contiguous() for x in (edges, is_line, weight))
    edges, is_line, weight = (x.clone() if x.data_ptr() % 16 else x
                              for x in (edges, is_line, weight))
    LIBRARY.build()
    members = torch.empty((MAX_LINE_SEEDS, t), dtype=torch.bool, device=device)
    proceed = torch.empty((MAX_LINE_SEEDS,), dtype=torch.bool, device=device)
    rounds = torch.empty((MAX_LINE_SEEDS,), dtype=torch.int32, device=device) \
        if details else None
    stream = torch.cuda.current_stream(device).cuda_stream
    err = LIBRARY.lib.line_grow_launch(edges.data_ptr(), is_line.data_ptr(), weight.data_ptr(),
                                       gh, gw, int(min_tiles), members.data_ptr(),
                                       proceed.data_ptr(), rounds.data_ptr() if details else None,
                                       stream)
    if err != 0:
        raise RuntimeError(f"line growth kernel launch failed: cudaError {err}")
    LAUNCHES["line_grow"] += 1
    return (members, proceed, rounds) if details else (members, proceed)


def _shifted(x, dy: int, dx: int):
    """``x`` rolled by (dy, dx) along its first two axes (wrapping around)."""
    return torch.roll(x, shifts=(dy, dx), dims=(0, 1))


def _propagate(seed_idx, edges, shifts, available, gh, gw):
    """Tiles reached from ``seed_idx`` along ``edges`` through ``available``
    tiles, [T] bool (the seed included), grown round by round to the fixpoint;
    the host reads whether the last of ``GROW_CHUNK`` rounds changed a tile."""
    active = torch.zeros((gh * gw,), dtype=torch.bool, device=edges.device)
    active[seed_idx] = True
    active = active.reshape(gh, gw)
    avail = available.reshape(gh, gw)
    while True:
        for _ in range(GROW_CHUNK):
            prev = active
            grow = torch.zeros_like(active)
            for e, (dy, dx) in zip(edges, shifts):
                grow = grow | (_shifted(active, dy, dx) & e)
            active = active | (grow & avail)
        if not bool((active != prev).any().item()):
            return active.reshape(-1)


def _reach_closure(edges, shifts, gh, gw):
    """Reflexive-transitive closure of the directed tile graph, [T, T] bool:
    row s marks the tiles reached from tile s.  ``ceil(log2(T))`` squarings of
    (I + adjacency) cover every path of a T-node graph (a simple path has fewer
    than T edges), so no convergence test and no host read is needed.  The
    products count paths in float32; the counts are clamped to {0, 1} after
    each squaring, so they stay exact."""
    t = gh * gw
    dev = edges.device
    idx = torch.arange(t, device=dev).reshape(gh, gw)
    reach = torch.eye(t, dtype=torch.float32, device=dev)
    for e, (dy, dx) in zip(edges, shifts):
        src = _shifted(idx, dy, dx)          # the neighbour each tile joins from
        reach[src.reshape(-1), idx.reshape(-1)] += e.reshape(-1).to(torch.float32)
    for _ in range(max(1, math.ceil(math.log2(t)))):
        reach = torch.clamp_max(reach @ reach, 1.0)
    return reach > 0


def grow_seeds_reference(edges, is_line, weight, min_tiles: int):
    """The plain version: the seeds in turn as tensor code, each seed's
    members off its closure row (min_tiles <= 2: no host read) or grown by
    :func:`_propagate` (see the module docstring)."""
    gh, gw = edges.shape[1:]
    t = gh * gw
    reach = _reach_closure(edges, SHIFTS, gh, gw) if min_tiles <= 2 else None
    available = is_line
    tiles = torch.arange(t, device=is_line.device)
    members, proceeds = [], []
    for _ in range(MAX_LINE_SEEDS):
        seed_w = torch.where(available & is_line, weight, torch.full_like(weight, -1.0))
        seed_idx = torch.argmax(seed_w, dim=0, keepdim=True)     # [1]: no host read
        proceed = seed_w[seed_idx] > 0                            # [1]
        if reach is None:
            active = _propagate(seed_idx, edges, SHIFTS, available, gh, gw)
        else:
            active = reach[seed_idx][0]
        active = active & is_line & available
        big_enough = proceed & (active.sum() >= min_tiles)
        consumed = torch.where(big_enough, active, (tiles == seed_idx) & proceed)
        available = available & ~consumed
        members.append(active)
        proceeds.append(proceed[0])
    return torch.stack(members), torch.stack(proceeds)


def grow_work(gh: int, gw: int) -> dict:
    """What the kernel's function needs, for its roofline bound: the bytes of
    the eight edge planes, is_line and the float32 weights read once, and the
    member rows and proceed flags written once.  Its operations, a few
    thousand word operations a round, weigh less: bytes bound it."""
    t = gh * gw
    return {"bytes": (8 + 1 + 4) * t + MAX_LINE_SEEDS * (t + 1)}
