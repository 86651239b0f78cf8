"""Connected components of the plane extraction's cell graph: the CUDA kernel's
wrapper and its plain PyTorch version.

``connected_components(edges, planar, gh, gw)`` labels every planar cell with
the smallest cell index of its component under the symmetric 4-neighbour
mergeability edges, and every other cell with ``C = gh * gw``: the fixpoint of
the ``lax.while_loop`` in ``rgbd_slam_tpu/features/primitives.py:267``.  For
CUDA tensors it launches ``components_kernel`` (``csrc/components.cu``: one
CTA, the labels in shared memory, rounds of propagation that carry a label
along a whole row run at once, ended on the card) or raises; for CPU tensors
it runs :func:`components_reference`, the JAX loop's propagation as tensor
code, which reads on the host whether a chunk of ``CC_CHUNK`` rounds changed a
label.

The kernel is compiled with ``nvcc`` on first use (:mod:`.nvcc`) and bound
with ctypes; it launches on the current stream and reads nothing back, so a
CUDA graph can record it.
"""

from __future__ import annotations

import ctypes

import torch

from . import nvcc

#: rounds of the plain version between two convergence reads on the host
CC_CHUNK = 8
#: convergence reads the plain version has made on the host (one a chunk); a
#: caller sets it to 0 and reads it after a run.  The kernel makes none.
FIXPOINT_READS = {"components": 0}
#: shared memory a CTA may hold on Hopper (227 KB), the kernel's limit on the
#: grid: an int32 label and uint16 flags a cell (``CC_SMEM_BYTES_PER_CELL``)
MAX_SMEM_BYTES = 232448
SMEM_BYTES_PER_CELL = 6


def _bind(lib):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.components_launch.argtypes = [ptr, ptr, i32, i32, ptr, ptr]
    lib.components_launch.restype = ctypes.c_int


LIBRARY = nvcc.Library("components.cu", _bind, launches=("components",))
#: launches of the CUDA kernel since import (``LIBRARY.launches``)
LAUNCHES = LIBRARY.launches


def check_grid(gh: int, gw: int):
    """Raise on a grid the kernel does not take: empty, or past the shared
    memory of one CTA."""
    if gh < 1 or gw < 1:
        raise ValueError(f"an empty {gh}x{gw} cell grid")
    if gh * gw * SMEM_BYTES_PER_CELL > MAX_SMEM_BYTES:
        raise ValueError(
            f"a {gh}x{gw} cell grid needs {gh * gw * SMEM_BYTES_PER_CELL} bytes of shared "
            f"memory, more than the {MAX_SMEM_BYTES} one CTA holds")


def connected_components(edges, planar, gh: int, gw: int):
    """Component labels [C] int64 of the directed mergeability ``edges`` [4, gh,
    gw] bool over the ``planar`` [C] bool cells: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if planar.device.type == "cuda":
        return components_cuda(edges, planar, gh, gw)
    if planar.device.type == "cpu":
        return components_reference(edges, planar, gh, gw)
    raise ValueError(f"unsupported device {planar.device}")


def components_cuda(edges, planar, gh: int, gw: int):
    """Launch the kernel on the current stream."""
    device = planar.device
    if device.type != "cuda":
        raise ValueError("the components kernel takes CUDA tensors")
    check_grid(gh, gw)
    for name, t, shape in (("edges", edges, (4, gh, gw)), ("planar", planar, (gh * gw,))):
        if t.device != device or t.dtype != torch.bool or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a bool tensor {shape} on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    edges, planar = edges.contiguous(), planar.contiguous()
    LIBRARY.build()
    labels = torch.empty((gh * gw,), dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = LIBRARY.lib.components_launch(edges.data_ptr(), planar.data_ptr(), gh, gw,
                                        labels.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"components kernel launch failed: cudaError {err}")
    LAUNCHES["components"] += 1
    return labels


def _clear_edge(m, dim: int, first: bool):
    """``m.at[...].set(False)`` on the first or last index along ``dim``
    (out of place)."""
    m = m.clone()
    m.select(dim, 0 if first else m.shape[dim] - 1).fill_(False)
    return m


def _symmetric_edges(edges):
    """(left, right, up, down) [gh, gw] bool: growable in either direction
    across the shared edge."""
    sym_l = _clear_edge(edges[0] | torch.roll(edges[1], 1, dims=1), 1, first=True)
    sym_u = _clear_edge(edges[2] | torch.roll(edges[3], 1, dims=0), 0, first=True)
    sym_r = _clear_edge(torch.roll(sym_l, -1, dims=1), 1, first=False)
    sym_d = _clear_edge(torch.roll(sym_u, -1, dims=0), 0, first=False)
    return sym_l, sym_r, sym_u, sym_d


def _round(lbl, sym, planar2, big):
    """One round of the JAX loop body: two propagation steps over the symmetric
    edges, then two pointer jumps."""
    gh, gw = lbl.shape
    sym_l, sym_r, sym_u, sym_d = sym

    def prop(lbl):
        nb = torch.minimum(
            torch.minimum(torch.where(sym_l, torch.roll(lbl, 1, dims=1), big),
                          torch.where(sym_r, torch.roll(lbl, -1, dims=1), big)),
            torch.minimum(torch.where(sym_u, torch.roll(lbl, 1, dims=0), big),
                          torch.where(sym_d, torch.roll(lbl, -1, dims=0), big)))
        return torch.where(planar2, torch.minimum(lbl, nb), big)

    new = prop(prop(lbl))
    # pointer jumping: a cell may adopt its label's own label
    for _ in range(2):
        flat = torch.cat([new.reshape(-1), big[:1, 0]])
        new = torch.minimum(new, flat[new.reshape(-1)].reshape(gh, gw))
    return new


def _initial_labels(planar, gh: int, gw: int):
    c = gh * gw
    big = torch.full((gh, gw), c, dtype=torch.int64, device=planar.device)
    planar2 = planar.reshape(gh, gw)
    return torch.where(planar2, torch.arange(c, device=planar.device).reshape(gh, gw),
                       big), planar2, big


def _fixpoint(edges, planar, gh: int, gw: int, chunk: int):
    """The JAX loop run ``chunk`` rounds at a time, with one host read a chunk
    (counted in ``FIXPOINT_READS``) of whether its last round changed a label.
    Returns (labels [C] int64, rounds run)."""
    sym = _symmetric_edges(edges)
    lbl, planar2, big = _initial_labels(planar, gh, gw)
    rounds = 0
    while True:
        for _ in range(chunk):
            prev, lbl = lbl, _round(lbl, sym, planar2, big)
        rounds += chunk
        FIXPOINT_READS["components"] += 1
        if not bool((lbl != prev).any().item()):
            return lbl.reshape(-1), rounds


def components_reference(edges, planar, gh: int, gw: int):
    """The plain version: min-label propagation with pointer-jumping shortcuts,
    run to its fixpoint ``CC_CHUNK`` rounds at a time, with one host read per
    chunk.  A round past the fixpoint changes nothing, so the labels are the
    JAX loop's."""
    return _fixpoint(edges, planar, gh, gw, CC_CHUNK)[0]


def components_work(edges, planar, gh: int, gw: int) -> dict:
    """What these inputs need, for the kernel's roofline bound: bytes (edges
    and the planar mask read once, int64 labels written once) and integer
    operations (each round, per planar cell: four neighbour minima with their
    edge tests, two pointer jumps and the change test, 12 operations)."""
    c = gh * gw
    rounds = _fixpoint(edges, planar, gh, gw, 1)[1]   # the JAX loop's, the last included
    n_planar = int(planar.sum())
    return {"rounds": rounds, "planar_cells": n_planar, "bytes": 4 * c + c + 8 * c,
            "ops": 12 * rounds * n_planar}
