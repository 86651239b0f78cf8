"""The plane extraction's cylinder stage: the CUDA kernel's wrapper and its plain
PyTorch version.

``cylinder_stage(grid, member, try_cyl, cfg, min_activated)`` takes the cell
grid and the candidate regions of ``features.primitives.find_primitives``
(``member`` [K, C] bool, ``try_cyl`` [K] bool) and returns the axis and its
gate of every region, the at most ``MAX_CYLINDERS`` regions it selects, and
each selected region's ``CYL_SUBSEGMENTS`` sub-segments (centre, radius,
validity, MSE, inlier cells) routed back to region order; the other regions
hold the fill values 0, inf and False.  It is the part of the jitted
``find_primitives`` (``rgbd_slam_tpu/features/primitives.py:441``) from the
axis gate to the routing back: ``_cylinder_axis`` (:301), the selection,
``_fit_cylinder`` (:319) and the one-hot routing (:496-525).  For CUDA tensors
it launches ``cylinders_kernel`` (``csrc/cylinders.cu``: a thread block
cluster of 4 CTAs a region slot; a dead slot exits after the axis gate and the
fill values) or raises; for CPU tensors it runs :func:`cylinders_reference`,
the port's tensor code of those steps.  The grid's size chooses the kernel's
path (:func:`shared_path`): up to 3,576 cells at 20 regions a CTA stages its
inputs and keeps its cell arrays in shared memory; past that, up to
``MAX_CELLS``, it reads them where they lie and keeps its cell arrays in a
scratch buffer in global memory, with the same arithmetic and bits.

The kernel is compiled with ``nvcc`` on first use (:mod:`.nvcc`, with
``-fmad=false``) and bound with ctypes; it launches on the current stream and
reads nothing back, so a CUDA graph can record it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..config import DetectionConfig
from . import nvcc

#: the kernel's limits (``CYL_MAX_*`` in ``csrc/cylinders.cu``)
MAX_REGIONS = 64
MAX_HYPOTHESES = 256
MAX_SUBSEGMENTS = 8
#: dynamic shared memory a CTA may hold on Hopper (227 KB), less the kernel's
#: ~9 kB of static arrays: the shared-memory path's limit
MAX_SMEM_BYTES = 232448 - 10 * 1024
#: cells the global-memory path takes (``CYL_MAX_CELLS_GLOBAL``): past the
#: components kernel's 38,741, with k s c far below 2^31
MAX_CELLS = 65536
#: operations :func:`cylinders_work` counts: a (region, cell) pair of the
#: axis gate (six weighted products and the count), a region's eig3 and
#: score, and for each live slot: a cell's projection, a hypothesis's triplet
#: sums and LLS fit, a (hypothesis, cell) distance with its truncation and
#: weighted sum, and a cell's inlier test, refit sums and MSE term a round
FLOPS_AXIS_PAIR = 19
FLOPS_AXIS_REGION = 160
FLOPS_PROJECT_CELL = 30
FLOPS_HYPOTHESIS = 60
FLOPS_DISTANCE = 23
FLOPS_REFIT_CELL = 59


class CylinderStage(NamedTuple):
    """The cylinder stage of one frame, in region order ([K] leading axis; S
    sub-segments a region)."""
    axis: torch.Tensor      # [K, 3] smallest eigenvector of the region's normals
    axis_ok: torch.Tensor   # [K] bool: the axis gate
    selected: torch.Tensor  # [K] bool: a candidate that holds an MSAC slot
    centers: torch.Tensor   # [K, S, 3]
    radii: torch.Tensor     # [K, S]
    valids: torch.Tensor    # [K, S] bool
    mses: torch.Tensor      # [K, S], inf where not valid
    inliers: torch.Tensor   # [K, S, C] bool


class _Args(ctypes.Structure):
    """``CylArgs`` of ``csrc/cylinders.cu``, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "normal", "mean", "planar", "member", "try_cyl", "axis", "axis_ok", "selected",
        "centers", "radii", "valids", "mses", "inliers", "scratch")]
        + [(name, ctypes.c_int) for name in (
            "c", "k", "subsegments", "n_hyp", "min_activated")]
        + [(name, ctypes.c_float) for name in ("trunc", "min_score")])


def _bind(lib):
    lib.cylinders_launch.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_void_p]
    lib.cylinders_launch.restype = ctypes.c_int
    lib.cylinders_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.cylinders_scratch_bytes.restype = ctypes.c_size_t


LIBRARY = nvcc.Library("cylinders.cu", _bind, launches=("cylinders",), extra_flags=("-fmad=false",))
#: launches of the kernel since import (``LIBRARY.launches``)
LAUNCHES = LIBRARY.launches


def _sizes():
    from ..features.primitives import CYL_SUBSEGMENTS, MAX_CYLINDERS, _msac_iterations
    return MAX_CYLINDERS, CYL_SUBSEGMENTS, _msac_iterations


def cylinder_stage(grid, member, try_cyl, cfg: DetectionConfig, min_activated: int
                   ) -> CylinderStage:
    """The cylinder stage of the regions ``member`` [K, C] of the cell grid
    ``grid`` (``primitives.CellGrid``): the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if member.device.type == "cuda":
        return cylinders_cuda(grid, member, try_cyl, cfg, min_activated)
    if member.device.type == "cpu":
        return cylinders_reference(grid, member, try_cyl, cfg, min_activated)
    raise ValueError(f"unsupported device {member.device}")


def cylinders_reference(grid, member, try_cyl, cfg: DetectionConfig, min_activated: int
                        ) -> CylinderStage:
    """The plain version: the port's ``_cylinder_axis`` over every region, the
    cumsum selection, ``_fit_cylinder`` over the selected slots and the
    one-hot routing back to region order."""
    from ..features.primitives import _cylinder_axis, _fit_cylinder

    max_cyl, s_, _ = _sizes()
    dt = grid.normal.dtype
    dev = member.device
    k_cand, n_cells = member.shape
    cy_axis, axis_ok = _cylinder_axis(grid, member, cfg)
    cyl_cand = try_cyl & axis_ok
    r_rank = torch.cumsum(cyl_cand.to(torch.int64), dim=0) - 1
    r_sel = cyl_cand & (r_rank < max_cyl)
    region_idx = torch.zeros(max_cyl + 1, dtype=torch.int64, device=dev).scatter(
        0, torch.where(r_sel, r_rank, max_cyl), torch.arange(k_cand, device=dev))[:max_cyl]
    region_live = torch.arange(max_cyl, device=dev) < r_sel.to(torch.int64).sum()
    sel_centers, sel_radii, sel_mses, sel_valids, sel_inliers = _fit_cylinder(
        grid, member[region_idx], cy_axis[region_idx], region_live, cfg, min_activated)

    # sub-segment results back to region index space (one-hot matmul)
    tgt = torch.where(region_live, region_idx, k_cand)
    r_onehot = (tgt[None, :] == torch.arange(k_cand, device=dev)[:, None]).to(dt)
    cy_centers = (r_onehot @ sel_centers.reshape(max_cyl, -1)).reshape(k_cand, s_, 3)
    cy_radii = r_onehot @ sel_radii
    cy_valids = (r_onehot @ sel_valids.to(dt)) > 0.5
    cy_mses = torch.where(
        cy_valids, r_onehot @ torch.where(torch.isfinite(sel_mses), sel_mses,
                                          torch.zeros_like(sel_mses)),
        torch.full_like(cy_radii, float("inf")))
    cy_inliers = ((r_onehot @ sel_inliers.reshape(max_cyl, -1).to(dt)) > 0.5) \
        .reshape(k_cand, s_, n_cells)
    return CylinderStage(cy_axis, axis_ok, r_sel, cy_centers, cy_radii, cy_valids, cy_mses,
                         cy_inliers)


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def smem_bytes(c: int, k: int) -> int:
    """Dynamic shared memory of a CTA at ``c`` cells and ``k`` regions
    (``cylinders_smem``): normals and means (12 bytes a cell each), planar and
    remaining flags (a byte each), the compacted cells (4), a mask a chunk of
    32 cells, the candidate flags, and the member rows (k bytes a cell) that
    the projected cells (32) replace after the gate."""
    return (2 * _align16(12 * c) + 2 * _align16(c) + _align16(4 * c)
            + _align16(4 * ((c + 31) // 32)) + _align16(k) + _align16(max(k, 32) * c))


def shared_path(c: int, k: int) -> bool:
    """Whether the kernel keeps a grid of ``c`` cells and ``k`` regions in
    one CTA's shared memory (the path of every grid that fits); past it the
    global-memory path takes the grid."""
    return smem_bytes(c, k) <= MAX_SMEM_BYTES


def check_grid(c: int, k: int):
    """Raise on a grid of ``c`` cells and ``k`` candidate regions that no path
    of the kernel takes."""
    if not 0 < k <= MAX_REGIONS:
        raise ValueError(f"{k} candidate regions: the cylinders kernel takes 1 to "
                         f"{MAX_REGIONS}")
    if not 0 < c <= MAX_CELLS:
        raise ValueError(f"a grid of {c} cells: the cylinders kernel takes 1 to {MAX_CELLS}")


def check_inputs(grid, member, try_cyl, n_hyp: int, subsegments: int):
    """Raise on inputs the kernel does not take."""
    device = member.device
    if device.type != "cuda":
        raise ValueError("the cylinders kernel takes CUDA tensors")
    k, c = member.shape
    for name, t, shape, dtype in (
            ("normal", grid.normal, (c, 3), torch.float32),
            ("mean", grid.mean, (c, 3), torch.float32),
            ("planar", grid.planar, (c,), torch.bool),
            ("member", member, (k, c), torch.bool),
            ("try_cyl", try_cyl, (k,), torch.bool)):
        if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a {dtype} tensor {shape} on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    check_grid(c, k)
    if not 0 < n_hyp <= MAX_HYPOTHESES or not 0 < subsegments <= MAX_SUBSEGMENTS:
        raise ValueError(f"{n_hyp} hypotheses and {subsegments} sub-segments: the kernel "
                         f"takes up to {MAX_HYPOTHESES} and {MAX_SUBSEGMENTS}")


def cylinders_cuda(grid, member, try_cyl, cfg: DetectionConfig, min_activated: int
                   ) -> CylinderStage:
    """Launch the kernel on the current stream."""
    max_cyl, s_, msac_iterations = _sizes()
    n_hyp = msac_iterations(cfg)
    check_inputs(grid, member, try_cyl, n_hyp, s_)
    k, c = member.shape
    if max_cyl > k:
        raise ValueError(f"{max_cyl} slots for {k} candidate regions")
    LIBRARY.build()
    dev = member.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = CylinderStage(
        axis=empty(k, 3), axis_ok=empty(k, dtype=torch.bool),
        selected=empty(k, dtype=torch.bool), centers=empty(k, s_, 3), radii=empty(k, s_),
        valids=empty(k, s_, dtype=torch.bool), mses=empty(k, s_),
        inliers=empty(k, s_, c, dtype=torch.bool))
    ins = [t.contiguous() for t in (grid.normal, grid.mean, grid.planar, member, try_cyl)]
    scratch = None
    if not shared_path(c, k):
        scratch = torch.empty(LIBRARY.lib.cylinders_scratch_bytes(c, max_cyl),
                              dtype=torch.uint8, device=dev)
    args = _Args(*(t.data_ptr() for t in ins), *(t.data_ptr() for t in out),
                 None if scratch is None else scratch.data_ptr(),
                 c, k, s_, n_hyp, min_activated, cfg.cylinder_ransac_sqrt_max_distance,
                 cfg.cylinder_ransac_min_score)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = LIBRARY.lib.cylinders_launch(ctypes.byref(args), max_cyl, stream)
    if err != 0:
        raise RuntimeError(f"cylinders kernel launch failed: cudaError {err}")
    LAUNCHES["cylinders"] += 1
    return out


def cylinders_work(c: int, k: int, n_hyp: int, subsegments: int, live: int) -> dict:
    """What the stage needs, for the kernel's roofline bound: bytes (the
    normals, means, planar flags, region masks and candidate flags read once;
    every output written once) and float operations: the axis gate of all
    ``k`` regions over ``c`` cells, and for each of the ``live`` selected
    regions (the data's: a dead slot does no more) the projection of every
    cell and, each of ``subsegments`` rounds, ``n_hyp`` hypotheses scored
    against every cell and the inlier refit."""
    read = 12 * c + 12 * c + c + k * c + k
    written = 12 * k + k + k + 12 * k * subsegments + 4 * k * subsegments \
        + k * subsegments + 4 * k * subsegments + k * subsegments * c
    flops = k * (FLOPS_AXIS_PAIR * c + FLOPS_AXIS_REGION) + live * (
        FLOPS_PROJECT_CELL * c + subsegments * (
            FLOPS_HYPOTHESIS * n_hyp + FLOPS_DISTANCE * n_hyp * c + FLOPS_REFIT_CELL * c))
    return {"live": live, "bytes": read + written, "flops": flops}
