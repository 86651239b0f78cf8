"""The plane extraction's per-cell pass: the CUDA kernel's wrapper and its plain
PyTorch version.

``cell_pass(depth_mm, cam, cfg)`` turns a depth map into the cell grid that
``features.primitives.find_primitives`` grows its regions from: every
``CellGrid`` field, the directed mergeability edges [4, gh, gw] that the
components kernel reads, the normal's histogram bin of each cell and the
cell-centre points with their valid flags, which the boundary polygons read.
It is the head of the jitted ``find_primitives``
(``rgbd_slam_tpu/features/primitives.py:441``): ``depth_to_cloud``,
``fit_cells``, ``_edge_maps`` and ``_normal_bins``.  For CUDA tensors it
launches ``cells_fit_kernel`` and ``cells_edges_kernel`` (``csrc/cells.cu``:
one warp a cell, the patch's loads all in flight at once, then one thread a
cell; the dense cloud is never written) or raises; for CPU tensors it runs
:func:`cells_reference`, the port's tensor code of those four functions.

The kernels are compiled with ``nvcc`` on first use (:mod:`.nvcc`, with
``-fmad=false``: every product and sum rounds on its own, as the plain
version's tensor ops do) and bound with ctypes; they launch on the current
stream and read nothing back, so a CUDA graph can record them.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..config import CameraIntrinsics, DepthNoiseModel, DetectionConfig
from . import nvcc
from .depth_cloud import depth_to_cloud

#: the depth range ``depth_to_cloud`` keeps (its defaults)
MIN_DEPTH_MM = 40.0
MAX_DEPTH_MM = 6000.0
#: the largest patch: its middle row's pixel pairs fit on one warp
MAX_PATCH = 33
#: operations a pixel (two for its point, seven for the count and the sum,
#: eighteen for the centred moments) and a cell (the mean, the eig3 fit and
#: its gates, the tolerance, the bin, the four edges: 200; each of the
#: 2 (patch - 1) continuity pairs: 8) that :func:`cells_work` counts
FLOPS_PER_PIXEL = 27
FLOPS_PER_CELL = 200
FLOPS_PER_PAIR = 8
#: bytes a cell that the pass writes: count 4, mean 12, m2 36, normal 12, d 4,
#: mse 4, score 4, planar 1, tolerance 4, four edges 4, bin 4, centre 12, its
#: valid flag 1
BYTES_PER_CELL = 102


class CellPass(NamedTuple):
    """The per-cell pass of one depth map; the first nine fields are
    ``primitives.CellGrid``'s, [C] leading axis (gh * gw cells row-major)."""
    count: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor
    normal: torch.Tensor
    d: torch.Tensor
    mse: torch.Tensor
    score: torch.Tensor
    planar: torch.Tensor
    distance_tol: torch.Tensor
    edges: torch.Tensor          # [4, gh, gw] bool
    bins: torch.Tensor           # [C] int32
    centers: torch.Tensor        # [gh, gw, 3] the point at each cell's centre pixel
    centers_valid: torch.Tensor  # [gh, gw] bool


class _Args(ctypes.Structure):
    """``CellsArgs`` of ``csrc/cells.cu``, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "depth", "count", "mean", "m2", "normal", "d", "mse", "score", "planar", "tol",
        "edges", "bins", "centers", "centers_valid")]
        + [(name, ctypes.c_int) for name in (
            "h", "w", "patch", "gh", "gw", "min_points", "half_points", "hist_bins")]
        + [(name, ctypes.c_float) for name in (
            "fx", "fy", "cx", "cy", "min_depth", "max_depth", "q_const", "q_lin", "q_quad",
            "q_floor", "sin_merge", "max_merge_dist", "cos_max")])


def _bind(lib):
    lib.cells_launch.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    lib.cells_launch.restype = ctypes.c_int


LIBRARY = nvcc.Library("cells.cu", _bind, launches=("cells",), extra_flags=("-fmad=false",))
#: launches of the kernel pair since import (``LIBRARY.launches``)
LAUNCHES = LIBRARY.launches


def merge_angle_cos(cfg: DetectionConfig) -> float:
    """The edges' cosine threshold, as ``find_primitives`` computes it."""
    return math.cos(math.radians(cfg.max_plane_merge_angle_d))


def grid_shape(depth_mm, cfg: DetectionConfig):
    """(gh, gw) of the cells of a depth map."""
    patch = cfg.depth_patch_size_px
    h, w = depth_mm.shape
    return h // patch, w // patch


def cell_pass(depth_mm, cam: CameraIntrinsics, cfg: DetectionConfig = DetectionConfig()
              ) -> CellPass:
    """The per-cell pass of ``depth_mm`` [H, W] (mm): the kernels for a CUDA
    tensor, the plain version for a CPU tensor."""
    if depth_mm.device.type == "cuda":
        return cells_cuda(depth_mm, cam, cfg)
    if depth_mm.device.type == "cpu":
        return cells_reference(depth_mm, cam, cfg)
    raise ValueError(f"unsupported device {depth_mm.device}")


def cells_reference(depth_mm, cam: CameraIntrinsics,
                    cfg: DetectionConfig = DetectionConfig()) -> CellPass:
    """The plain version: the port's ``depth_to_cloud``, ``fit_cells``,
    ``_edge_maps`` and ``_normal_bins``, and the cloud at the cell centres."""
    from ..features import primitives

    patch = cfg.depth_patch_size_px
    gh, gw = grid_shape(depth_mm, cfg)
    dev = depth_mm.device
    cloud, valid = depth_to_cloud(depth_mm, cam)
    grid = primitives.fit_cells(cloud, valid, cfg)
    edges = primitives._edge_maps(grid, gh, gw, merge_angle_cos(cfg))
    bins = primitives._normal_bins(grid.normal)
    cy = torch.arange(gh, device=dev) * patch + patch // 2
    cx = torch.arange(gw, device=dev) * patch + patch // 2
    return CellPass(*grid, edges=edges, bins=bins, centers=cloud[cy[:, None], cx[None, :]],
                    centers_valid=valid[cy[:, None], cx[None, :]])


def check_inputs(depth_mm, cfg: DetectionConfig):
    """Raise on a depth map the kernels do not take: not a float32 [H, W] CUDA
    tensor, or a patch the continuity test cannot hold on one warp, or a size
    the patch does not divide."""
    patch = cfg.depth_patch_size_px
    if depth_mm.device.type != "cuda" or depth_mm.dtype != torch.float32 \
            or depth_mm.dim() != 2:
        raise ValueError(f"the cells kernel takes a float32 [H, W] CUDA tensor, got "
                         f"{depth_mm.dtype} {tuple(depth_mm.shape)} on {depth_mm.device}")
    if not 2 <= patch <= MAX_PATCH:
        raise ValueError(f"a patch of {patch} px: the cells kernel takes 2 to {MAX_PATCH}")
    h, w = depth_mm.shape
    if h % patch or w % patch or h < patch or w < patch:
        raise ValueError(f"a {w}x{h} depth map is not a whole number of {patch} px cells")


def cells_cuda(depth_mm, cam: CameraIntrinsics,
               cfg: DetectionConfig = DetectionConfig()) -> CellPass:
    """Launch the kernel pair on the current stream."""
    check_inputs(depth_mm, cfg)
    from ..features.primitives import HIST_BINS

    depth_mm = depth_mm.contiguous()
    patch = cfg.depth_patch_size_px
    h, w = depth_mm.shape
    gh, gw = grid_shape(depth_mm, cfg)
    LIBRARY.build()
    dev = depth_mm.device
    c = gh * gw

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = CellPass(
        count=empty(c), mean=empty(c, 3), m2=empty(c, 3, 3), normal=empty(c, 3), d=empty(c),
        mse=empty(c), score=empty(c), planar=empty(c, dtype=torch.bool),
        distance_tol=empty(c), edges=empty(4, gh, gw, dtype=torch.bool),
        bins=empty(c, dtype=torch.int32), centers=empty(gh, gw, 3),
        centers_valid=empty(gh, gw, dtype=torch.bool))
    noise = DepthNoiseModel()
    ppc = patch * patch
    angle = math.radians(cfg.max_plane_merge_angle_d)
    args = _Args(depth_mm.data_ptr(), *(t.data_ptr() for t in out),
                 h, w, patch, gh, gw, int(ppc * cfg.min_zero_depth_proportion), ppc // 2,
                 HIST_BINS, cam.fx, cam.fy, cam.cx, cam.cy, MIN_DEPTH_MM, MAX_DEPTH_MM,
                 noise.constant, noise.linear, noise.quadratic, noise.floor_mm,
                 math.sin(angle), cfg.max_plane_merge_distance_mm, math.cos(angle))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = LIBRARY.lib.cells_launch(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"cells kernel launch failed: cudaError {err}")
    LAUNCHES["cells"] += 1
    return out


def cells_work(h: int, w: int, patch: int) -> dict:
    """What the pass needs at an H x W depth map, for the kernels' roofline
    bound: bytes (the depth read once, ``BYTES_PER_CELL`` written a cell) and
    float operations (``FLOPS_PER_PIXEL`` a pixel, ``FLOPS_PER_CELL`` and
    ``FLOPS_PER_PAIR`` for each of its 2 (patch - 1) continuity pairs a cell,
    and the two ray factors of every column and row).  The work does not
    depend on the depth values."""
    gh, gw = h // patch, w // patch
    c = gh * gw
    return {"cells": c, "bytes": 4 * h * w + BYTES_PER_CELL * c,
            "flops": FLOPS_PER_PIXEL * h * w
            + c * (FLOPS_PER_CELL + FLOPS_PER_PAIR * 2 * (patch - 1)) + 2 * (h + w)}
