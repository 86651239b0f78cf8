"""Frozen plain copy: the kernel, its build and its binding are cut, and every
device runs the plain version (see the package's docstring).

The plane extraction's per-cell pass: the CUDA kernel's wrapper and its plain
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

import math
from typing import NamedTuple

import torch

from ..config import CameraIntrinsics, DepthNoiseModel, DetectionConfig
from .depth_cloud import depth_to_cloud

#: the depth range ``depth_to_cloud`` keeps (its defaults)
MIN_DEPTH_MM = 40.0
MAX_DEPTH_MM = 6000.0
#: the largest patch: its middle row's pixel pairs fit on one warp
MAX_PATCH = 33


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
    return cells_reference(depth_mm, cam, cfg)


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


