"""Frozen plain copy: the kernel, its build and its binding are cut, and every
device runs the plain version (see the package's docstring).

The plane extraction's cylinder stage: the CUDA kernel's wrapper and its plain
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
cluster of 4 CTAs a region slot, the inputs staged in shared memory; a dead
slot exits after the axis gate and the fill values) or raises; for CPU tensors
it runs :func:`cylinders_reference`, the port's tensor code of those steps.

The kernel is compiled with ``nvcc`` on first use (:mod:`.nvcc`, with
``-fmad=false``) and bound with ctypes; it launches on the current stream and
reads nothing back, so a CUDA graph can record it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import DetectionConfig

#: the kernel's limits (``CYL_MAX_*`` in ``csrc/cylinders.cu``)
MAX_REGIONS = 64
MAX_HYPOTHESES = 256
MAX_SUBSEGMENTS = 8
#: dynamic shared memory a CTA may hold on Hopper (227 KB), less the kernel's
#: ~9 kB of static arrays
MAX_SMEM_BYTES = 232448 - 10 * 1024


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


def _sizes():
    from ..features.primitives import CYL_SUBSEGMENTS, MAX_CYLINDERS, _msac_iterations
    return MAX_CYLINDERS, CYL_SUBSEGMENTS, _msac_iterations


def cylinder_stage(grid, member, try_cyl, cfg: DetectionConfig, min_activated: int
                   ) -> CylinderStage:
    """The cylinder stage of the regions ``member`` [K, C] of the cell grid
    ``grid`` (``primitives.CellGrid``): the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    return cylinders_reference(grid, member, try_cyl, cfg, min_activated)


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


