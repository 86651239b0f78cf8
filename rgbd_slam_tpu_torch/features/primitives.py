"""CAPE-style plane and cylinder extraction from the depth image (port of
``rgbd_slam_tpu/features/primitives.py``).

Per-cell plane fits from block-view moment reductions, mergeability edges
between neighbouring cells, connected components of those edges as the grown
regions, the histogram seed gate, a cylinder MSAC on the regions that are not
planar enough, a transitive plane merge and a convex boundary polygon per
plane.  Shapes are fixed (``MAX_PLANES`` and ``MAX_CYLINDERS`` slots, masked).

Differences from the JAX function that do not change its results:

* on the card the per-cell pass (the cloud, the cell fits, the edges, the
  normal bins: ``ops.cells_cuda``) and the cylinder stage (the axis gate to the
  routing back: ``ops.cylinders_cuda``) are CUDA kernels; on the CPU their
  plain versions run this module's functions of those steps;
* the components fixpoint (``lax.while_loop``) is one CUDA kernel on the card
  (``ops.components_cuda``), which runs to its own convergence; on the CPU it
  runs in chunks of ``CC_CHUNK`` iterations with one host read after each
  chunk.  The fixpoint does not depend on the schedule, so the labels are the
  same;
* ``lax.top_k`` is a stable descending sort (ties to the lower index);
* ``segment_sum`` is ``index_add_`` with the sentinel bucket ``n_cells``;
* the cylinder triplet scramble's uint32 arithmetic is int64 masked to 32 bits;
* ``.at[].set(mode="drop")`` scatters into a sink column.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import profiling
from ..config import CameraIntrinsics, DetectionConfig
from ..geometry.covariances import get_depth_quantization
from ..geometry.eig3 import sym_eig3_smallest
from ..ops import cells_cuda, components_cuda, cylinders_cuda
from ..ops.components_cuda import CC_CHUNK, FIXPOINT_READS, _clear_edge  # noqa: F401
from ..ops.fast import top_k
from ..pose.linalg6 import solve_spd
from ..utils import polygon as poly
from . import moments

MAX_PLANES = 16
MAX_CYLINDERS = 4
HIST_BINS = 20
#: sub-segments extracted per cylinder region
CYL_SUBSEGMENTS = 3


class CellGrid(NamedTuple):
    """Per-cell plane-fit state, [C] leading axis (gh*gw cells row-major)."""
    count: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor
    normal: torch.Tensor
    d: torch.Tensor
    mse: torch.Tensor
    score: torch.Tensor
    planar: torch.Tensor
    distance_tol: torch.Tensor


class DetectedPlanes(NamedTuple):
    params: torch.Tensor       # [MAX_PLANES, 4] camera-space hessian [n, d]
    centroid: torch.Tensor     # [MAX_PLANES, 3]
    mse: torch.Tensor          # [MAX_PLANES]
    point_count: torch.Tensor  # [MAX_PLANES]
    cloud_cov: torch.Tensor    # [MAX_PLANES, 3, 3] inverse raw moment matrix
    poly_verts: torch.Tensor   # [MAX_PLANES, V, 2] plane-basis boundary polygon
    poly_count: torch.Tensor   # [MAX_PLANES] int32
    basis_center: torch.Tensor  # [MAX_PLANES, 3]
    basis_u: torch.Tensor      # [MAX_PLANES, 3]
    basis_v: torch.Tensor      # [MAX_PLANES, 3]
    cell_mask: torch.Tensor    # [MAX_PLANES, C]
    valid: torch.Tensor        # [MAX_PLANES] bool


class DetectedCylinders(NamedTuple):
    axis: torch.Tensor         # [MAX_CYLINDERS, 3]
    center: torch.Tensor       # [MAX_CYLINDERS, 3] point on axis
    radius: torch.Tensor       # [MAX_CYLINDERS]
    mse: torch.Tensor          # [MAX_CYLINDERS]
    cell_mask: torch.Tensor    # [MAX_CYLINDERS, C]
    valid: torch.Tensor        # [MAX_CYLINDERS] bool


# ---------------------------------------------------------------------------
# per-cell fitting
# ---------------------------------------------------------------------------

def fit_plane_from_moments(cnt, mean, m2):
    """Closed-form eigen plane fit from centered moments, batched.  Returns
    (normal, d, centroid, mse, score, ok); the normal faces the camera (d > 0)."""
    safe = torch.clamp_min(cnt, 1.0)
    cov = 0.5 * (m2 + m2.transpose(-1, -2))
    eigvals, normal = sym_eig3_smallest(cov)
    eigvals = torch.abs(eigvals)
    d = -(normal * mean).sum(dim=-1)
    flip = d <= 0
    normal = torch.where(flip[..., None], -normal, normal)
    d = torch.where(flip, -d, d)
    mse = eigvals[..., 0] / safe
    score = eigvals[..., 1] / torch.clamp_min(eigvals[..., 0], 1e-6)
    ok = (cnt > 0) & torch.isfinite(normal).all(dim=-1)
    return normal, d, mean, mse, score, ok


def fit_cells(cloud, valid, cfg: DetectionConfig = DetectionConfig()) -> CellGrid:
    """Plane fit of every depth-patch cell from block-view reductions over
    ``[gh, patch, gw, patch]`` views of the dense cloud."""
    patch = cfg.depth_patch_size_px
    h, w = cloud.shape[:2]
    gh, gw = h // patch, w // patch
    c = gh * gw
    ppc = patch * patch
    dt = cloud.dtype

    blocks = cloud.reshape(gh, patch, gw, patch, 3)
    wts = valid.to(dt).reshape(gh, patch, gw, patch)

    # continuity of each cell's middle row and column
    mid = patch // 2
    z = cloud[..., 2]
    row_lines = z[mid::patch, :].reshape(gh, 1, gw, patch).permute(0, 2, 1, 3) \
        .reshape(c, 1, patch)
    col_lines = z[:, mid::patch].reshape(gh, patch, gw, 1).permute(0, 2, 3, 1) \
        .reshape(c, 1, patch)

    def line_continuous(line):
        prev = line[:, :, :-1]
        nxt = line[:, :, 1:]
        both = (prev > 0) & (nxt > 0)
        jump = torch.abs(nxt - prev) > 4.0 * get_depth_quantization(torch.clamp_min(nxt, 1.0))
        return ~(both & jump).any(dim=-1).any(dim=-1)

    continuous = line_continuous(row_lines) & line_continuous(col_lines)

    cnt = wts.sum(dim=(1, 3)).reshape(c)
    safe = torch.clamp_min(cnt, 1.0)
    sum_p = torch.stack([(wts * blocks[..., i]).sum(dim=(1, 3)) for i in range(3)],
                        dim=-1).reshape(c, 3)
    mean = sum_p / safe[:, None]
    mb = mean.reshape(gh, 1, gw, 1, 3)
    dev = [wts * (blocks[..., i] - mb[..., i]) for i in range(3)]
    raw = [blocks[..., i] - mb[..., i] for i in range(3)]
    rows = []
    for i in range(3):
        row = [None, None, None]
        for j in range(3):
            row[j] = rows[j][i] if j < i else (dev[i] * raw[j]).sum(dim=(1, 3)).reshape(c)
        rows.append(row)
    m2 = torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    min_points = int(ppc * cfg.min_zero_depth_proportion)
    enough = (cnt >= min_points) & (cnt >= ppc // 2)
    normal, d, centroid, mse, score, fit_ok = fit_plane_from_moments(cnt, mean, m2)
    planar = (continuous & enough & fit_ok
              & (mse <= get_depth_quantization(torch.abs(centroid[..., 2])) ** 2))

    sin_merge = math.sin(math.radians(cfg.max_plane_merge_angle_d))
    corner0 = cloud[::patch, ::patch].reshape(c, 3)
    corner1 = cloud[patch - 1::patch, patch - 1::patch].reshape(c, 3)
    diameter = torch.linalg.vector_norm(corner1 - corner0, dim=-1)
    tol = torch.clamp_max(diameter * sin_merge * torch.sqrt(torch.clamp_min(cnt, 1.0)),
                          cfg.max_plane_merge_distance_mm)
    tol = torch.where(planar, tol, torch.zeros_like(tol))
    return CellGrid(count=cnt, mean=mean, m2=m2, normal=normal, d=d, mse=mse,
                    score=score, planar=planar, distance_tol=tol)


# ---------------------------------------------------------------------------
# mergeability edges + connected components
# ---------------------------------------------------------------------------

def _edge_maps(grid: CellGrid, gh: int, gw: int, cos_max: float):
    """Directed mergeability edges [4, gh, gw]: edge[dir][y, x] is True when the
    neighbour in that direction may grow into cell (y, x)."""
    n = grid.normal.reshape(gh, gw, 3)
    d = grid.d.reshape(gh, gw)
    cen = grid.mean.reshape(gh, gw, 3)
    tol = grid.distance_tol.reshape(gh, gw)
    planar = grid.planar.reshape(gh, gw)
    edges = []
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        n_from = torch.roll(n, (dy, dx), dims=(0, 1))
        d_from = torch.roll(d, (dy, dx), dims=(0, 1))
        p_from = torch.roll(planar, (dy, dx), dims=(0, 1))
        cos_ab = (n_from * n).sum(dim=-1)
        dist = torch.abs((n_from * cen).sum(dim=-1) + d_from)
        e = (cos_ab > cos_max) & (dist < tol) & planar & p_from
        if dx:
            e = _clear_edge(e, 1, first=dx == 1)
        if dy:
            e = _clear_edge(e, 0, first=dy == 1)
        edges.append(e)
    return torch.stack(edges)


def _connected_components(edges, planar, gh: int, gw: int):
    """Connected components of the planar-cell mergeability graph: min-label
    propagation with pointer-jumping shortcuts, run to its fixpoint.  Returns [C]
    int64 labels (component = min member cell index; non-planar cells get C).
    On the card the fixpoint runs in one CUDA kernel and reads the host
    nowhere; on the CPU the plain version reads the host once per
    ``CC_CHUNK`` rounds (``ops.components_cuda``)."""
    return components_cuda.connected_components(edges, planar, gh, gw)


def _normal_bins(normals):
    """Polar-angle histogram bin of each normal."""
    nx, ny, nz = normals[..., 0], normals[..., 1], normals[..., 2]
    proj = torch.arccos(torch.clamp(-nz, -1.0, 1.0))
    ang = torch.atan2(nx, ny)
    bx = torch.clamp((proj / math.pi * HIST_BINS).to(torch.int32), 0, HIST_BINS - 1)
    by = torch.clamp(((ang + math.pi) / (2 * math.pi) * HIST_BINS).to(torch.int32),
                     0, HIST_BINS - 1)
    return bx * HIST_BINS + by


# ---------------------------------------------------------------------------
# cylinder fitting
# ---------------------------------------------------------------------------

def _msac_iterations(cfg: DetectionConfig) -> int:
    """RANSAC iteration count from the inlier-proportion formula."""
    num = math.log(1.0 - cfg.cylinder_ransac_probability_of_success)
    den = math.log(1.0 - cfg.cylinder_ransac_inlier_proportion ** 3)
    return max(1, int(num / den))


def _cylinder_axis(grid: CellGrid, active, cfg: DetectionConfig):
    """Per-region axis estimate and acceptance, batched over regions ``active``
    [K, C]: smallest eigenvector of the weighted normal outer-product sum, gated
    by lambda_max / lambda_min >= cylinder_ransac_min_score."""
    w0 = (active & grid.planar).to(grid.normal.dtype)
    nn = torch.einsum("kc,ci,cj->kij", w0, grid.normal, grid.normal)
    eigvals, axis = sym_eig3_smallest(nn)
    score = eigvals[..., 2] / torch.clamp_min(eigvals[..., 0], 1e-12)
    return axis, (score >= cfg.cylinder_ransac_min_score) & (w0.sum(dim=-1) >= 3)


def _lls_cylinder(sum_n, sum_c, sum_nc, k):
    """Closed-form LLS cylinder from sums over a cell set, batched:
    a = 1 - |sum_n|^2/k^2, b = sum(n.c)/k - (sum_n . sum_c)/k^2, radius = b/a."""
    inv_k = 1.0 / torch.clamp_min(k, 1.0)
    a = 1.0 - (sum_n * sum_n).sum(dim=-1) * inv_k * inv_k
    b = sum_nc * inv_k - (sum_n * sum_c).sum(dim=-1) * inv_k * inv_k
    radius = b / torch.where(torch.abs(a) < 1e-9, torch.full_like(a, 1e-9), a)
    center = (sum_c - radius[..., None] * sum_n) * inv_k[..., None]
    return radius, center


def _fit_cylinder(grid: CellGrid, active, axis, axis_ok, cfg: DetectionConfig,
                  min_activated: int):
    """Multi-sub-segment cylinder fit over each region's activated cells, batched
    over regions R: each round runs a truncated-relative-distance MSAC over
    deterministically scrambled cell triplets, refits on the inliers, records
    the MSE and removes the inliers.  ``active`` [R, C], ``axis`` [R, 3],
    ``axis_ok`` [R].  Returns (center [R, S, 3], radius [R, S], mse [R, S],
    valid [R, S], inliers [R, S, C])."""
    dt = grid.normal.dtype
    dev = grid.normal.device
    planar_active = active & grid.planar
    cnt0 = planar_active.to(dt).sum(dim=-1)

    cdot = grid.mean @ axis.T                               # [C, R]
    proj_c = grid.mean[None] - cdot.T[..., None] * axis[:, None, :]
    ndot = grid.normal @ axis.T
    proj_n = grid.normal[None] - ndot.T[..., None] * axis[:, None, :]
    proj_n = proj_n / torch.clamp_min(
        torch.linalg.vector_norm(proj_n, dim=-1, keepdim=True), 1e-9)

    r_n, nc = active.shape
    n_hyp = _msac_iterations(cfg)
    trunc = cfg.cylinder_ransac_sqrt_max_distance
    base = torch.arange(n_hyp * 3, dtype=torch.int64, device=dev).reshape(n_hyp, 3)
    cells = torch.arange(nc, device=dev).expand(r_n, nc)

    remaining = planar_active & axis_ok[:, None]
    centers, radii, mses, valids, inlier_masks = [], [], [], [], []
    for si in range(CYL_SUBSEGMENTS):
        rw = remaining.to(dt)
        n_left = rw.sum(dim=-1)
        round_ok = axis_ok & (n_left > min_activated) & (n_left > 0.1 * cnt0) \
            & (n_left >= 3)

        # scrambled triplets over the compacted remaining set (uint32 arithmetic)
        n_rem = remaining.to(torch.int64).sum(dim=-1)
        rank = torch.cumsum(remaining.to(torch.int64), dim=-1) - 1
        compact = torch.zeros((r_n, nc + 1), dtype=torch.int64, device=dev).scatter(
            1, torch.where(remaining, rank, nc), cells)[:, :nc]
        na = torch.clamp_min(n_rem, 1)
        tri = (((base + si * 7919) * 2654435761) & 0xFFFFFFFF)[None] % na[:, None, None]
        tri_idx = torch.gather(compact, 1, tri.reshape(r_n, -1))      # [R, B*3]

        def pick(x):
            return torch.gather(x, 1, tri_idx[..., None].expand(r_n, n_hyp * 3, 3)) \
                .reshape(r_n, n_hyp, 3, 3)
        tn = pick(proj_n)
        tc = pick(proj_c)
        radius_h, center_h = _lls_cylinder(tn.sum(dim=2), tc.sum(dim=2),
                                           (tn * tc).sum(dim=(2, 3)),
                                           torch.full((r_n, n_hyp), 3.0, dtype=dt, device=dev))

        # truncated relative distance |(c_i - r n_i) - center|^2 / r^2, expanded
        cc = (proj_c * proj_c).sum(dim=-1)                            # [R, C]
        cn = (proj_c * proj_n).sum(dim=-1)
        c_dot = proj_c @ center_h.transpose(1, 2)                     # [R, C, B]
        n_dot = proj_n @ center_h.transpose(1, 2)
        r_ = radius_h[..., None]                                      # [R, B, 1]
        d2 = (cc[:, None, :] - 2.0 * r_ * cn[:, None, :] + r_ * r_
              - 2.0 * c_dot.transpose(1, 2) + 2.0 * r_ * n_dot.transpose(1, 2)
              + (center_h * center_h).sum(dim=-1)[..., None]) \
            / torch.clamp_min(r_ * r_, 1e-12)                         # [R, B, C]
        msac = (rw[:, None, :] * torch.clamp_max(d2, trunc)).sum(dim=-1)
        best = torch.argmin(msac, dim=-1)
        d2_best = torch.gather(d2, 1, best[:, None, None].expand(r_n, 1, nc))[:, 0]

        inliers = remaining & (d2_best < trunc)
        k = inliers.to(dt).sum(dim=-1)
        seg_ok = round_ok & (k >= 6)

        iw = inliers.to(dt)
        radius, center = _lls_cylinder((proj_n * iw[..., None]).sum(dim=1),
                                       (proj_c * iw[..., None]).sum(dim=1),
                                       (proj_n * proj_c * iw[..., None]).sum(dim=(1, 2)), k)
        radius = torch.abs(radius)

        rel = grid.mean[None] - center[:, None, :]
        perp = rel - (rel @ axis[..., None]) * axis[:, None, :]
        dist = torch.linalg.vector_norm(perp, dim=-1) - radius[:, None]
        mse = (iw * dist * dist).sum(dim=-1) / torch.clamp_min(k, 1.0)

        centers.append(center)
        radii.append(radius)
        mses.append(torch.where(seg_ok, mse, torch.full_like(mse, float("inf"))))
        valids.append(seg_ok)
        inlier_masks.append(inliers & seg_ok[:, None])
        remaining = remaining & ~(inliers & seg_ok[:, None])

    return (torch.stack(centers, dim=1), torch.stack(radii, dim=1),
            torch.stack(mses, dim=1), torch.stack(valids, dim=1),
            torch.stack(inlier_masks, dim=1))


# ---------------------------------------------------------------------------
# main pipeline
# ---------------------------------------------------------------------------

def _compact_to(cap: int, accept, *arrays):
    """Gather accepted candidates (in rank order) into the first ``cap`` slots by
    a one-hot [cap, n] selection matmul, exact in f32; each array comes with the
    fill value of empty slots.  Returns (count, outputs)."""
    dt = torch.float32
    dev = accept.device
    rank = torch.cumsum(accept.to(torch.int64), dim=0) - 1
    dest = torch.where(accept & (rank < cap), rank, cap)
    num = torch.clamp_max(accept.to(torch.int64).sum(), cap)
    onehot = (dest[None, :] == torch.arange(cap, device=dev)[:, None]).to(dt)
    row_has = onehot.sum(dim=-1) > 0
    outs = []
    for a, fill in arrays:
        flat = a.reshape(a.shape[0], -1).to(dt)
        flat = torch.where(accept[:, None], flat, torch.zeros_like(flat))
        picked = torch.where(row_has[:, None], onehot @ flat,
                             torch.full_like(flat[:1].expand(cap, -1), fill))
        out = picked.reshape((cap,) + a.shape[1:])
        outs.append(out > 0.5 if a.dtype == torch.bool else out.to(a.dtype))
    return num, outs


def check_grid(height: int, width: int, cfg: DetectionConfig):
    """Raise, with the kernel's own message, on a frame of ``height`` x
    ``width`` px whose grid of ``cfg.depth_patch_size_px`` cells the card's
    plane kernels take on no path: the cylinder stage (``MAX_PLANES +
    MAX_CYLINDERS`` regions) and the components.  Pure arithmetic, so that
    ``engine.init_state`` refuses such a camera on any device, before the
    first frame."""
    patch = cfg.depth_patch_size_px
    gh, gw = height // patch, width // patch
    cylinders_cuda.check_grid(gh * gw, MAX_PLANES + MAX_CYLINDERS)
    components_cuda.check_grid(gh, gw)


def find_primitives(depth_mm, cam: CameraIntrinsics,
                    cfg: DetectionConfig = DetectionConfig()):
    """Full CAPE extraction for one frame.  Returns (DetectedPlanes,
    DetectedCylinders)."""
    patch = cfg.depth_patch_size_px
    h, w = depth_mm.shape
    gh, gw = h // patch, w // patch
    n_cells = gh * gw
    dt = depth_mm.dtype
    dev = depth_mm.device

    # the per-cell pass: cell fits, edges, normal bins, cell-centre points
    cells = cells_cuda.cell_pass(depth_mm, cam, cfg)
    grid = CellGrid(*cells[:len(CellGrid._fields)])
    cos_max = cells_cuda.merge_angle_cos(cfg)

    seed_threshold = max(1, int(cfg.min_plane_seed_proportion * n_cells))
    min_activated = max(1, int(cfg.min_cell_activated_proportion * n_cells))

    # grown regions = connected components; the largest K are the seed loop's
    comp = _connected_components(cells.edges, grid.planar, gh, gw)
    sizes = torch.zeros(n_cells + 1, dtype=torch.int32, device=dev).index_add_(
        0, comp, grid.planar.to(torch.int32))[:n_cells]
    k_cand = MAX_PLANES + MAX_CYLINDERS
    cand_sizes, cand_roots = top_k(sizes, k_cand)
    member = (comp[None, :] == cand_roots[:, None]) & (cand_sizes[:, None] > 0)

    cnt, mean, m2 = moments.combine(grid.count, grid.mean, grid.m2, member)
    normal, d, centroid, mse, score, fit_ok = fit_plane_from_moments(cnt, mean, m2)

    # histogram seed gate: some orientation bin among the region's own cells
    # holds >= seed_threshold planar cells (one-hot count matmul, exact in f32)
    bin_ids = torch.arange(HIST_BINS * HIST_BINS, device=dev)
    onehot = (cells.bins[:, None] == bin_ids[None, :]) & grid.planar[:, None]
    member_bin_counts = member.to(dt) @ onehot.to(dt)
    bin_gate = member_bin_counts.amax(dim=-1) >= seed_threshold
    grown_ok = (cand_sizes >= min_activated) & bin_gate & fit_ok

    # plane-vs-cylinder model choice
    is_plane = grown_ok & (score > 100.0)
    try_cyl = grown_ok & ~is_plane & (cand_sizes > 5)
    # the cylinder stage: axis gate, slot selection, sub-segment MSAC, routing;
    # the step's nested section ``cylinders``, and its count of live slots
    profiling.stamp("cylinders.start")
    cy_axis, axis_ok, cy_selected, cy_centers, cy_radii, cy_valids, cy_mses, cy_inliers = \
        cylinders_cuda.cylinder_stage(grid, member, try_cyl, cfg, min_activated)
    profiling.stamp("cylinders")
    profiling.count_cylinders(cy_selected.sum())
    # per-sub-segment model choice against the region's merged-plane MSE
    cyl_better = cy_mses < mse[:, None]
    seg_cyl_better = try_cyl[:, None] & cy_valids & cyl_better
    seg_plane_better = try_cyl[:, None] & cy_valids & ~cyl_better
    seg_flat = seg_cyl_better.reshape(-1)
    cyl_rank = torch.cumsum(seg_flat.to(torch.int64), dim=0) - 1
    overflow = seg_flat & (cyl_rank >= MAX_CYLINDERS)
    seg_flat = seg_flat & ~overflow
    s_ = CYL_SUBSEGMENTS
    accept_plane = (is_plane | seg_plane_better.any(dim=1)
                    | overflow.reshape(k_cand, s_).any(dim=1)
                    | (try_cyl & axis_ok & ~cy_selected))

    p_num, (p_cnt, p_mean, p_m2, p_cellmask) = _compact_to(
        MAX_PLANES, accept_plane, (cnt, 0.0), (mean, 0.0), (m2, 0.0), (member, 0.0))
    ks = k_cand * s_
    axis_flat = cy_axis[:, None, :].expand(k_cand, s_, 3).reshape(ks, 3)
    c_num, (c_axis, c_center, c_radius, c_mse, c_cells) = _compact_to(
        MAX_CYLINDERS, seg_flat, (axis_flat, 0.0), (cy_centers.reshape(ks, 3), 0.0),
        (cy_radii.reshape(ks), 0.0), (cy_mses.reshape(ks), float("inf")),
        (cy_inliers.reshape(ks, n_cells), 0.0))

    plane_valid = torch.arange(MAX_PLANES, device=dev) < p_num
    p_cnt, p_mean, p_m2, p_cellmask, plane_valid = _merge_planes(
        p_cnt, p_mean, p_m2, p_cellmask, plane_valid, gh, gw, cos_max,
        cfg.max_plane_merge_distance_mm)

    normal, d, centroid, mse, score, fit_ok = fit_plane_from_moments(p_cnt, p_mean, p_m2)
    plane_valid = plane_valid & fit_ok
    params = torch.cat([normal, d[..., None]], dim=-1)

    # plane-parameter covariance source: inverse raw moment matrix, norm-scaled
    raw = moments.raw_second_moment(p_cnt, p_mean, p_m2)
    scale = torch.clamp_min(torch.linalg.vector_norm(raw, dim=(-2, -1), keepdim=True), 1.0)
    eye = torch.eye(3, dtype=dt, device=dev)
    cloud_cov = solve_spd(raw / scale + 1e-9 * eye, eye.expand(raw.shape)) / scale

    planes_out = _build_plane_boundaries(params, centroid, mse, p_cnt, cloud_cov,
                                         p_cellmask, plane_valid, cells.centers,
                                         cells.centers_valid, gh, gw)
    cylinders = DetectedCylinders(
        axis=c_axis, center=c_center, radius=c_radius, mse=c_mse, cell_mask=c_cells,
        valid=torch.arange(MAX_CYLINDERS, device=dev) < c_num)
    return planes_out, cylinders


def _merge_planes(p_cnt, p_mean, p_m2, p_cellmask, plane_valid, gh, gw, cos_max,
                  max_dist):
    """Merge adjacent co-planar grown planes: the symmetrized pairwise
    mergeability matrix, its transitive closure by boolean matmul squaring, and
    one masked moment combine per group onto its minimum-index member."""
    f32 = torch.float32
    dev = p_cnt.device
    cell_maps = p_cellmask.reshape(MAX_PLANES, gh, gw)
    right = _clear_edge(torch.roll(cell_maps, -1, dims=2), 2, first=False)
    below = _clear_edge(torch.roll(cell_maps, -1, dims=1), 1, first=False)
    adj = torch.zeros((MAX_PLANES, MAX_PLANES), dtype=torch.bool, device=dev)
    flat = cell_maps.reshape(MAX_PLANES, -1).to(f32)
    for shifted in (right, below):
        overlap = (flat @ shifted.reshape(MAX_PLANES, -1).to(f32).T) > 0
        adj = adj | overlap | overlap.T

    n, d, cen, _, _, _ = fit_plane_from_moments(p_cnt, p_mean, p_m2)
    cos_ij = n @ n.T
    dist_ij = torch.abs(n @ cen.T + d[:, None])   # [i, j] = |n_i . c_j + d_i|
    ok = plane_valid[:, None] & plane_valid[None, :]
    m = adj & ok & (cos_ij > cos_max) & ((dist_ij < max_dist) | (dist_ij.T < max_dist))
    m = m | torch.eye(MAX_PLANES, dtype=torch.bool, device=dev)
    for _ in range(4):   # path length doubles per squaring: 2^4 >= MAX_PLANES
        m = (m.to(f32) @ m.to(f32)) > 0
    root = torch.argmax(m.to(torch.int32), dim=1)   # first connected index

    idx = torch.arange(MAX_PLANES, device=dev)
    group = (root[None, :] == idx[:, None]) & plane_valid[None, :]
    p_cnt, p_mean, p_m2 = moments.combine(p_cnt, p_mean, p_m2, group)
    p_cellmask = (group.to(f32) @ p_cellmask.to(f32)) > 0
    return p_cnt, p_mean, p_m2, p_cellmask, plane_valid & (root == idx)


def _build_plane_boundaries(params, centroid, mse, p_count, cloud_cov, p_cellmask,
                            plane_valid, centers, centers_valid, gh, gw):
    """Boundary polygon per plane: cross-erode / square-dilate mask difference,
    cell-centre camera points (``centers`` [gh, gw, 3] and their valid flags
    ``centers_valid``, from the per-cell pass) within 3 sqrt(MSE) of the plane,
    convex hull in the plane basis."""
    dev = params.device
    cell_maps = p_cellmask.reshape(MAX_PLANES, gh, gw)

    def shifted(m, dy, dx):
        s = torch.roll(m, (dy, dx), dims=(1, 2))
        if dy:
            s = _clear_edge(s, 1, first=dy == 1)
        if dx:
            s = _clear_edge(s, 2, first=dx == 1)
        return s

    eroded = cell_maps & shifted(cell_maps, 0, 1) & shifted(cell_maps, 0, -1) \
        & shifted(cell_maps, 1, 0) & shifted(cell_maps, -1, 0)
    dilated = cell_maps
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            dilated = dilated | shifted(cell_maps, dy, dx)
    boundary = dilated & ~eroded

    dist = torch.abs((params[:, None, None, :3] * centers[None]).sum(dim=-1)
                     + params[:, 3, None, None])
    in_plane = boundary & centers_valid[None] & (
        dist < 3.0 * torch.sqrt(torch.clamp_min(mse, 1e-6))[:, None, None] + 1.0)
    mask = in_plane.reshape(MAX_PLANES, -1) & plane_valid[:, None]

    center3 = params[:, :3] * (-params[:, 3:4])
    u, v = poly.plane_basis(params[:, :3])
    pts2 = poly.project_to_plane(centers.reshape(-1, 3)[None], center3, u, v)
    verts, counts = poly.convex_hull_by_angle(pts2, mask)
    return DetectedPlanes(
        params=params, centroid=centroid, mse=mse, point_count=p_count,
        cloud_cov=cloud_cov, poly_verts=verts, poly_count=counts, basis_center=center3,
        basis_u=u, basis_v=v, cell_mask=p_cellmask, valid=plane_valid & (counts >= 3))
