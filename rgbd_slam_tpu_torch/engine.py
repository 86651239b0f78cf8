"""RGB-D SLAM engine: the per-frame tracking step (port of
``rgbd_slam_tpu/engine.py``): points, planes and lines.

``step(state, gray, depth) -> (state, output)`` over the JAX package's
fixed-capacity masked state: pyramid, forward-backward LK of the tracked map
points (CUDA kernels on the card), FAST + BRIEF and windowed matching on refresh
frames, CAPE plane and cylinder extraction and plane matching, RANSAC pose
optimization with a Monte-Carlo covariance, Kalman map updates (points and
planes, with the polygon merge), lifecycle, insertion and the next tracked set.
With ``with_lines=True`` line segments are detected, matched to the line map at
the predicted pose, enter the pose as a residual block, and the line map gets
its per-endpoint Kalman update, lifecycle and insertion.

Differences from the JAX step that do not change its results:

* ``lax.cond`` on the detection flag: the flag stays a tensor on the device,
  and the detection and matching branches both run on every frame; their
  outputs are selected with ``torch.where`` against the skip branches'
  constants (JAX's ``skip_branch`` and ``no_match_branch``).  Neither branch
  draws a random number, so the selected values are the branch's.
* the plane extraction's components ``lax.while_loop`` is one CUDA kernel on
  the card (``ops.components_cuda``); on the CPU its plain version reads the
  host once per ``ops.components_cuda.CC_CHUNK`` rounds.  On the card the step
  reads the host nowhere, so ``step_graph.StepGraph`` records it as one CUDA
  graph, the counterpart of ``jax.jit(step)``.
* ``.at[i].set(..., mode="drop")`` is :func:`_scatter_set`: out-of-range rows go
  to a sink row, and among duplicate indices the last write wins, which is what
  XLA's serial scatter does (the compacted blocks scatter their unfilled rows to
  slot 0, so the order matters there).
* Randomness comes from the state's ``torch.Generator`` (which ``step``
  advances, by :func:`draw_step_draws` at the start of the step), or from
  ``draws``, which replaces every draw of the step.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import profiling
from .config import CameraIntrinsics, SlamConfig
from .device import resolve_device
from .features import lines as lines_mod
from .features import primitives
from .features.lines import MAX_LINES as DET_LINES_CAP
from .features.primitives import MAX_PLANES
from .geometry import covariances as cov_mod
from .geometry import inverse_depth as idp
from .geometry import pinhole, se3
from .geometry import planes as planes_geo
from .mapping import maps
from .ops import brief, fast, image, matching, optical_flow
from .ops.fast import top_k
from .pose.features import MatchedFeatures
from .pose.optimizer import (PoseDraws, compact_rows, compute_optimized_pose,
                             draw_pose_draws_for)
from .tracking import inverse_depth_tracking as idt
from .tracking import kalman, motion_model
from .utils import polygon as poly


class SlamState(NamedTuple):
    quat: torch.Tensor
    position: torch.Tensor
    pose_cov: torch.Tensor          # [6, 6]
    motion: motion_model.MotionModelState
    points: maps.PointMap
    points2d: maps.Point2DMap
    planes: maps.PlaneMap
    lines: maps.LineMap
    prev_pyramid: tuple             # previous frame's LK pyramid (levels+1 images)
    tracked_uv: torch.Tensor        # [T, 2] screen pos of tracked map points
    tracked_ok: torch.Tensor        # [T]
    tracked_map_idx: torch.Tensor   # [T] int32 map slot of each tracked row
    frame_idx: torch.Tensor
    failed_count: torch.Tensor
    is_lost: torch.Tensor
    next_id: torch.Tensor
    generator: torch.Generator      # takes the place of the JAX state's key


class StepOutput(NamedTuple):
    quat: torch.Tensor
    position: torch.Tensor
    pose_cov: torch.Tensor
    success: torch.Tensor
    is_lost: torch.Tensor
    n_point_matches: torch.Tensor
    n_point_inliers: torch.Tensor
    n_points_alive: torch.Tensor
    n_planes_alive: torch.Tensor
    n_detected: torch.Tensor
    n_lines: torch.Tensor
    n_line_matches: torch.Tensor
    n_lines_alive: torch.Tensor
    n_cylinders: torch.Tensor
    n_plane_merge_dropped: torch.Tensor
    cylinder_cells: torch.Tensor
    point_obs_uv: torch.Tensor      # [M3, 2] matched screen observation
    point_obs_z: torch.Tensor       # [M3] measured depth (0 = depth-less)
    point_matched: torch.Tensor     # [M3] bool (match AND RANSAC inlier)
    point_fid: torch.Tensor         # [M3] map feature id (-1 = empty)
    n_evicted: torch.Tensor
    point_evicted: torch.Tensor
    point_evict_pos: torch.Tensor
    point2d_evicted: torch.Tensor
    point2d_evict_pos: torch.Tensor
    plane_evicted: torch.Tensor
    plane_evict_params: torch.Tensor
    plane_evict_verts: torch.Tensor
    plane_evict_count: torch.Tensor
    plane_evict_center: torch.Tensor
    plane_evict_u: torch.Tensor
    plane_evict_v: torch.Tensor
    line_evicted: torch.Tensor
    line_evict_eps: torch.Tensor


class StepDraws(NamedTuple):
    """Every random draw of one :func:`step` (engine.py:963 and the pose
    optimizer's in the JAX package)."""
    drop: torch.Tensor   # [M3] int in [0, 2 * keypoint_refresh_frequency)
    pose: PoseDraws


def draw_step_draws(cfg: SlamConfig, generator: torch.Generator, device=None,
                    dtype=torch.float32) -> StepDraws:
    """Every draw of one :func:`step` from ``generator``, in the order the step
    makes them when it is given no ``draws``: the same numbers."""
    m = cfg.mapping
    drop = torch.randint(0, 2 * cfg.detection.keypoint_refresh_frequency,
                         (m.max_points_3d,), generator=generator, device=device)
    caps = (m.max_points_3d, m.max_points_2d, m.max_planes, m.max_lines)
    return StepDraws(drop=drop, pose=draw_pose_draws_for(caps, cfg.engine, generator,
                                                        device=device, dtype=dtype))


def init_state(cam: CameraIntrinsics, cfg: SlamConfig, quat=None, position=None,
               seed: int = 0, device=None, with_planes: bool = True) -> SlamState:
    """A fresh state on ``device`` (``None``: the card, see ``resolve_device``).
    On a card with planes on, raises on a camera and cell size whose grid the
    plane kernels take on no path (``primitives.check_grid``); the CPU's plain
    version takes any grid."""
    device = resolve_device(device)
    if with_planes and device.type == "cuda":
        primitives.check_grid(cam.height, cam.width, cfg.detection)
    dt = torch.float32
    t_cap = cfg.mapping.max_tracked_points
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)

    def i32(v):   # a fill on the device: no copy from the host, no sync
        return torch.full((), v, dtype=torch.int32, device=device)

    return SlamState(
        quat=se3.quat_identity(dt, device) if quat is None
        else torch.as_tensor(quat, dtype=dt, device=device),
        position=torch.zeros(3, dtype=dt, device=device) if position is None
        else torch.as_tensor(position, dtype=dt, device=device),
        pose_cov=torch.eye(6, dtype=dt, device=device) * 1e-3,
        motion=motion_model.reset(dt, device),
        points=maps.empty_point_map(cfg.mapping.max_points_3d, device=device),
        points2d=maps.empty_point2d_map(cfg.mapping.max_points_2d, device=device),
        planes=maps.empty_plane_map(cfg.mapping.max_planes, device=device),
        lines=maps.empty_line_map(cfg.mapping.max_lines, device=device),
        prev_pyramid=tuple(image.build_pyramid(
            torch.zeros((cam.height, cam.width), dtype=dt, device=device),
            cfg.detection.optical_flow_pyramid_depth)),
        tracked_uv=torch.zeros((t_cap, 2), dtype=dt, device=device),
        tracked_ok=torch.zeros((t_cap,), dtype=torch.bool, device=device),
        tracked_map_idx=torch.full((t_cap,), -1, dtype=torch.int32, device=device),
        frame_idx=i32(0), failed_count=i32(0),
        is_lost=torch.zeros((), dtype=torch.bool, device=device), next_id=i32(1),
        generator=generator,
    )


def _compact_mask(mask, cap: int):
    """Indices of the masked rows in a fixed-capacity block (idx [cap], keep
    [cap] bool), so rare per-slot work runs at a small static size."""
    return compact_rows(mask, cap)


def _sample_depth(depth, uv):
    """Nearest-pixel depth lookup."""
    h, w = depth.shape
    x = torch.round(uv[..., 0]).clamp(-1e9, 1e9).to(torch.int64).clamp(0, w - 1)
    y = torch.round(uv[..., 1]).clamp(-1e9, 1e9).to(torch.int64).clamp(0, h - 1)
    return depth[y, x]


def _scatter_set(dst, idx, src):
    """``dst.at[idx].set(src, mode="drop")`` along axis 0: indices outside
    [0, len) are dropped and, among duplicate indices, the last row wins."""
    n = dst.shape[0]
    idx = idx.to(torch.int64)
    shape = idx.shape + dst.shape[1:]
    if isinstance(src, torch.Tensor):
        src = src.to(dst.dtype).expand(shape)
    else:  # a Python scalar fills on the device (no host-to-device copy)
        src = torch.full(shape, src, dtype=dst.dtype, device=dst.device)
    order = torch.argsort(idx, stable=True)
    sorted_idx = idx[order]
    last_sorted = torch.ones_like(sorted_idx, dtype=torch.bool)
    last_sorted[:-1] = sorted_idx[1:] != sorted_idx[:-1]
    last = torch.empty_like(last_sorted).scatter_(0, order, last_sorted)
    target = torch.where(last & (idx >= 0) & (idx < n), idx, n)
    out = torch.cat([dst, dst[:1]], dim=0)   # row n is a sink
    out[target] = src
    return out[:n]


def _match_planes(plane_map: maps.PlaneMap, det: primitives.DetectedPlanes, c2w,
                  cfg: SlamConfig):
    """Match map planes to detections at the predicted pose: normal-angle and
    distance gates, then the exact polygon intersection over the detection's
    area, computed for the 32 best-aligned gated pairs.  Each detection matches
    at most one map plane (the larger intersection wins).  Returns (match index
    [Mp] into detections or -1, detections in world coordinates)."""
    dev = c2w.device
    det_world = planes_geo.transform_plane(det.params, se3.plane_camera_to_world_matrix(c2w))
    cos_gate = math.cos(math.radians(cfg.matching.max_plane_match_angle_d))
    cosang = plane_map.params[:, :3] @ det_world[:, :3].T
    d_diff = torch.abs(plane_map.params[:, 3:4] - det_world[None, :, 3])
    gate = ((cosang > cos_gate) & (d_diff < cfg.matching.max_plane_match_distance_mm)
            & maps.alive(plane_map)[:, None] & det.valid[None, :])

    r = c2w[:3, :3]
    det_center_w = det.basis_center @ r.T + c2w[:3, 3]
    det_u_w = det.basis_u @ r.T
    det_v_w = det.basis_v @ r.T
    mp = plane_map.params.shape[0]
    nd = det.params.shape[0]
    det_area = poly.polygon_area(det.poly_verts, det.poly_count)

    # candidate pairs, best-aligned first (ties to the lower index, as lax.top_k)
    pair_cap = min(32, mp * nd)
    flat_gate = gate.reshape(-1)
    pri = torch.where(flat_gate, cosang.reshape(-1),
                      torch.full_like(cosang.reshape(-1), -float("inf")))
    _, pair_idx = top_k(pri, pair_cap)
    pm_i = pair_idx // nd
    pd_i = pair_idx % nd
    pair_ok = flat_gate[pair_idx]

    dv = det.poly_verts[pd_i]
    verts3 = (det_center_w[pd_i][:, None, :] + dv[..., 0:1] * det_u_w[pd_i][:, None, :]
              + dv[..., 1:2] * det_v_w[pd_i][:, None, :])
    verts2 = poly.project_to_plane(verts3, plane_map.basis_center[pm_i],
                                   plane_map.basis_u[pm_i], plane_map.basis_v[pm_i])
    inter_pairs = poly.convex_intersection_area(
        plane_map.poly_verts[pm_i], plane_map.poly_count[pm_i], verts2,
        det.poly_count[pd_i])
    inter = torch.zeros((mp, nd), dtype=inter_pairs.dtype, device=dev)
    inter[pm_i, pd_i] = torch.where(pair_ok, inter_pairs, torch.zeros_like(inter_pairs))
    ratio = inter / torch.clamp_min(det_area[None, :], 1e-9)
    ok_pair = gate & (ratio >= cfg.matching.min_plane_overlap_for_match)
    pair_score = torch.where(ok_pair, inter, torch.full_like(inter, -1.0))
    best = torch.argmax(pair_score, dim=1)
    best_inter = torch.gather(pair_score, 1, best[:, None])[:, 0]
    ok = best_inter > 0.0
    score = torch.where(ok, best_inter, torch.full_like(best_inter, -1.0))
    claims = best[None, :] == torch.arange(nd, device=dev)[:, None]     # [nd, mp]
    winner = torch.argmax(torch.where(claims, score[None, :],
                                      torch.full_like(claims, -1.0, dtype=score.dtype)),
                          dim=1)
    ok = ok & (winner[best] == torch.arange(mp, device=dev))
    return torch.where(ok, best, -1).to(torch.int32), det_world


def _update_planes(pl: maps.PlaneMap, det: primitives.DetectedPlanes, safe_k, k_final,
                   c2w, pose_cov3, cfg: SlamConfig):
    """Kalman update of the matched map planes with their detections in world
    coordinates at the optimized pose ``c2w``, and the merge of each matched
    plane's polygon with its detection's, compacted to ``plane_merge_cap``
    planes (the rest keep a stale polygon this frame and are counted).

    Returns (updated map, every detection's world plane [16, 4] and covariance
    [16, 4, 4], the count of merges past the cap)."""
    mp = pl.params.shape[0]
    det_world = planes_geo.normalize_plane(planes_geo.transform_plane(
        det.params, se3.plane_camera_to_world_matrix(c2w)))
    det_world_cov = cov_mod.world_plane_covariance(
        det.params, det_world, c2w,
        cov_mod.plane_covariance_from_point_cloud(det.params, det.cloud_cov), pose_cov3)
    upd_params, upd_pcov = kalman.track_planes(pl.params, pl.cov, det_world[safe_k],
                                               det_world_cov[safe_k])
    upd_params = planes_geo.normalize_plane(upd_params)
    plane_kf_ok = (cov_mod.is_covariance_valid_fast(upd_pcov)
                   & torch.isfinite(upd_params).all(dim=-1))
    do_k = k_final & maps.alive(pl) & plane_kf_ok

    # polygon merge in the map plane's basis, on the compacted matched planes
    r = c2w[:3, :3]
    merge_cap = min(cfg.mapping.plane_merge_cap, mp)
    kidx, kkeep = _compact_mask(do_k, merge_cap)
    n_merge_dropped = torch.clamp_min(do_k.to(torch.int32).sum() - merge_cap, 0) \
        .to(torch.int32)
    dk = safe_k[kidx]
    dv = det.poly_verts[dk]
    verts3 = (det.basis_center[dk] @ r.T + c2w[:3, 3])[:, None, :] \
        + dv[..., 0:1] * (det.basis_u[dk] @ r.T)[:, None, :] \
        + dv[..., 1:2] * (det.basis_v[dk] @ r.T)[:, None, :]
    verts2 = poly.project_to_plane(verts3, pl.basis_center[kidx], pl.basis_u[kidx],
                                   pl.basis_v[kidx])
    mverts_c, mcounts_c = poly.merge_polygons(pl.poly_verts[kidx], pl.poly_count[kidx],
                                              verts2, det.poly_count[dk])
    # unfilled compact rows go to the sink, not to slot 0
    kidx_w = torch.where(kkeep, kidx, mp)
    pl = pl._replace(
        params=torch.where(do_k[:, None], upd_params, pl.params),
        cov=torch.where(do_k[:, None, None], upd_pcov, pl.cov),
        poly_verts=_scatter_set(pl.poly_verts, kidx_w, mverts_c),
        poly_count=_scatter_set(pl.poly_count, kidx_w, mcounts_c))
    return pl, det_world, det_world_cov, n_merge_dropped


def _insert_planes(pl: maps.PlaneMap, det: primitives.DetectedPlanes, det_world,
                   det_world_cov, safe_k, k_final, c2w, next_id):
    """Valid detections that no map plane matched become staged map planes in
    free slots, with ids from ``next_id``.  Returns (map, next id)."""
    mp = pl.params.shape[0]
    taken = _scatter_set(torch.zeros((MAX_PLANES,), dtype=torch.bool, device=c2w.device),
                         torch.where(k_final, safe_k, MAX_PLANES), True)
    slots = maps.allocate_slots(~maps.alive(pl), det.valid & ~taken)
    ok = slots >= 0
    tgt = torch.where(ok, slots, mp)
    r = c2w[:3, :3]
    ids = next_id + torch.cumsum(ok.to(torch.int32), dim=0).to(torch.int32) - 1
    pl = pl._replace(
        params=_scatter_set(pl.params, tgt, det_world),
        cov=_scatter_set(pl.cov, tgt, det_world_cov),
        poly_verts=_scatter_set(pl.poly_verts, tgt, det.poly_verts),
        poly_count=_scatter_set(pl.poly_count, tgt, det.poly_count),
        basis_center=_scatter_set(pl.basis_center, tgt, det.basis_center @ r.T + c2w[:3, 3]),
        basis_u=_scatter_set(pl.basis_u, tgt, det.basis_u @ r.T),
        basis_v=_scatter_set(pl.basis_v, tgt, det.basis_v @ r.T),
        fid=_scatter_set(pl.fid, tgt, ids),
        is_local=_scatter_set(pl.is_local, tgt, False),
        match_count=_scatter_set(pl.match_count, tgt, 1),
        miss_count=_scatter_set(pl.miss_count, tgt, 0),
    )
    return pl, next_id + ok.to(torch.int32).sum().to(torch.int32)


def _match_lines(line_map: maps.LineMap, det: lines_mod.DetectedLines, w2c, cam,
                 cfg: SlamConfig):
    """Match map lines to detected 2D segments at the predicted pose.

    Gates: 2D direction agreement, the detection midpoint's perpendicular
    distance to the projected map line, and a positive extent overlap along it.
    The best candidate is the one with the smallest perpendicular distance
    (first index on ties, and index 0 for a row that matches nothing); each
    detection matches at most one map line.  Returns (match index [Ml] into
    detections or -1, projected endpoints l0 [Ml, 2], l1 [Ml, 2])."""
    dev = w2c.device
    ml = line_map.fid.shape[0]
    nd = det.p0.shape[0]
    s0, ok0 = pinhole.world_to_screen(line_map.endpoints[:, :3], w2c, cam)
    s1, ok1 = pinhole.world_to_screen(line_map.endpoints[:, 3:], w2c, cam)
    l0, l1 = s0[:, :2], s1[:, :2]
    seg = l1 - l0
    seg_len = torch.sqrt(torch.clamp_min((seg * seg).sum(dim=-1), 1e-9))
    dir_m = seg / seg_len[:, None]
    norm_m = torch.stack([-dir_m[:, 1], dir_m[:, 0]], dim=-1)

    cosang = torch.abs(dir_m @ det.direction.T)
    mid = 0.5 * (det.p0 + det.p1)
    rel = mid[None, :, :] - l0[:, None, :]
    perp = torch.abs((rel * norm_m[:, None, :]).sum(dim=-1))
    t0 = ((det.p0[None] - l0[:, None]) * dir_m[:, None]).sum(dim=-1)
    t1 = ((det.p1[None] - l0[:, None]) * dir_m[:, None]).sum(dim=-1)
    lo = torch.minimum(t0, t1)
    hi = torch.maximum(t0, t1)
    overlap = torch.minimum(hi, seg_len[:, None]) - torch.clamp_min(lo, 0.0)

    gate = ((cosang > math.cos(math.radians(cfg.matching.max_line_match_angle_d)))
            & (perp < cfg.matching.max_line_match_distance_px)
            & (overlap > 0.0)
            & (ok0 & ok1)[:, None]
            & maps.alive(line_map)[:, None] & det.valid[None, :])
    neg_inf = torch.full_like(perp, -float("inf"))
    score = torch.where(gate, -perp, neg_inf)
    best = torch.argmax(score, dim=1)
    best_ok = torch.gather(gate, 1, best[:, None])[:, 0]
    best_perp = -torch.gather(score, 1, best[:, None])[:, 0]
    # one detection -> one map line: ties go to the smaller perpendicular error
    rank = torch.where(best_ok, -best_perp, neg_inf[:, 0])
    claims = best[None, :] == torch.arange(nd, device=dev)[:, None]     # [nd, ml]
    winner = torch.argmax(torch.where(claims, rank[None, :], neg_inf.T), dim=1)
    ok = best_ok & (winner[best] == torch.arange(ml, device=dev))
    return torch.where(ok, best, -1).to(torch.int32), l0, l1


class _LineObservations(NamedTuple):
    """A frame's detected segments with their endpoint depths: the endpoints
    are sampled a few px toward the midpoint, off the depth discontinuity that
    usually coincides with an intensity edge."""
    det: lines_mod.DetectedLines
    screen0: torch.Tensor    # [D, 3] inset start (u, v, depth mm)
    screen1: torch.Tensor    # [D, 3] inset end
    depth_ok: torch.Tensor   # [D] both endpoint depths are valid


def _observe_lines(gray, depth, cfg: SlamConfig) -> _LineObservations:
    det = lines_mod.detect_lines(gray)
    inset0 = det.p0 + 3.0 * det.direction
    inset1 = det.p1 - 3.0 * det.direction
    lz0 = _sample_depth(depth, inset0)
    lz1 = _sample_depth(depth, inset1)
    depth_ok = (pinhole.is_depth_valid(lz0, cfg.engine.min_depth_mm, cfg.engine.max_depth_mm)
                & pinhole.is_depth_valid(lz1, cfg.engine.min_depth_mm,
                                         cfg.engine.max_depth_mm))
    return _LineObservations(
        det=det, screen0=torch.cat([inset0, lz0[:, None]], dim=-1),
        screen1=torch.cat([inset1, lz1[:, None]], dim=-1), depth_ok=depth_ok)


def _update_lines(li: maps.LineMap, obs: _LineObservations, l_match_idx, l_final, c2w,
                  pose_cov3, cam, cfg: SlamConfig, insert_all, allow_insert, next_id):
    """The line map's frame: a 3x3 Kalman update of each matched line's two
    endpoints with the detection's 3D endpoints at the optimized pose ``c2w``,
    the staged/local lifecycle of map points applied to lines, and insertion of
    the unmatched detections whose endpoints both have depth.

    Returns (map, next id, evicted [Ml] bool, the endpoints before eviction)."""
    ml_cap = li.fid.shape[0]
    safe_l = l_match_idx.clamp(0, DET_LINES_CAP - 1).to(torch.int64)
    det_e0_w = pinhole.screen_to_world(obs.screen0, c2w, cam)
    det_e1_w = pinhole.screen_to_world(obs.screen1, c2w, cam)
    det_e0_cov = cov_mod.screen_point_to_world_covariance(obs.screen0, c2w, cam, pose_cov3)
    det_e1_cov = cov_mod.screen_point_to_world_covariance(obs.screen1, c2w, cam, pose_cov3)

    obs_e0, obs_e1 = det_e0_w[safe_l], det_e1_w[safe_l]
    oc0, oc1 = det_e0_cov[safe_l], det_e1_cov[safe_l]
    e0m, e1m = li.endpoints[:, :3], li.endpoints[:, 3:]

    def dist(a, b):
        return torch.linalg.vector_norm(a - b, dim=-1)

    # a segment's endpoints are unordered: take the assignment that moves less
    swap = ((dist(e0m, obs_e1) + dist(e1m, obs_e0))
            < (dist(e0m, obs_e0) + dist(e1m, obs_e1)))[:, None]
    o0 = torch.where(swap, obs_e1, obs_e0)
    o1 = torch.where(swap, obs_e0, obs_e1)
    c0 = torch.where(swap[..., None], oc1, oc0)
    c1 = torch.where(swap[..., None], oc0, oc1)
    upd_e0, upd_c0, _, _ = kalman.track_points(e0m, li.cov[:, 0], o0, c0)
    upd_e1, upd_c1, _, _ = kalman.track_points(e1m, li.cov[:, 1], o1, c1)
    l_upd = (l_final & maps.alive(li) & obs.depth_ok[safe_l])[:, None]
    new_lines = li._replace(
        endpoints=torch.where(l_upd, torch.cat([upd_e0, upd_e1], dim=-1), li.endpoints),
        cov=torch.where(l_upd[..., None, None], torch.stack([upd_c0, upd_c1], dim=1),
                        li.cov))
    # lifecycle: the staged/local rules of map points
    l_loc, l_mc, l_miss, l_keep = maps.lifecycle_update(
        new_lines.is_local, new_lines.match_count, new_lines.miss_count, l_final,
        cfg.mapping.point_staged_age_confidence, cfg.mapping.point_unmatched_count_to_loose)
    evicted = maps.alive(li) & new_lines.is_local & ~l_keep
    evict_eps = new_lines.endpoints
    new_lines = maps.remove_features(
        new_lines._replace(is_local=l_loc, match_count=l_mc, miss_count=l_miss),
        l_keep | ~maps.alive(li))

    # insertion: unmatched valid detections with both endpoint depths
    det_taken = _scatter_set(
        torch.zeros((DET_LINES_CAP,), dtype=torch.bool, device=c2w.device),
        torch.where(l_match_idx >= 0, l_match_idx.to(torch.int64), DET_LINES_CAP), True)
    want = obs.det.valid & obs.depth_ok & (~det_taken | insert_all) & allow_insert
    slots = maps.allocate_slots(~maps.alive(new_lines), want)
    ok = slots >= 0
    tgt = torch.where(ok, slots, ml_cap)
    ids = next_id + torch.cumsum(ok.to(torch.int32), dim=0).to(torch.int32) - 1
    new_lines = new_lines._replace(
        endpoints=_scatter_set(new_lines.endpoints, tgt,
                               torch.cat([det_e0_w, det_e1_w], dim=-1)),
        cov=_scatter_set(new_lines.cov, tgt, torch.stack([det_e0_cov, det_e1_cov], dim=1)),
        fid=_scatter_set(new_lines.fid, tgt, ids),
        is_local=_scatter_set(new_lines.is_local, tgt, False),
        match_count=_scatter_set(new_lines.match_count, tgt, 1),
        miss_count=_scatter_set(new_lines.miss_count, tgt, 0))
    return (new_lines, next_id + ok.to(torch.int32).sum().to(torch.int32), evicted,
            evict_eps)


def step(state: SlamState, gray, depth, cam: CameraIntrinsics, cfg: SlamConfig,
         with_planes: bool = True, with_lines: bool = False,
         draws: StepDraws | None = None):
    """Process one RGB-D frame.  ``gray`` and ``depth`` are [H, W] float32 on the
    state's device.  Returns (new_state, StepOutput)."""
    dev = gray.device
    dt = gray.dtype
    det_cfg = cfg.detection
    m3 = cfg.mapping.max_points_3d
    m2 = cfg.mapping.max_points_2d
    mp = cfg.mapping.max_planes
    ml = cfg.mapping.max_lines
    if draws is None:
        draws = draw_step_draws(cfg, state.generator, dev, dt)
    drop, pose_draws = draws.drop, draws.pose   # 1 in 2 * refresh frequency drops

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    def i32(x):
        return x.to(torch.int32)

    # the sections end at ``profiling.stamp``s: nodes of the step's CUDA graph
    # when it is recorded with a recorder active, nothing elsewhere
    profiling.stamp("start")
    # --- predicted pose ---------------------------------------------------
    if cfg.engine.use_motion_model_prediction:
        pred_quat, pred_pos = motion_model.predict_pose(state.motion, state.quat,
                                                        state.position)
    else:
        pred_quat, pred_pos = state.quat, state.position
    w2c = se3.world_to_camera(pred_quat, pred_pos)
    c2w = se3.camera_to_world(pred_quat, pred_pos)

    # --- feature extraction -----------------------------------------------
    levels = det_cfg.optical_flow_pyramid_depth
    win_w = cam.width // det_cfg.optical_flow_window_width
    win_h = cam.height // det_cfg.optical_flow_window_height
    pyr_cur = image.build_pyramid(gray, levels)

    of_uv_t, of_ok_t = optical_flow.track_forward_backward(
        list(state.prev_pyramid), pyr_cur, state.tracked_uv, state.tracked_ok,
        max_roundtrip_px=det_cfg.optical_flow_roundtrip_px,
        levels=levels, win_h=win_h, win_w=win_w,
        iterations=det_cfg.optical_flow_iterations,
        bwd_levels=(None if det_cfg.optical_flow_backward_depth >= levels
                    else det_cfg.optical_flow_backward_depth),
        coarse_win=det_cfg.optical_flow_coarse_window_px,
        coarse_from_level=det_cfg.optical_flow_coarse_from_level,
        eps=det_cfg.optical_flow_eps_px)
    of_ok_t = of_ok_t & state.tracked_ok & (state.frame_idx > 0)
    t_idx = torch.where(of_ok_t & (state.tracked_map_idx >= 0),
                        state.tracked_map_idx.to(torch.int64), m3)
    of_uv = _scatter_set(full((m3, 2), 0.0, dt), t_idx, of_uv_t)
    of_ok = _scatter_set(full((m3,), False, torch.bool), t_idx, True)
    profiling.stamp("flow")

    # detection runs on refresh frames, when optical flow tracked too few
    # points, or when lost; the flag stays on the device (lax.cond in JAX):
    # both branches run and the skip branch's zeros are selected by it
    n_tracked = torch.sum(of_ok_t)
    do_detect = ((state.frame_idx % det_cfg.keypoint_refresh_frequency == 0)
                 | (n_tracked < det_cfg.max_point_per_frame) | state.is_lost)
    n_det = det_cfg.max_point_per_frame
    det_mask = fast.tracked_points_mask((cam.height, cam.width), of_uv_t, of_ok_t,
                                        det_cfg.tracked_mask_radius_px)
    deficit = torch.clamp_min(det_cfg.max_point_per_frame - n_tracked, 10).to(dt)
    thr = det_cfg.fast_curve_scale * torch.pow(
        det_cfg.fast_curve_decay, det_cfg.fast_deficit_mult_high * deficit)
    thr_low = det_cfg.fast_curve_scale * torch.pow(
        det_cfg.fast_curve_decay, det_cfg.fast_deficit_mult_low * deficit)
    det_xy, _, det_valid = fast.detect_fast_grid(
        gray, detection_mask=det_mask, threshold=thr, low_threshold=thr_low,
        max_points=n_det,
        cell_rows=det_cfg.keypoint_cell_detection_height_count,
        cell_cols=det_cfg.keypoint_cell_detection_width_count)
    det_desc, det_valid = brief.compute_brief(gray, det_xy, det_valid)
    det_xy = torch.where(do_detect, det_xy, 0.0)
    det_valid = det_valid & do_detect
    det_desc = torch.where(do_detect, det_desc, 0)
    det_z = _sample_depth(depth, det_xy)
    det_depth_ok = pinhole.is_depth_valid(det_z, cfg.engine.min_depth_mm,
                                          cfg.engine.max_depth_mm) & det_valid
    profiling.stamp("detect")

    # --- data association ---------------------------------------------------
    pts = state.points
    pts_alive = maps.alive(pts)
    proj3, proj3_ok = pinhole.world_to_screen(pts.pos, w2c, cam)
    need_desc_match = pts_alive & ~of_ok & proj3_ok
    p2 = state.points2d
    p2_alive = maps.alive(p2)
    proj2, proj2_ok = pinhole.world_to_screen(idp.to_world(p2.state), w2c, cam)

    # descriptor matching exists only on detection frames (lax.cond in JAX):
    # the no-match branch's constants are selected by the flag
    det_taken = torch.zeros_like(det_valid)
    ham3, dsq3 = matching.match_precompute(pts.desc, proj3[:, :2], det_desc, det_xy)

    def match_pass(mask, taken, radius):
        idx, dist = matching.match_from_distances(
            ham3, dsq3, mask, det_valid, taken, search_radius=radius,
            lowe_ratio=cfg.matching.max_match_distance)
        idx = matching.resolve_match_conflicts(idx, dist, n_det)
        return idx, _scatter_set(taken, torch.where(idx >= 0, idx, n_det), True)

    radius = cfg.matching.match_search_radius_px
    idx_loc, det_taken = match_pass(need_desc_match & pts.is_local, det_taken, radius)
    idx_stg, det_taken = match_pass(need_desc_match & ~pts.is_local, det_taken, radius)
    p_match_idx = torch.where(idx_loc >= 0, idx_loc, idx_stg)

    # advanced search: 2x radius retry when below minimumPointForOptimization
    n_matched_now = torch.sum(of_ok) + torch.sum(p_match_idx >= 0)
    idx_adv, det_taken_adv = match_pass(need_desc_match & (p_match_idx < 0),
                                        det_taken, radius * 2.0)
    use_adv = n_matched_now < cfg.ransac.min_point_count
    p_match_idx = torch.where(use_adv & (p_match_idx < 0), idx_adv, p_match_idx)
    det_taken = torch.where(use_adv, det_taken_adv, det_taken)

    q_match_idx, q_dist = matching.match_descriptors(
        p2.desc, proj2[:, :2], p2_alive & proj2_ok, det_desc, det_xy, det_valid,
        det_taken, search_radius=cfg.matching.match_search_radius_px,
        lowe_ratio=cfg.matching.max_match_distance)
    q_match_idx = matching.resolve_match_conflicts(q_match_idx, q_dist, n_det)
    det_taken = _scatter_set(det_taken, torch.where(q_match_idx >= 0, q_match_idx,
                                                    n_det), True)
    p_match_idx = torch.where(do_detect, p_match_idx, -1)
    q_match_idx = torch.where(do_detect, q_match_idx, -1)
    det_taken = det_taken & do_detect

    def det_rows(match_idx):
        return match_idx.clamp(0, n_det - 1).to(torch.int64)

    p_obs_uv = torch.where(of_ok[:, None], of_uv, det_xy[det_rows(p_match_idx)])
    p_matched = of_ok | (p_match_idx >= 0)
    p_obs_z = _sample_depth(depth, p_obs_uv)
    p_obs_depth_ok = pinhole.is_depth_valid(p_obs_z, cfg.engine.min_depth_mm,
                                            cfg.engine.max_depth_mm)
    q_matched = q_match_idx >= 0
    q_obs_uv = det_xy[det_rows(q_match_idx)]
    q_obs_z = _sample_depth(depth, q_obs_uv)
    q_obs_depth_ok = pinhole.is_depth_valid(q_obs_z, cfg.engine.min_depth_mm,
                                            cfg.engine.max_depth_mm)

    # lines: detection, endpoint depths and matching at the predicted pose, in
    # sections of their own (``profiling.stages``): the tile pass through the
    # seeds' growth ends at ``line_tiles`` (in ``detect_lines``), the rest at
    # ``lines``; with lines off ``associate`` ends here
    if with_lines:
        profiling.stamp("associate")
        line_obs = _observe_lines(gray, depth, cfg)
        n_lines = i32(line_obs.det.valid.sum())
        l_match_idx, _, _ = _match_lines(state.lines, line_obs.det, w2c, cam, cfg)
    else:
        n_lines = full((), 0, torch.int32)
        l_match_idx = full((ml,), -1, torch.int32)
    l_matched = l_match_idx >= 0
    profiling.stamp("lines" if with_lines else "associate")

    # planes + cylinders (cylinders surface only in the step output)
    n_grid_cells = (cam.height // det_cfg.depth_patch_size_px) \
        * (cam.width // det_cfg.depth_patch_size_px)
    if with_planes:
        det_planes, det_cyls = primitives.find_primitives(depth, cam, det_cfg)
        k_match_idx, _ = _match_planes(state.planes, det_planes, c2w, cfg)
        n_cylinders = i32(det_cyls.valid.sum())
        cylinder_cells = (det_cyls.cell_mask & det_cyls.valid[:, None]).any(dim=0)
    else:
        det_planes = None
        k_match_idx = full((mp,), -1, torch.int32)
        n_cylinders = full((), 0, torch.int32)
        cylinder_cells = full((n_grid_cells,), False, torch.bool)
    k_matched = k_match_idx >= 0
    safe_k = k_match_idx.clamp(0, MAX_PLANES - 1).to(torch.int64)
    profiling.stamp("plane_extract")

    # --- pose optimization --------------------------------------------------
    def std_of(cov):
        return torch.sqrt(torch.abs(torch.diagonal(cov, dim1=-2, dim2=-1)))

    if with_lines:
        safe_l = l_match_idx.clamp(0, DET_LINES_CAP - 1).to(torch.int64)
        line_obs_p0 = line_obs.det.p0[safe_l]
        line_obs_p1 = line_obs.det.p1[safe_l]
    else:
        line_obs_p0 = line_obs_p1 = full((ml, 2), 0.0, dt)
    feats = MatchedFeatures(
        point_obs_uv=p_obs_uv, point_world=pts.pos, point_world_std=std_of(pts.cov),
        point_mask=p_matched & pts_alive,
        point2d_obs_uv=q_obs_uv, point2d_state=p2.state,
        point2d_state_std=std_of(p2.cov), point2d_mask=q_matched & p2_alive,
        plane_cam=det_planes.params[safe_k] if with_planes else full((mp, 4), 0.0, dt),
        plane_world=state.planes.params, plane_world_std=std_of(state.planes.cov),
        plane_mask=k_matched & maps.alive(state.planes),
        line_obs_p0=line_obs_p0, line_obs_p1=line_obs_p1,
        line_world=state.lines.endpoints,
        line_world_std=std_of(state.lines.cov).reshape(ml, 6),
        line_mask=l_matched & maps.alive(state.lines),
    )
    opt = compute_optimized_pose(pred_quat, pred_pos, feats, cam,
                                 ransac_cfg=cfg.ransac, engine_cfg=cfg.engine,
                                 generator=state.generator, draws=pose_draws)

    first_frame = state.frame_idx == 0
    pose_ok = (cov_mod.is_covariance_valid_fast(opt.covariance)
               & torch.isfinite(opt.quat).all() & torch.isfinite(opt.position).all())
    success = opt.success & pose_ok & ~first_frame

    new_quat = torch.where(success, opt.quat, pred_quat)
    new_pos = torch.where(success, opt.position, pred_pos)
    new_pose_cov = torch.where(success, opt.covariance, state.pose_cov)
    new_c2w = se3.camera_to_world(new_quat, new_pos)
    new_w2c = se3.world_to_camera(new_quat, new_pos)
    pose_cov3 = new_pose_cov[:3, :3]
    profiling.stamp("pose_opt")

    # --- map update ---------------------------------------------------------
    # final per-slot "matched" = matched AND RANSAC inlier, on successful frames
    p_final = success & p_matched & opt.point_inliers
    q_final = success & q_matched & opt.point2d_inliers
    k_final = success & k_matched & opt.plane_inliers
    l_final = success & l_matched & opt.line_inliers

    # 3D point Kalman updates on a compacted 256-slot block; depth-less matches
    # fuse an inverse-depth observation's cartesian projection (nested 64 block)
    midx, mkeep = _compact_mask(p_final & pts_alive, 256)
    uv_c = p_obs_uv[midx]
    obs_screen = torch.stack([uv_c[:, 0], uv_c[:, 1], p_obs_z[midx]], dim=-1)
    obs_world = pinhole.screen_to_world(obs_screen, new_c2w, cam)
    obs_cov = cov_mod.screen_point_to_world_covariance(obs_screen, new_c2w, cam, pose_cov3)
    didx, dkeep = _compact_mask(mkeep & ~p_obs_depth_ok[midx], 64)
    id_state_c = idp.from_screen_observation(
        uv_c[didx], new_c2w, cam, baseline_rho=det_cfg.inverse_depth_baseline / 2.0)
    id_cov_c = idt.initial_covariance(pose_cov3.expand(64, 3, 3), det_cfg)
    obs_world = _scatter_set(obs_world, didx, torch.where(
        dkeep[:, None], idp.to_world(id_state_c), obs_world[didx]))
    obs_cov = _scatter_set(obs_cov, didx, torch.where(
        dkeep[:, None, None], idt.cartesian_covariance(id_state_c, id_cov_c),
        obs_cov[didx]))
    upd_pos, upd_cov, _, moving = kalman.track_points(pts.pos[midx], pts.cov[midx],
                                                      obs_world, obs_cov)
    # rows whose fused covariance is invalid keep their previous state
    kf_ok = (cov_mod.is_covariance_valid_fast(upd_cov)
             & torch.isfinite(upd_pos).all(dim=-1))
    mkeep = mkeep & kf_ok
    match_c = p_match_idx[midx]
    desc_upd = mkeep & ~of_ok[midx] & (match_c >= 0)
    desc_c = det_desc[det_rows(match_c)]
    new_points = pts._replace(
        pos=_scatter_set(pts.pos, midx, torch.where(mkeep[:, None], upd_pos, pts.pos[midx])),
        cov=_scatter_set(pts.cov, midx, torch.where(mkeep[:, None, None], upd_cov,
                                                    pts.cov[midx])),
        desc=_scatter_set(pts.desc, midx, torch.where(desc_upd[:, None], desc_c,
                                                      pts.desc[midx])),
        is_moving=_scatter_set(pts.is_moving, midx, torch.where(mkeep, moving,
                                                                pts.is_moving[midx])),
    )

    # 2D point fusion on a compacted 64-slot block
    q_obs_screen = torch.stack([q_obs_uv[:, 0], q_obs_uv[:, 1], q_obs_z], dim=-1)
    qidx, qkeep = _compact_mask(q_final & p2_alive, 64)
    st3, cov3_, _ = idt.fuse_screen_observation_3d(
        p2.state[qidx], p2.cov[qidx], q_obs_screen[qidx], new_c2w, pose_cov3, cam)
    st2, cov2_, _ = idt.fuse_screen_observation_2d(
        p2.state[qidx], p2.cov[qidx], q_obs_uv[qidx], new_c2w, pose_cov3, cam, det_cfg)
    okd = q_obs_depth_ok[qidx]
    fused_state = torch.where(okd[:, None], st3, st2)
    fused_cov = torch.where(okd[:, None, None], cov3_, cov2_)
    desc_c = det_desc[det_rows(q_match_idx[qidx])]
    new_points2d = p2._replace(
        state=_scatter_set(p2.state, qidx, torch.where(qkeep[:, None], fused_state,
                                                       p2.state[qidx])),
        cov=_scatter_set(p2.cov, qidx, torch.where(qkeep[:, None, None], fused_cov,
                                                   p2.cov[qidx])),
        desc=_scatter_set(p2.desc, qidx, torch.where(qkeep[:, None], desc_c,
                                                     p2.desc[qidx])),
    )
    # plane updates: world-frame 4x4 KF and the polygon merge
    if with_planes:
        pl, det_world_norm, det_world_cov, n_merge_dropped = _update_planes(
            state.planes, det_planes, safe_k, k_final, new_c2w, pose_cov3, cfg)
    else:
        pl = state.planes
        n_merge_dropped = full((), 0, torch.int32)
    profiling.stamp("map_update")

    # --- lifecycle ------------------------------------------------------------
    promote_pts = int(cfg.mapping.point_min_confidence_for_map
                      * cfg.mapping.point_staged_age_confidence) + 1
    p_loc, p_mc, p_miss, p_keep = maps.lifecycle_update(
        new_points.is_local, new_points.match_count, new_points.miss_count,
        p_final, promote_pts, cfg.mapping.point_unmatched_count_to_loose)
    # death-export record, snapshot before insertion reuses slots
    p_evicted = pts_alive & new_points.is_local & ~p_keep & ~new_points.is_moving
    p_evict_pos = new_points.pos
    new_points = maps.remove_features(
        new_points._replace(is_local=p_loc, match_count=p_mc, miss_count=p_miss),
        p_keep | ~pts_alive)

    q_loc, q_mc, q_miss, q_keep = maps.lifecycle_update(
        new_points2d.is_local, new_points2d.match_count, new_points2d.miss_count,
        q_final, promote_pts, cfg.mapping.point_unmatched_count_to_loose)
    q_evicted = p2_alive & new_points2d.is_local & ~q_keep
    q_evict_pos = idp.to_world(new_points2d.state)
    new_points2d = maps.remove_features(
        new_points2d._replace(is_local=q_loc, match_count=q_mc, miss_count=q_miss),
        q_keep | ~p2_alive)

    # staged planes drop after plane_staged_drop_misses misses; the death-export
    # record is the updated plane before insertion reuses its slot
    k_loc, k_mc, k_miss, k_keep = maps.lifecycle_update(
        pl.is_local, pl.match_count, pl.miss_count, k_final,
        cfg.mapping.plane_staged_promote_hits, cfg.mapping.plane_unmatched_count_to_loose)
    k_staged_drop = ~pl.is_local & (k_miss >= cfg.mapping.plane_staged_drop_misses)
    k_evicted = maps.alive(state.planes) & pl.is_local & ~k_keep
    k_evict = pl
    new_planes = maps.remove_features(
        pl._replace(is_local=k_loc, match_count=k_mc, miss_count=k_miss),
        (k_keep & ~k_staged_drop) | ~maps.alive(state.planes))

    # --- 2D -> 3D upgrade -----------------------------------------------------
    lin_score = idt.linearity_score(new_points2d.state, new_points2d.cov, new_c2w)
    upgrade = maps.alive(new_points2d) & (lin_score < 0.1) & q_final
    uidx, ukeep = _compact_mask(upgrade, 32)
    up_state_c = new_points2d.state[uidx]
    up_world = idp.to_world(up_state_c)
    up_cov = idt.cartesian_covariance(up_state_c, new_points2d.cov[uidx])

    # --- insertion of new features -------------------------------------------
    # tracking fine: unmatched detections go to the staged maps; lost: all
    # detections re-seed the map
    newly_lost = state.failed_count + i32(~success) > cfg.engine.max_failed_tracking
    insert_all = ((~success) & (newly_lost | state.is_lost)) | first_frame
    allow_insert = success | insert_all
    det_free = det_valid & (~det_taken | insert_all) & allow_insert

    want3 = det_free & det_depth_ok
    det_screen = torch.stack([det_xy[:, 0], det_xy[:, 1], det_z], dim=-1)
    new_world = pinhole.screen_to_world(det_screen, new_c2w, cam)
    new_world_cov = cov_mod.screen_point_to_world_covariance(det_screen, new_c2w, cam,
                                                             pose_cov3)
    cand_pos = torch.cat([new_world, up_world], dim=0)
    cand_cov = torch.cat([new_world_cov, up_cov], dim=0)
    cand_desc = torch.cat([det_desc, new_points2d.desc[uidx]], dim=0)
    cand_want = torch.cat([want3, ukeep], dim=0)
    cand_local = torch.cat([torch.zeros_like(want3), ukeep], dim=0)
    slots3 = maps.allocate_slots(~maps.alive(new_points), cand_want)
    ok3 = slots3 >= 0
    tgt3 = torch.where(ok3, slots3, m3)
    ids3 = state.next_id + i32(torch.cumsum(i32(ok3), dim=0)) - 1
    new_points = new_points._replace(
        pos=_scatter_set(new_points.pos, tgt3, cand_pos),
        cov=_scatter_set(new_points.cov, tgt3, cand_cov),
        desc=_scatter_set(new_points.desc, tgt3, cand_desc),
        fid=_scatter_set(new_points.fid, tgt3, ids3),
        is_local=_scatter_set(new_points.is_local, tgt3, cand_local),
        match_count=_scatter_set(new_points.match_count, tgt3, 1),
        miss_count=_scatter_set(new_points.miss_count, tgt3, 0),
        is_moving=_scatter_set(new_points.is_moving, tgt3, False),
    )
    next_id = state.next_id + i32(ok3.sum())

    # upgraded 2D points leave the 2D map (only those that got a 3D slot)
    upgraded_ok = _scatter_set(full((m2,), False, torch.bool), uidx, ok3[n_det:] & ukeep)
    new_points2d = maps.remove_features(new_points2d, ~upgraded_ok)

    want2 = det_free & ~det_depth_ok
    slots2 = maps.allocate_slots(~maps.alive(new_points2d), want2)
    ok2 = slots2 >= 0
    tgt2 = torch.where(ok2, slots2, m2)
    new_2d_state = idp.from_screen_observation(
        det_xy, new_c2w, cam, baseline_rho=det_cfg.inverse_depth_baseline / 2.0)
    new_2d_cov = idt.initial_covariance(pose_cov3.expand(n_det, 3, 3), det_cfg)
    ids2 = next_id + i32(torch.cumsum(i32(ok2), dim=0)) - 1
    new_points2d = new_points2d._replace(
        state=_scatter_set(new_points2d.state, tgt2, new_2d_state),
        cov=_scatter_set(new_points2d.cov, tgt2, new_2d_cov),
        desc=_scatter_set(new_points2d.desc, tgt2, det_desc),
        fid=_scatter_set(new_points2d.fid, tgt2, ids2),
        is_local=_scatter_set(new_points2d.is_local, tgt2, False),
        match_count=_scatter_set(new_points2d.match_count, tgt2, 1),
        miss_count=_scatter_set(new_points2d.miss_count, tgt2, 0),
    )
    next_id = next_id + i32(ok2.sum())

    # new staged planes from unmatched detections
    if with_planes:
        new_planes, next_id = _insert_planes(new_planes, det_planes, det_world_norm,
                                             det_world_cov, safe_k, k_final, new_c2w,
                                             next_id)

    # line map: per-endpoint Kalman update, lifecycle and insertion
    if with_lines:
        new_lines, next_id, l_evicted, l_evict_eps = _update_lines(
            state.lines, line_obs, l_match_idx, l_final, new_c2w, pose_cov3, cam, cfg,
            insert_all, allow_insert, next_id)
    else:
        new_lines = state.lines
        l_evicted = full((ml,), False, torch.bool)
        l_evict_eps = state.lines.endpoints
    profiling.stamp("insert")

    # --- next-frame tracking set ---------------------------------------------
    proj_next, proj_next_ok = pinhole.world_to_screen(new_points.pos, new_w2c, cam)
    in_screen = pinhole.is_in_screen_boundaries(proj_next, cam)
    track_cand = maps.alive(new_points) & proj_next_ok & in_screen & (drop != 0)
    t_cap = cfg.mapping.max_tracked_points
    cand_rank = torch.cumsum(track_cand.to(torch.int64), dim=0) - 1
    sel = track_cand & (cand_rank < t_cap)
    dest = torch.where(sel, cand_rank, t_cap)
    tracked_uv_next = _scatter_set(full((t_cap, 2), 0.0, dt), dest, proj_next[:, :2])
    tracked_idx_next = _scatter_set(full((t_cap,), -1, torch.int32), dest,
                                    torch.arange(m3, dtype=torch.int32, device=dev))
    tracked_ok_next = torch.arange(t_cap, device=dev) < sel.sum()

    # --- tracking state -------------------------------------------------------
    zero = torch.zeros_like(state.failed_count)
    failed_count = torch.where(success, zero,
                               torch.where(first_frame, zero, state.failed_count + 1))
    is_lost = failed_count > cfg.engine.max_failed_tracking
    motion_state, _, _, _ = motion_model.predict_next_pose(state.motion, new_quat, new_pos)
    motion_state = motion_model.MotionModelState(*[
        torch.where(success, a, b)
        for a, b in zip(motion_state, motion_model.reset(dt, dev))])

    new_state = SlamState(
        quat=new_quat, position=new_pos, pose_cov=new_pose_cov, motion=motion_state,
        points=new_points, points2d=new_points2d, planes=new_planes, lines=new_lines,
        prev_pyramid=tuple(pyr_cur), tracked_uv=tracked_uv_next,
        tracked_ok=tracked_ok_next, tracked_map_idx=tracked_idx_next,
        frame_idx=state.frame_idx + 1, failed_count=failed_count, is_lost=is_lost,
        next_id=next_id, generator=state.generator,
    )
    output = StepOutput(
        quat=new_quat, position=new_pos, pose_cov=new_pose_cov,
        success=success | first_frame, is_lost=is_lost,
        n_point_matches=i32((p_matched & pts_alive).sum()),
        n_point_inliers=i32(p_final.sum()),
        n_points_alive=i32(maps.alive(new_points).sum()),
        n_planes_alive=i32(maps.alive(new_planes).sum()),
        n_detected=i32(det_valid.sum()),
        n_lines=n_lines,
        n_line_matches=i32(l_final.sum()),
        n_lines_alive=i32(maps.alive(new_lines).sum()),
        n_cylinders=n_cylinders,
        n_plane_merge_dropped=n_merge_dropped,
        cylinder_cells=cylinder_cells,
        point_obs_uv=p_obs_uv,
        point_obs_z=torch.where(p_obs_depth_ok, p_obs_z, torch.zeros_like(p_obs_z)),
        point_matched=p_final & pts_alive,
        point_fid=pts.fid,
        n_evicted=i32(p_evicted.sum() + q_evicted.sum() + k_evicted.sum()
                      + l_evicted.sum()),
        point_evicted=p_evicted, point_evict_pos=p_evict_pos,
        point2d_evicted=q_evicted, point2d_evict_pos=q_evict_pos,
        plane_evicted=k_evicted, plane_evict_params=k_evict.params,
        plane_evict_verts=k_evict.poly_verts, plane_evict_count=k_evict.poly_count,
        plane_evict_center=k_evict.basis_center, plane_evict_u=k_evict.basis_u,
        plane_evict_v=k_evict.basis_v,
        line_evicted=l_evicted, line_evict_eps=l_evict_eps,
    )
    profiling.stamp("next_track")
    return new_state, output
