"""Descriptor matching with spatial gating and Lowe ratio test (port of
``rgbd_slam_tpu/ops/matching.py``): a dense screen-distance gate on the full
[M, N] Hamming matrix, kNN(2) by a stable sort (ties to the lower index, as
``lax.top_k``), and batched conflict resolution.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .brief import hamming_distance_matrix

#: max Hamming distance considered a usable match at all
MAX_HAMMING = 120

_INT32_MAX = 2 ** 31 - 1


def match_precompute(map_desc, map_proj_uv, det_desc, det_uv):
    """Hamming distance matrix and squared screen distances [M, N]."""
    d = hamming_distance_matrix(map_desc, det_desc)
    dx = map_proj_uv[:, None, 0] - det_uv[None, :, 0]
    dy = map_proj_uv[:, None, 1] - det_uv[None, :, 1]
    return d, dx * dx + dy * dy


def match_from_distances(d, dist_sq, map_valid, det_valid, det_taken,
                         search_radius: float = 30.0, lowe_ratio: float = 0.7):
    """Window-gated kNN(2) + Lowe ratio selection from precomputed distances."""
    in_window = dist_sq <= search_radius * search_radius
    allowed = in_window & det_valid[None, :] & ~det_taken[None, :] & map_valid[:, None]
    big = 10_000
    gated = torch.where(allowed, d, torch.full_like(d, big))
    if gated.shape[1] < 2:
        gated = F.pad(gated, (0, 2 - gated.shape[1]), value=big)
    vals, idx = torch.sort(gated, dim=1, stable=True)
    best = vals[:, 0]
    second = vals[:, 1]
    best_idx = idx[:, 0]
    ratio_ok = best.to(torch.float32) < lowe_ratio * second.to(torch.float32)
    usable = (best < MAX_HAMMING) & ratio_ok & map_valid
    return torch.where(usable, best_idx, -1).to(torch.int32), best


def match_descriptors(map_desc, map_proj_uv, map_valid, det_desc, det_uv, det_valid,
                      det_taken, search_radius: float = 30.0, lowe_ratio: float = 0.7):
    """Window-gated kNN(2) descriptor matching with ratio test.  Returns
    (match_index [M] int32 into detections or -1, match_distance [M])."""
    d, dist_sq = match_precompute(map_desc, map_proj_uv, det_desc, det_uv)
    return match_from_distances(d, dist_sq, map_valid, det_valid, det_taken,
                                search_radius=search_radius, lowe_ratio=lowe_ratio)


def resolve_match_conflicts(match_index, match_distance, n_detections: int):
    """Each detection is matched by at most one map feature: the lowest distance
    (then the lowest map index) keeps it."""
    m = match_index.shape[0]
    valid = match_index >= 0
    safe_idx = torch.where(valid, match_index, 0).to(torch.int64)
    key = match_distance.to(torch.int32) * m + torch.arange(
        m, dtype=torch.int32, device=match_index.device)
    key = torch.where(valid, key, _INT32_MAX)
    best_key = torch.full((n_detections,), _INT32_MAX, dtype=torch.int32,
                          device=match_index.device)
    best_key = best_key.scatter_reduce(0, safe_idx, key, reduce="amin")
    keep = valid & (best_key[safe_idx] == key)
    return torch.where(keep, match_index, -1).to(torch.int32)
