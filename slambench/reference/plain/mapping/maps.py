"""Structure-of-arrays local feature maps (port of ``rgbd_slam_tpu/mapping/maps.py``).

Every feature type lives in one preallocated mask-padded block; staged-vs-local
is a bool column; insertion, eviction and promotion are masked scatters.
Descriptors are held as int32 bit patterns of the JAX package's uint32 words.
``PlaneMap`` and ``LineMap`` have the JAX package's shapes; the step fills them when
planes and lines are on.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device

#: polygon vertex capacity of a plane (``rgbd_slam_tpu/utils/polygon.py``)
MAX_VERTS = 16


class PointMap(NamedTuple):
    pos: torch.Tensor          # [M, 3] world mm
    cov: torch.Tensor          # [M, 3, 3]
    desc: torch.Tensor         # [M, 8] int32 BRIEF words
    fid: torch.Tensor          # [M] int32 unique id, -1 = empty slot
    is_local: torch.Tensor     # [M] bool (False = staged)
    match_count: torch.Tensor  # [M] int32 successive matched count
    miss_count: torch.Tensor   # [M] int32 consecutive unmatched count
    is_moving: torch.Tensor    # [M] bool


class Point2DMap(NamedTuple):
    state: torch.Tensor        # [M, 6] inverse-depth state
    cov: torch.Tensor          # [M, 6, 6]
    desc: torch.Tensor         # [M, 8] int32
    fid: torch.Tensor          # [M] int32
    is_local: torch.Tensor
    match_count: torch.Tensor
    miss_count: torch.Tensor


class LineMap(NamedTuple):
    endpoints: torch.Tensor    # [M, 6] world mm (e0 | e1)
    cov: torch.Tensor          # [M, 2, 3, 3]
    fid: torch.Tensor          # [M] int32
    is_local: torch.Tensor
    match_count: torch.Tensor
    miss_count: torch.Tensor


class PlaneMap(NamedTuple):
    params: torch.Tensor       # [M, 4] world hessian
    cov: torch.Tensor          # [M, 4, 4]
    poly_verts: torch.Tensor   # [M, V, 2]
    poly_count: torch.Tensor   # [M] int32
    basis_center: torch.Tensor # [M, 3]
    basis_u: torch.Tensor      # [M, 3]
    basis_v: torch.Tensor      # [M, 3]
    fid: torch.Tensor          # [M] int32
    is_local: torch.Tensor
    match_count: torch.Tensor
    miss_count: torch.Tensor


def _counters(capacity, device):
    return dict(fid=torch.full((capacity,), -1, dtype=torch.int32, device=device),
                is_local=torch.zeros((capacity,), dtype=torch.bool, device=device),
                match_count=torch.zeros((capacity,), dtype=torch.int32, device=device),
                miss_count=torch.zeros((capacity,), dtype=torch.int32, device=device))


def empty_point_map(capacity: int, dtype=torch.float32, device=None) -> PointMap:
    device = resolve_device(device)
    return PointMap(
        pos=torch.zeros((capacity, 3), dtype=dtype, device=device),
        cov=torch.zeros((capacity, 3, 3), dtype=dtype, device=device),
        desc=torch.zeros((capacity, 8), dtype=torch.int32, device=device),
        is_moving=torch.zeros((capacity,), dtype=torch.bool, device=device),
        **_counters(capacity, device))


def empty_point2d_map(capacity: int, dtype=torch.float32, device=None) -> Point2DMap:
    device = resolve_device(device)
    return Point2DMap(
        state=torch.zeros((capacity, 6), dtype=dtype, device=device),
        cov=torch.zeros((capacity, 6, 6), dtype=dtype, device=device),
        desc=torch.zeros((capacity, 8), dtype=torch.int32, device=device),
        **_counters(capacity, device))


def empty_line_map(capacity: int, dtype=torch.float32, device=None) -> LineMap:
    device = resolve_device(device)
    return LineMap(
        endpoints=torch.zeros((capacity, 6), dtype=dtype, device=device),
        cov=torch.zeros((capacity, 2, 3, 3), dtype=dtype, device=device),
        **_counters(capacity, device))


def empty_plane_map(capacity: int, max_verts: int = MAX_VERTS, dtype=torch.float32,
                    device=None) -> PlaneMap:
    device = resolve_device(device)

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return PlaneMap(
        params=z(capacity, 4), cov=z(capacity, 4, 4),
        poly_verts=z(capacity, max_verts, 2),
        poly_count=torch.zeros((capacity,), dtype=torch.int32, device=device),
        basis_center=z(capacity, 3), basis_u=z(capacity, 3), basis_v=z(capacity, 3),
        **_counters(capacity, device))


def alive(m) -> torch.Tensor:
    return m.fid >= 0


def allocate_slots(free_mask, want_mask):
    """Masked slot allocator: the k-th wanted item gets the k-th free slot.
    Returns the destination slot of each wanted item, or -1 when the map is
    full (items beyond capacity are dropped)."""
    n_free = free_mask.shape[0]
    free_rank = torch.cumsum(free_mask.to(torch.int64), dim=0) - 1
    # a sink entry at n_free takes the non-free slots
    slot_of_rank = torch.full((n_free + 1,), -1, dtype=torch.int64, device=free_mask.device)
    slot_of_rank[torch.where(free_mask, free_rank, n_free)] = torch.arange(
        n_free, device=free_mask.device)
    want_rank = torch.cumsum(want_mask.to(torch.int64), dim=0) - 1
    num_free = free_mask.to(torch.int64).sum()
    ok = want_mask & (want_rank < num_free)
    safe_rank = want_rank.clamp(0, n_free - 1)
    return torch.where(ok, slot_of_rank[safe_rank], -1)


def lifecycle_update(is_local, match_count, miss_count, matched,
                     promote_threshold: int, lose_threshold: int,
                     staged_drop_at_zero: bool = True):
    """Shared staged/local lifecycle step; a staged feature that is not matched
    and whose match count reaches 0 is dropped when ``staged_drop_at_zero``.
    Returns (new_is_local, new_match_count, new_miss_count, keep_mask)."""
    new_match = torch.where(matched, match_count + 1, torch.clamp_min(match_count - 1, 0))
    new_miss = torch.where(matched, torch.zeros_like(miss_count), miss_count + 1)
    promote = ~is_local & (new_match >= promote_threshold)
    new_is_local = is_local | promote
    lost_local = is_local & (new_miss > lose_threshold)
    lost_staged = ~is_local & ~matched & (new_match <= 0) & staged_drop_at_zero
    keep = ~(lost_local | lost_staged)
    return new_is_local, new_match, new_miss, keep


def remove_features(m, keep_mask):
    """Clear slots whose keep_mask is False (id -> -1)."""
    return m._replace(fid=torch.where(keep_mask, m.fid, -1))
