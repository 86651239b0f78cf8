"""Matched-feature containers for pose optimization (port of
``rgbd_slam_tpu/pose/features.py``): one masked array block per feature type.

Each feature scores ``1/minimumCountForOptimization`` (points 1/5, 2D points 1/5,
planes 1/3, lines 1/5); a pose is solvable when the participating features score
1.0.  Blocks may carry extra leading batch axes (one feature set per RANSAC
hypothesis or Monte-Carlo member).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import RansacConfig as _RANSAC_DEFAULTS
from ..device import resolve_device

POINT_SCORE = 1.0 / _RANSAC_DEFAULTS().min_point_count
POINT2D_SCORE = 1.0 / _RANSAC_DEFAULTS().min_point2d_count
PLANE_SCORE = 1.0 / _RANSAC_DEFAULTS().min_plane_count
LINE_SCORE = 1.0 / _RANSAC_DEFAULTS().min_point_count

POINT_ALPHA = 1.0
POINT2D_ALPHA = 0.3
PLANE_ALPHA = 1.0
LINE_ALPHA = 1.0


class MatchedFeatures(NamedTuple):
    """Shapes: points obs/world [NP,2]/[NP,3]; 2D points obs/state [N2,2]/[N2,6];
    planes camera/world [NK,4]; lines obs [NL,2] x2, world [NL,6]."""

    point_obs_uv: torch.Tensor
    point_world: torch.Tensor
    point_world_std: torch.Tensor
    point_mask: torch.Tensor

    point2d_obs_uv: torch.Tensor
    point2d_state: torch.Tensor
    point2d_state_std: torch.Tensor
    point2d_mask: torch.Tensor

    plane_cam: torch.Tensor
    plane_world: torch.Tensor
    plane_world_std: torch.Tensor
    plane_mask: torch.Tensor

    line_obs_p0: torch.Tensor
    line_obs_p1: torch.Tensor
    line_world: torch.Tensor
    line_world_std: torch.Tensor
    line_mask: torch.Tensor

    @property
    def capacities(self):
        return (self.point_mask.shape[-1], self.point2d_mask.shape[-1],
                self.plane_mask.shape[-1], self.line_mask.shape[-1])

    def scores(self):
        """Per-feature scores over the unified index space [NP+N2+NK+NL]."""
        dt = self.point_world.dtype

        def s(mask, v):
            return torch.where(mask, v, 0.0).to(dt)

        return torch.cat([s(self.point_mask, POINT_SCORE),
                          s(self.point2d_mask, POINT2D_SCORE),
                          s(self.plane_mask, PLANE_SCORE),
                          s(self.line_mask, LINE_SCORE)], dim=-1)

    def valid_mask(self):
        return torch.cat([self.point_mask, self.point2d_mask, self.plane_mask,
                          self.line_mask], dim=-1)

    def total_score(self):
        return torch.sum(self.scores(), dim=-1)

    def split_unified(self, unified):
        """Split a unified-index tensor back into per-type blocks."""
        np_, n2, nk, _ = self.capacities
        return (unified[..., :np_], unified[..., np_:np_ + n2],
                unified[..., np_ + n2:np_ + n2 + nk], unified[..., np_ + n2 + nk:])

    def with_masks(self, point_mask, point2d_mask, plane_mask, line_mask=None):
        return self._replace(
            point_mask=point_mask & self.point_mask,
            point2d_mask=point2d_mask & self.point2d_mask,
            plane_mask=plane_mask & self.plane_mask,
            line_mask=(self.line_mask if line_mask is None
                       else line_mask & self.line_mask))


def make_matched_features(point_obs_uv=None, point_world=None, point_world_std=None,
                          point2d_obs_uv=None, point2d_state=None, point2d_state_std=None,
                          plane_cam=None, plane_world=None, plane_world_std=None,
                          line_obs_p0=None, line_obs_p1=None, line_world=None,
                          line_world_std=None, capacities=(64, 32, 8, 8),
                          dtype=torch.float32, device=None) -> MatchedFeatures:
    """Build a mask-padded MatchedFeatures from (possibly None or shorter)
    arrays or tensors; rows past a block's capacity are dropped."""
    device = resolve_device(device)
    if len(capacities) == 3:
        capacities = tuple(capacities) + (8,)
    np_, n2, nk, nl = capacities

    def pad(arr, cap, width):
        mask = torch.zeros((cap,), dtype=torch.bool, device=device)
        out = torch.zeros((cap, width), dtype=dtype, device=device)
        if arr is not None and arr.shape[0] > 0:
            n = min(arr.shape[0], cap)
            out[:n] = torch.as_tensor(arr[:n], dtype=dtype, device=device)
            mask[:n] = True
        return out, mask

    p_uv, p_mask = pad(point_obs_uv, np_, 2)
    p_w, _ = pad(point_world, np_, 3)
    p_std, _ = pad(point_world_std, np_, 3)
    q_uv, q_mask = pad(point2d_obs_uv, n2, 2)
    q_st, _ = pad(point2d_state, n2, 6)
    q_std, _ = pad(point2d_state_std, n2, 6)
    k_c, k_mask = pad(plane_cam, nk, 4)
    k_w, _ = pad(plane_world, nk, 4)
    k_std, _ = pad(plane_world_std, nk, 4)
    l_p0, l_mask = pad(line_obs_p0, nl, 2)
    l_p1, _ = pad(line_obs_p1, nl, 2)
    l_w, _ = pad(line_world, nl, 6)
    l_std, _ = pad(line_world_std, nl, 6)
    return MatchedFeatures(
        point_obs_uv=p_uv, point_world=p_w, point_world_std=p_std, point_mask=p_mask,
        point2d_obs_uv=q_uv, point2d_state=q_st, point2d_state_std=q_std,
        point2d_mask=q_mask,
        plane_cam=k_c, plane_world=k_w, plane_world_std=k_std, plane_mask=k_mask,
        line_obs_p0=l_p0, line_obs_p1=l_p1, line_world=l_w, line_world_std=l_std,
        line_mask=l_mask)
