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

    def with_masks(self, point_mask, point2d_mask, plane_mask, line_mask=None):
        return self._replace(
            point_mask=point_mask & self.point_mask,
            point2d_mask=point2d_mask & self.point2d_mask,
            plane_mask=plane_mask & self.plane_mask,
            line_mask=(self.line_mask if line_mask is None
                       else line_mask & self.line_mask))
