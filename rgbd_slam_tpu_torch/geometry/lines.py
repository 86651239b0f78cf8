"""Line / segment distance primitives (port of ``rgbd_slam_tpu/geometry/lines.py``).

Only the helpers the points-only residuals call are ported.
"""

from __future__ import annotations

import torch


def angle_distance(a, b):
    """Wrapped angular difference."""
    return torch.arctan2(torch.sin(a - b), torch.cos(a - b))


def line_signed_distance_to_point(start, direction, point):
    """Signed perpendicular offset of ``point`` from the infinite line through
    ``start`` with ``direction`` (2D or 3D)."""
    d = direction / torch.clamp_min(
        torch.linalg.vector_norm(direction, dim=-1, keepdim=True), 1e-12)
    rel = point - start
    along = torch.sum(rel * d, dim=-1, keepdim=True)
    return rel - along * d


def segment_signed_distance_to_point(p0, p1, point):
    """Signed offset of ``point`` from the infinite line through (p0, p1)."""
    return line_signed_distance_to_point(p0, p1 - p0, point)
