"""Line / segment distance primitives (port of ``rgbd_slam_tpu/geometry/lines.py``).

All functions broadcast over leading axes; the parallel-line special cases are
masked selections.
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


def line_line_closest_points(p1, d1, p2, d2, eps=1e-10):
    """Closest points between two 3D lines.  Returns (closest_on_1,
    closest_on_2, parallel_mask)."""
    n = torch.cross(d1, d2, dim=-1)
    parallel = torch.sum(n * n, dim=-1) < eps
    n1 = torch.cross(d1, n, dim=-1)
    n2 = torch.cross(d2, n, dim=-1)
    den1 = torch.sum(d1 * n2, dim=-1)
    den2 = torch.sum(d2 * n1, dim=-1)
    safe1 = torch.where(torch.abs(den1) < eps, torch.ones_like(den1), den1)
    safe2 = torch.where(torch.abs(den2) < eps, torch.ones_like(den2), den2)
    t1 = torch.sum((p2 - p1) * n2, dim=-1) / safe1
    t2 = torch.sum((p1 - p2) * n1, dim=-1) / safe2
    c1 = p1 + t1[..., None] * d1
    c2 = p2 + t2[..., None] * d2
    return c1, c2, parallel


def signed_line_distance(p1, d1, p2, d2, eps=1e-10):
    """Signed 3-vector distance between two 3D lines; for parallel lines
    ``d1 x (p1 - p2)``."""
    c1, c2, parallel = line_line_closest_points(p1, d1, p2, d2, eps)
    fallback = torch.cross(d1, p1 - p2, dim=-1)
    return torch.where(parallel[..., None], fallback, c1 - c2)
