"""Hessian-form plane helpers (port of ``rgbd_slam_tpu/geometry/planes.py``).

A plane is ``[nx, ny, nz, d]`` with unit normal; a point p lies on it iff
``n . p + d == 0``.  Batched over leading axes.
"""

from __future__ import annotations

import torch

from . import lines


def normalize_plane(plane_4):
    """Renormalize the normal part."""
    n = plane_4[..., :3]
    norm = torch.clamp_min(torch.linalg.vector_norm(n, dim=-1, keepdim=True), 1e-12)
    return torch.cat([n / norm, plane_4[..., 3:4]], dim=-1)


def plane_center(plane_4):
    """Closest point of the plane to the origin."""
    return plane_4[..., :3] * (-plane_4[..., 3:4])


def point_distance(plane_4, point):
    """Signed point-plane distance ``n.p + d``."""
    return (plane_4[..., :3] * point).sum(dim=-1) + plane_4[..., 3]


def cos_angle(plane_a, plane_b):
    """Cosine of the angle between two plane normals."""
    return (plane_a[..., :3] * plane_b[..., :3]).sum(dim=-1)


def transform_plane(plane_4, plane_m44):
    """Apply a 4x4 plane transform."""
    return (plane_m44 @ plane_4[..., None])[..., 0]


def signed_distance(world_plane, camera_plane, plane_w2c):
    """4-vector plane error: wrapped angular distance of the normals plus the d
    difference."""
    proj = transform_plane(world_plane, plane_w2c)
    ang = lines.angle_distance(camera_plane[..., :3], proj[..., :3])
    dd = camera_plane[..., 3:4] - proj[..., 3:4]
    return torch.cat([ang, dd], dim=-1)


def reduced_signed_distance(world_plane, camera_plane, plane_w2c):
    """Reduced 3-vector plane error ``d_c * n_c - d_p * n_p`` (LM cost)."""
    proj = transform_plane(world_plane, plane_w2c)
    return (camera_plane[..., 3:4] * camera_plane[..., :3]
            - proj[..., 3:4] * proj[..., :3])
