"""Cartesian <-> spherical basis changes (port of ``rgbd_slam_tpu/geometry/basis.py``).

Spherical is ``(p, theta, phi)`` with theta the polar angle from +z and
phi = atan2(y, x).  Only the conversions the points-only step calls are ported.
"""

from __future__ import annotations

import torch


def spherical_to_cartesian(sph):
    """(p, theta, phi) -> (x, y, z)."""
    p, theta, phi = sph[..., 0], sph[..., 1], sph[..., 2]
    st = torch.sin(theta)
    return torch.stack([p * st * torch.cos(phi), p * st * torch.sin(phi),
                        p * torch.cos(theta)], dim=-1)


def cartesian_to_spherical(xyz):
    """(x,y,z) -> (p, theta, phi)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    p = torch.linalg.vector_norm(xyz, dim=-1)
    theta = torch.arctan2(torch.sqrt(x * x + y * y), z)
    phi = torch.arctan2(y, x)
    return torch.stack([p, theta, phi], dim=-1)
