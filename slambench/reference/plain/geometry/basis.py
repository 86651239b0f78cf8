"""Cartesian <-> spherical basis changes (port of ``rgbd_slam_tpu/geometry/basis.py``).

Spherical is ``(p, theta, phi)`` with theta the polar angle from +z and
phi = atan2(y, x).  Batched over leading axes.
"""

from __future__ import annotations

import torch


def spherical_to_cartesian(sph):
    """(p, theta, phi) -> (x, y, z)."""
    p, theta, phi = sph[..., 0], sph[..., 1], sph[..., 2]
    st = torch.sin(theta)
    return torch.stack([p * st * torch.cos(phi), p * st * torch.sin(phi),
                        p * torch.cos(theta)], dim=-1)


def spherical_to_cartesian_jacobian(sph):
    """3x3 Jacobian d(x,y,z)/d(p,theta,phi)."""
    p, theta, phi = sph[..., 0], sph[..., 1], sph[..., 2]
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    t1 = sp * st
    t2 = cp * st
    zero = torch.zeros_like(p)
    return torch.stack([
        torch.stack([t2, p * ct * cp, -p * t1], dim=-1),
        torch.stack([t1, p * ct * sp, p * t2], dim=-1),
        torch.stack([ct, -p * st, zero], dim=-1),
    ], dim=-2)


def cartesian_to_spherical(xyz):
    """(x,y,z) -> (p, theta, phi)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    p = torch.linalg.vector_norm(xyz, dim=-1)
    theta = torch.arctan2(torch.sqrt(x * x + y * y), z)
    phi = torch.arctan2(y, x)
    return torch.stack([p, theta, phi], dim=-1)


def cartesian_to_spherical_jacobian(xyz):
    """3x3 Jacobian d(p,theta,phi)/d(x,y,z); singular on the z axis (x=y=0),
    guarded with an epsilon."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    t1 = xx + yy + zz
    t2 = torch.clamp_min(xx + yy, 1e-12)
    st1 = torch.sqrt(t1)
    st2 = torch.sqrt(t2)
    inv12 = 1.0 / (st2 * t1)
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([x / st1, y / st1, z / st1], dim=-1),
        torch.stack([x * z * inv12, y * z * inv12, -st2 / t1], dim=-1),
        torch.stack([-y / t2, x / t2, zero], dim=-1),
    ], dim=-2)
