"""Closed-form symmetric 3x3 eigendecomposition, batched (port of
``rgbd_slam_tpu/geometry/eig3.py``).

The trigonometric method (Smith 1961): eigenvalues from one acos, the wanted
eigenvector from cross products of (A - lambda I) rows.  ``torch.linalg.eigh``
is not used: its order and sign conventions differ from this closed form, and
the plane fits orient their normals from its sign choice.
"""

from __future__ import annotations

import math

import torch


def sym_eig3(a):
    """Eigenvalues (ascending) of symmetric [..., 3, 3] matrices, closed form."""
    a00, a11, a22 = a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]
    a01, a02, a12 = a[..., 0, 1], a[..., 0, 2], a[..., 1, 2]

    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp_min(p2 / 6.0, 1e-30))

    b00, b11, b22 = (a00 - q) / p, (a11 - q) / p, (a22 - q) / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    detb = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo

    isotropic = p2 < 1e-20
    e_lo = torch.where(isotropic, q, e_lo)
    e_mid = torch.where(isotropic, q, e_mid)
    e_hi = torch.where(isotropic, q, e_hi)
    return torch.stack([e_lo, e_mid, e_hi], dim=-1)


def eigenvector_for(a, lam):
    """Unit eigenvector of symmetric [..., 3, 3] ``a`` for eigenvalue ``lam``: the
    cross product of the two most independent rows of (a - lam I), on the
    norm-scaled matrix (squared cross-product norms of mm^2-scale moments
    overflow f32).  A repeated eigenvalue falls back to the z axis."""
    scale = torch.clamp_min(torch.abs(a).amax(dim=(-2, -1), keepdim=True), 1e-30)
    a = a / scale
    lam = lam / scale[..., 0, 0]
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    m = a - lam[..., None, None] * eye
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    cands = torch.stack([torch.linalg.cross(r0, r1), torch.linalg.cross(r0, r2),
                         torch.linalg.cross(r1, r2)], dim=-2)
    best = torch.argmax((cands * cands).sum(dim=-1), dim=-1)   # first of ties
    v = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 3)))[..., 0, :]
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    fallback = torch.zeros_like(v)
    fallback[..., 2] = 1.0
    return torch.where(norm > 1e-12, v / torch.clamp_min(norm, 1e-12), fallback)


def sym_eig3_smallest(a):
    """(eigenvalues ascending [..., 3], unit eigenvector of the smallest [..., 3])."""
    vals = sym_eig3(a)
    return vals, eigenvector_for(a, vals[..., 0])
