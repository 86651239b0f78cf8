"""Small SPD solves for the LM normal equations and the Kalman gains (port of
``rgbd_slam_tpu/pose/linalg6.py``).

A batched Cholesky written out column by column with the JAX package's pivot
floor (``sqrt(max(s, eps))``), so a near-singular matrix gives a finite solution
instead of an error; callers discard bad solutions downstream.
"""

from __future__ import annotations

import torch


def solve_spd(a, b, eps: float = 1e-20):
    """Solve ``a x = b`` for SPD ``a`` [..., N, N]; ``b`` is [..., N] or
    [..., N, M]."""
    n = a.shape[-1]
    vec = b.dim() == a.dim() - 1
    if vec:
        b = b[..., None]
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a = a.expand(batch + (n, n))
    b = b.expand(batch + b.shape[-2:])

    cols = []      # cols[j]: column j of L below the diagonal, [..., N - j]
    inv_d = []
    for j in range(n):
        s = a[..., j:, j]
        for k in range(j):
            s = s - cols[k][..., j - k:] * cols[k][..., j - k:j - k + 1]
        d = torch.sqrt(torch.clamp_min(s[..., :1], eps))
        inv_d.append(1.0 / d)
        cols.append(torch.cat([d, s[..., 1:] * inv_d[j]], dim=-1))

    y = []         # forward substitution L y = b
    for i in range(n):
        s = b[..., i, :]
        for k in range(i):
            s = s - cols[k][..., i - k:i - k + 1] * y[k]
        y.append(s * inv_d[i])
    x = [None] * n  # back substitution L^T x = y
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - cols[i][..., k - i:k - i + 1] * x[k]
        x[i] = s * inv_d[i]
    out = torch.stack(x, dim=-2)
    return out[..., 0] if vec else out


def solve6_spd(a, b, eps: float = 1e-20):
    """6x6 SPD solve (LM normal equations)."""
    return solve_spd(a, b, eps)


def inv3(a, eps: float = 1e-30):
    """Closed-form adjugate inverse of [..., 3, 3] matrices; a determinant
    smaller than ``eps`` in magnitude is replaced by +-``eps``."""
    m = a
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
    c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
    c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
    c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
    c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    det = m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
    floor = torch.where(det < 0, -eps, eps).to(det.dtype)
    inv_det = 1.0 / torch.where(torch.abs(det) < eps, floor, det)
    adj = torch.stack([
        torch.stack([c00, c10, c20], dim=-1),
        torch.stack([c01, c11, c21], dim=-1),
        torch.stack([c02, c12, c22], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]
