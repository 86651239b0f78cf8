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
