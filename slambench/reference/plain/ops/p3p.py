"""Batched perspective-three-point (P3P) absolute pose solver (port of
``rgbd_slam_tpu/ops/p3p.py``): the Grunert depth-ratio quartic, closed-form
Ferrari roots with a Newton polish, and absolute orientation from orthonormal
triads.  Everything broadcasts over leading axes; each subset returns up to four
candidate poses with validity masks.
"""

from __future__ import annotations

import torch

from ..geometry import se3


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _cubic_largest_real_root(a2, a1, a0):
    """Largest real root of z^3 + a2 z^2 + a1 z + a0 (trigonometric method)."""
    p = a1 - a2 * a2 / 3.0
    q = 2.0 * a2 ** 3 / 27.0 - a2 * a1 / 3.0 + a0
    m = torch.sqrt(torch.clamp_min(-p / 3.0, 1e-12))
    arg = torch.clamp(3.0 * q / (2.0 * p * m + 1e-30), -1.0, 1.0)
    t_trig = 2.0 * m * torch.cos(torch.arccos(arg) / 3.0)
    disc = torch.sqrt(torch.clamp_min(q * q / 4.0 + p ** 3 / 27.0, 0.0))
    t_card = _cbrt(-q / 2.0 + disc) + _cbrt(-q / 2.0 - disc)
    t = torch.where(p < 0, t_trig, t_card)
    return t - a2 / 3.0


def _quartic_roots(c4, c3, c2, c1, c0):
    """Real roots of a quartic (Ferrari), [..., 4] with a validity mask; complex
    root pairs are reported invalid."""
    safe4 = torch.where(torch.abs(c4) < 1e-12, torch.ones_like(c4), c4)
    p = c3 / safe4
    q = c2 / safe4
    r = c1 / safe4
    s = c0 / safe4

    alpha = q - 3.0 * p * p / 8.0
    beta = r - p * q / 2.0 + p ** 3 / 8.0
    gamma = s - p * r / 4.0 + p * p * q / 16.0 - 3.0 * p ** 4 / 256.0

    z = _cubic_largest_real_root(2.0 * alpha, alpha * alpha - 4.0 * gamma, -beta * beta)
    z = torch.clamp_min(z, 1e-12)
    w = torch.sqrt(z)

    t1 = (alpha + z - beta / w) / 2.0
    t2 = (alpha + z + beta / w) / 2.0
    d1 = w * w / 4.0 - t1
    d2 = w * w / 4.0 - t2
    ok1 = d1 >= 0
    ok2 = d2 >= 0
    s1 = torch.sqrt(torch.clamp_min(d1, 0.0))
    s2 = torch.sqrt(torch.clamp_min(d2, 0.0))

    y = torch.stack([-w / 2.0 + s1, -w / 2.0 - s1, w / 2.0 + s2, w / 2.0 - s2], dim=-1)
    valid = torch.stack([ok1, ok1, ok2, ok2], dim=-1)
    roots = y - (p / 4.0)[..., None]

    c4_, c3_, c2_, c1_, c0_ = (c[..., None] for c in (c4, c3, c2, c1, c0))
    for _ in range(3):
        f = (((c4_ * roots + c3_) * roots + c2_) * roots + c1_) * roots + c0_
        df = ((4.0 * c4_ * roots + 3.0 * c3_) * roots + 2.0 * c2_) * roots + c1_
        roots = roots - f / torch.where(torch.abs(df) > 1e-12, df,
                                        torch.full_like(df, 1e-12))
    return roots, valid


def p3p(world_points, bearings):
    """Solve P3P for minimal subsets.

    world_points [..., 3, 3] (rows), bearings [..., 3, 3] unit camera-frame rays.
    Returns (quat [..., 4, 4], position [..., 4, 3], valid [..., 4])."""
    x1, x2, x3 = world_points[..., 0, :], world_points[..., 1, :], world_points[..., 2, :]
    f1, f2, f3 = bearings[..., 0, :], bearings[..., 1, :], bearings[..., 2, :]

    a12 = torch.sum((x1 - x2) ** 2, dim=-1)
    a13 = torch.sum((x1 - x3) ** 2, dim=-1)
    a23 = torch.sum((x2 - x3) ** 2, dim=-1)
    b12 = torch.sum(f1 * f2, dim=-1)
    b13 = torch.sum(f1 * f3, dim=-1)
    b23 = torch.sum(f2 * f3, dim=-1)

    c4 = (a12 ** 2 - 4 * a12 * a13 * b23 ** 2 + 2 * a12 * a13 - 2 * a12 * a23
          + a13 ** 2 - 2 * a13 * a23 + a23 ** 2)
    c3 = 4 * (-a12 ** 2 * b13 + a12 * a13 * b12 * b23
              + 2 * a12 * a13 * b13 * b23 ** 2 - a12 * a13 * b13
              + 2 * a12 * a23 * b13 - a13 ** 2 * b12 * b23
              + a13 * a23 * b12 * b23 + a13 * a23 * b13 - a23 ** 2 * b13)
    c2 = 2 * (2 * a12 ** 2 * b13 ** 2 + a12 ** 2
              - 4 * a12 * a13 * b12 * b13 * b23 - 2 * a12 * a13 * b23 ** 2
              - 4 * a12 * a23 * b13 ** 2 - 2 * a12 * a23
              + 2 * a13 ** 2 * b12 ** 2 + 2 * a13 ** 2 * b23 ** 2 - a13 ** 2
              - 2 * a13 * a23 * b12 ** 2 - 4 * a13 * a23 * b12 * b13 * b23
              + 2 * a23 ** 2 * b13 ** 2 + a23 ** 2)
    c1 = 4 * (-a12 ** 2 * b13 + a12 * a13 * b12 * b23 + a12 * a13 * b13
              + 2 * a12 * a23 * b13 - a13 ** 2 * b12 * b23
              + 2 * a13 * a23 * b12 ** 2 * b13 + a13 * a23 * b12 * b23
              - a13 * a23 * b13 - a23 ** 2 * b13)
    c0 = (a12 ** 2 - 2 * a12 * a13 - 2 * a12 * a23 + a13 ** 2
          - 4 * a13 * a23 * b12 ** 2 + 2 * a13 * a23 + a23 ** 2)

    v, v_ok = _quartic_roots(c4, c3, c2, c1, c0)

    r_ratio = (a12 / torch.clamp_min(a13, 1e-12))[..., None]
    cv = 1.0 - r_ratio * (v * v - 2.0 * b13[..., None] * v + 1.0)
    sq = torch.sqrt(torch.clamp_min(b12[..., None] ** 2 - cv, 0.0))
    u0 = b12[..., None] + sq
    u1 = b12[..., None] - sq

    def b_resid(u):
        return torch.abs((1 + u * u - 2 * b12[..., None] * u) * a23[..., None]
                         - (u * u + v * v - 2 * b23[..., None] * u * v) * a12[..., None])

    u = torch.where(b_resid(u0) <= b_resid(u1), u0, u1)

    s_sq = a12[..., None] / torch.clamp_min(1.0 + u * u - 2.0 * b12[..., None] * u, 1e-12)
    lam1 = torch.sqrt(torch.clamp_min(s_sq, 0.0))
    lam2 = u * lam1
    lam3 = v * lam1
    valid = v_ok & (lam1 > 0) & (lam2 > 0) & (lam3 > 0) \
        & (b12[..., None] ** 2 - cv >= -1e-3)

    p1 = lam1[..., None] * f1[..., None, :]
    p2 = lam2[..., None] * f2[..., None, :]
    p3 = lam3[..., None] * f3[..., None, :]

    pw = torch.stack([x1, x2, x3], dim=-2)[..., None, :, :]   # [..., 1, 3pts, 3]
    pc = torch.stack([p1, p2, p3], dim=-2)                    # [..., 4cand, 3pts, 3]

    def triad(pts):
        a = pts[..., 1, :] - pts[..., 0, :]
        b = pts[..., 2, :] - pts[..., 0, :]
        e1 = a / torch.clamp_min(torch.linalg.vector_norm(a, dim=-1, keepdim=True), 1e-12)
        b_perp = b - torch.sum(b * e1, dim=-1, keepdim=True) * e1
        e2 = b_perp / torch.clamp_min(
            torch.linalg.vector_norm(b_perp, dim=-1, keepdim=True), 1e-12)
        e3 = torch.linalg.cross(e1, e2, dim=-1)
        return torch.stack([e1, e2, e3], dim=-1)  # columns

    cw = triad(pw)
    cc = triad(pc)
    rot = cc @ cw.transpose(-1, -2)                # world -> camera
    w_mean = torch.mean(pw, dim=-2)
    c_mean = torch.mean(pc, dim=-2)
    t = c_mean - (rot @ w_mean[..., None])[..., 0]

    rot_c2w = rot.transpose(-1, -2)
    t_c2w = -(rot_c2w @ t[..., None])[..., 0]
    axis_t = se3.axis_correction_44(rot.dtype, rot.device)[:3, :3].T
    rq = axis_t @ rot_c2w
    pos = (axis_t @ t_c2w[..., None])[..., 0]
    quat = se3.matrix_to_quat(rq)

    finite = torch.isfinite(quat).all(dim=-1) & torch.isfinite(pos).all(dim=-1)
    return quat, pos, valid & finite
