"""Fixed-capacity convex polygon operations (port of
``rgbd_slam_tpu/utils/polygon.py``), batched over leading axes.

A polygon is (verts [..., V, 2], count [...]): vertices beyond ``count`` are
ignored; a valid polygon is convex and counter-clockwise.  Where the JAX package
vmaps a one-polygon function, these take the batch as leading axes.  Every sort
is stable, so ties order as XLA orders them.
"""

from __future__ import annotations

import torch

#: polygon vertex capacity
MAX_VERTS = 16


def _gather_rows(x, idx):
    """x [..., N, D], idx [..., K] -> x[..., idx, :] per batch row."""
    idx = idx.to(torch.int64)
    return torch.gather(x, -2, idx[..., None].expand(idx.shape + x.shape[-1:]))


def plane_basis(normal):
    """Orthonormal (u, v) basis of the plane with the given unit normal."""
    n = normal / torch.clamp_min(torch.linalg.vector_norm(normal, dim=-1, keepdim=True),
                                 1e-12)
    ex = torch.zeros_like(n)
    ex[..., 0] = 1.0
    ey = torch.zeros_like(n)
    ey[..., 1] = 1.0
    ref = torch.where(torch.abs(n[..., 0:1]) < 0.9, ex, ey)
    u = torch.linalg.cross(n, ref)
    u = u / torch.clamp_min(torch.linalg.vector_norm(u, dim=-1, keepdim=True), 1e-12)
    return u, torch.linalg.cross(n, u)


def project_to_plane(points, center, u, v):
    """3D points [..., P, 3] -> 2D plane-local coordinates; center, u, v [..., 3]."""
    rel = points - center[..., None, :]
    return torch.stack([(rel * u[..., None, :]).sum(dim=-1),
                        (rel * v[..., None, :]).sum(dim=-1)], dim=-1)


def unproject_from_plane(pts2, center, u, v):
    """2D plane-local coordinates [..., P, 2] -> 3D points; center, u, v [..., 3]."""
    return (center[..., None, :] + pts2[..., 0:1] * u[..., None, :]
            + pts2[..., 1:2] * v[..., None, :])


def _convexify(verts, count):
    """True convex hull of the first ``count`` vertices, CCW-ordered: edge i->j is
    a hull edge iff every other active point lies on its left; hull vertices are
    angle-ordered around their own centroid.  Returns (verts, count) padded with
    the first vertex."""
    n = verts.shape[-2]
    idx = torch.arange(n, device=verts.device)
    act = idx < count[..., None]
    d = verts[..., None, :, :] - verts[..., :, None, :]      # [..., i, j, 2] = pj - pi
    dn = (d * d).sum(dim=-1)
    # duplicates first: a later copy would make zero-length cycle edges
    pair = act[..., :, None] & act[..., None, :]
    scale2 = torch.where(pair, dn, torch.zeros_like(dn)).amax(dim=(-2, -1))
    dup = (pair & (dn <= 1e-10 * torch.clamp_min(scale2, 1e-30)[..., None, None])
           & (idx[:, None] > idx[None, :]))
    act = act & ~dup.any(dim=-1)
    cross = (d[..., :, :, None, 0] * d[..., :, None, :, 1]
             - d[..., :, :, None, 1] * d[..., :, None, :, 0])   # [..., i, j, k]
    eps = 1e-5 * torch.sqrt(dn[..., :, :, None] * dn[..., :, None, :] + 1e-30)
    k_ok = ~act[..., None, None, :] | (cross >= -eps)
    edge = act[..., :, None] & act[..., None, :] & (dn > 1e-12) & k_ok.all(dim=-1)
    on_hull = edge.any(dim=-1) & act

    out_cnt = on_hull.sum(dim=-1)
    hcnt = torch.clamp_min(out_cnt, 1)
    centroid = torch.where(on_hull[..., None], verts,
                           torch.zeros_like(verts)).sum(dim=-2) / hcnt[..., None]
    rel = verts - centroid[..., None, :]
    ang = torch.where(on_hull, torch.atan2(rel[..., 1], rel[..., 0]),
                      torch.full_like(rel[..., 0], 1e9))
    out = _gather_rows(verts, torch.argsort(ang, dim=-1, stable=True))
    out = torch.where((idx < out_cnt[..., None])[..., None], out, out[..., :1, :])
    return _drop_flat_vertices(out, out_cnt)


def _drop_flat_vertices(verts, count, eps_rel=1e-4, iters=3):
    """Remove collinear and micro-concave vertices from an ordered cycle, keeping
    strict corners (turn sin > eps_rel): a nearly collinear vertex would make a
    half-plane clip divide noise by noise."""
    n = verts.shape[-2]
    idx = torch.arange(n, device=verts.device)
    for _ in range(iters):
        act = idx < count[..., None]
        last = _gather_rows(verts, torch.clamp(count - 1, 0, n - 1)[..., None])
        nxt = torch.where((idx == (count - 1)[..., None])[..., None], verts[..., :1, :],
                          torch.roll(verts, -1, dims=-2))
        prv = torch.where((idx == 0)[..., None], last, torch.roll(verts, 1, dims=-2))
        e1 = verts - prv
        e2 = nxt - verts
        cr = e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]
        l1l2 = torch.sqrt((e1 * e1).sum(dim=-1) * (e2 * e2).sum(dim=-1))
        keep = act & (cr > eps_rel * l1l2)
        count = keep.sum(dim=-1)
        out = _gather_rows(verts, torch.argsort((~keep).to(torch.int32), dim=-1,
                                                stable=True))
        verts = torch.where((idx < count[..., None])[..., None], out, out[..., :1, :])
    return verts, count.to(torch.int32)


def convex_hull_by_angle(pts2, mask, max_verts: int = MAX_VERTS):
    """Convex hull of masked 2D points [..., N, 2], capped at ``max_verts``
    vertices: the first 128 masked points in index order, angular decimation
    around their centroid, then the exact hull of the survivors.  Returns
    (verts [..., max_verts, 2], count)."""
    n = pts2.shape[-2]
    dev = pts2.device
    cap = 128
    if n > cap:
        pri = torch.where(mask, -torch.arange(n, dtype=pts2.dtype, device=dev),
                          torch.full_like(pts2[..., 0], -float("inf")))
        keep = torch.sort(pri, dim=-1, descending=True, stable=True).indices[..., :cap]
        pts2 = _gather_rows(pts2, keep)
        mask = torch.gather(mask, -1, keep)
        n = cap
    valid_n = mask.sum(dim=-1)
    cnt = torch.clamp_min(valid_n, 1)
    centroid = torch.where(mask[..., None], pts2, torch.zeros_like(pts2)).sum(dim=-2) \
        / cnt[..., None]
    rel = pts2 - centroid[..., None, :]
    ang = torch.where(mask, torch.atan2(rel[..., 1], rel[..., 0]),
                      torch.full_like(rel[..., 0], 1e9))
    order = torch.argsort(ang, dim=-1, stable=True)
    sorted_pts = _gather_rows(pts2, order)
    sorted_mask = torch.gather(mask, -1, order)

    count = torch.clamp_max(valid_n, max_verts)
    slot = torch.arange(max_verts, device=dev)
    idx = torch.clamp_max((slot * torch.clamp_min(valid_n, 1)[..., None])
                          // torch.clamp_min(count, 1)[..., None], n - 1)
    verts = _gather_rows(sorted_pts, idx)
    vmask = torch.gather(sorted_mask, -1, idx) & (slot < count[..., None])
    verts = torch.where(vmask[..., None], verts, verts[..., :1, :])
    return _convexify(verts, count)


def _edges(verts, count):
    """Directed edge list (start, end, active) with wraparound at ``count``."""
    idx = torch.arange(verts.shape[-2], device=verts.device)
    nxt = torch.where((idx == (count - 1)[..., None])[..., None], verts[..., :1, :],
                      torch.roll(verts, -1, dims=-2))
    return verts, nxt, idx < count[..., None]


def polygon_area(verts, count):
    """Shoelace area of the first ``count`` vertices (assumed ordered)."""
    v, nxt, active = _edges(verts, count)
    cross = v[..., 0] * nxt[..., 1] - nxt[..., 0] * v[..., 1]
    return 0.5 * torch.abs(torch.where(active, cross, torch.zeros_like(cross)).sum(dim=-1))


def _as_ccw(verts, count):
    """Reorder the first ``count`` vertices counter-clockwise (no-op if already)."""
    v, nxt, act = _edges(verts, count)
    signed = torch.where(act, v[..., 0] * nxt[..., 1] - v[..., 1] * nxt[..., 0],
                         torch.zeros_like(v[..., 0])).sum(dim=-1)
    n = verts.shape[-2]
    idx = torch.arange(n, device=verts.device)
    ridx = torch.where(idx < count[..., None], (count - 1)[..., None] - idx, idx)
    reversed_ = _gather_rows(verts, torch.clamp(ridx, 0, n - 1))
    return torch.where((signed >= 0)[..., None, None], verts, reversed_)


def _clipped_boundary_integral(av, an, aact, bv, bn, bact, strict=False):
    """Green's-theorem contribution of A's edges clipped to the inside of convex
    CCW polygon B: each edge's feasible t-interval against every half-plane of B
    in closed form; the surviving sub-segment [u, w] adds cross(u, w) / 2.
    ``strict`` counts lying ON a B edge line as outside (second pass), so a
    shared collinear boundary is integrated once."""
    d = an - av                                           # [..., n, 2]
    eb = bn - bv                                          # [..., m, 2]
    rel = av[..., :, None, :] - bv[..., None, :, :]       # [..., n, m, 2]
    alpha = eb[..., None, :, 0] * rel[..., 1] - eb[..., None, :, 1] * rel[..., 0]
    beta = eb[..., None, :, 0] * d[..., :, None, 1] - eb[..., None, :, 1] * d[..., :, None, 0]
    ebn = torch.sqrt((eb * eb).sum(dim=-1))
    dn = torch.sqrt((d * d).sum(dim=-1))
    reln = torch.sqrt((rel * rel).sum(dim=-1))
    par = torch.abs(beta) <= 1e-4 * ebn[..., None, :] * dn[..., :, None] + 1e-30
    tol_a = 1e-4 * ebn[..., None, :] * (reln + dn[..., :, None]) + 1e-30
    pos = ~par & (beta > 0)
    neg = ~par & (beta < 0)
    inf = torch.full_like(alpha, float("inf"))
    one = torch.ones_like(beta)
    lo_j = torch.where(pos, -alpha / torch.where(pos, beta, one), -inf)
    hi_j = torch.where(neg, -alpha / torch.where(neg, beta, one), inf)
    inside_par = (alpha > tol_a) if strict else (alpha >= -tol_a)
    hi_j = torch.where(par & ~inside_par, -inf, hi_j)
    lo_j = torch.where(bact[..., None, :], lo_j, -inf)
    hi_j = torch.where(bact[..., None, :], hi_j, inf)
    t_lo = torch.clamp(lo_j.amax(dim=-1), 0.0, 1.0)
    t_hi = torch.clamp(hi_j.amin(dim=-1), 0.0, 1.0)
    ok = aact & (t_hi > t_lo)
    u = av + t_lo[..., None] * d
    w = av + t_hi[..., None] * d
    contrib = 0.5 * (u[..., 0] * w[..., 1] - u[..., 1] * w[..., 0])
    return torch.where(ok, contrib, torch.zeros_like(contrib)).sum(dim=-1)


def convex_intersection_area(verts_a, count_a, verts_b, count_b):
    """Exact area of the intersection of two convex polygons: A's edges clipped
    to B plus B's edges clipped to A, summed by Green's theorem."""
    av, an, aact = _edges(_as_ccw(verts_a, count_a), count_a)
    bv, bn, bact = _edges(_as_ccw(verts_b, count_b), count_b)
    area = (_clipped_boundary_integral(av, an, aact, bv, bn, bact)
            + _clipped_boundary_integral(bv, bn, bact, av, an, aact, strict=True))
    valid = (count_a >= 3) & (count_b >= 3)
    return torch.where(valid, torch.clamp_min(area, 0.0), torch.zeros_like(area))


def polygon_iou(verts_a, count_a, verts_b, count_b):
    """Inter-over-union of two convex polygons."""
    inter = convex_intersection_area(verts_a, count_a, verts_b, count_b)
    union = polygon_area(verts_a, count_a) + polygon_area(verts_b, count_b) - inter
    return torch.where(union > 1e-9, inter / torch.clamp_min(union, 1e-9),
                       torch.zeros_like(union))


def inter_over_area(verts_a, count_a, verts_b, count_b):
    """Intersection over the smaller polygon's area."""
    inter = convex_intersection_area(verts_a, count_a, verts_b, count_b)
    area = torch.minimum(polygon_area(verts_a, count_a), polygon_area(verts_b, count_b))
    return torch.where(area > 1e-9, inter / torch.clamp_min(area, 1e-9),
                       torch.zeros_like(area))


def merge_polygons(verts_a, count_a, verts_b, count_b, max_verts: int = MAX_VERTS):
    """Union-merge: the convex hull of both vertex sets."""
    idx_a = torch.arange(verts_a.shape[-2], device=verts_a.device)
    idx_b = torch.arange(verts_b.shape[-2], device=verts_b.device)
    mask = torch.cat([idx_a < count_a[..., None], idx_b < count_b[..., None]], dim=-1)
    return convex_hull_by_angle(torch.cat([verts_a, verts_b], dim=-2), mask, max_verts)
