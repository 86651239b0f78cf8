"""Pyramidal Lucas-Kanade tracking with forward-backward validation (port of
``lk_track`` and ``track_forward_backward`` in ``rgbd_slam_tpu/ops/optical_flow.py``).

The port follows the semantics of the JAX package's Pallas path, which every TPU
measurement came from: windows clamp to the level size - 8.  A point count that
is a multiple of 4 goes through the fused forward-backward kernel, whose
backward point gets no border check; any other count runs the forward-only
kernel twice, as the JAX package composes ``lk_pyramid_pallas``, and that
branch does check the backward border.  The JAX XLA path differs on both
(ROADMAP queue 3).
"""

from __future__ import annotations

import torch

from .image import in_border
from .lk_cuda import _sample_windows, lk_fwd_bwd, lk_pyramid


def sample_window(img, top_left_xy, h: int, w: int):
    """Bilinear [h, w] window of ``img`` whose top-left corner is at the float
    position ``top_left_xy`` = (x, y); a batch [..., 2] of corners gives
    [..., h, w].  The fraction comes from the unclamped floor, the corner is
    clamped into the image (callers gate border points).  The plain LK versions
    sample through the same code."""
    xy = top_left_xy.reshape(-1, 2)
    out = _sample_windows(img, xy[:, 0], xy[:, 1], h, w)
    return out.reshape(top_left_xy.shape[:-1] + (h, w))


def lk_track(prev_pyramid, next_pyramid, points, points_valid, levels: int = 4,
             win_h: int = 53, win_w: int = 53, iterations: int = 10, eps: float = 0.03,
             coarse_win: int | None = None, coarse_from_level: int = 1):
    """Track ``points`` [N, 2] from the previous to the next image with the
    forward-only pyramidal LK.  Returns (new_points [N, 2], status [N] bool);
    status needs the level-0 tensor, a new point inside the 1 px border and
    finite; other rows keep their input position."""
    flow, ok = lk_pyramid(list(prev_pyramid), list(next_pyramid), points, points_valid,
                          levels=levels, win_h=win_h, win_w=win_w, iterations=iterations,
                          eps=eps, coarse_win=coarse_win,
                          coarse_from_level=coarse_from_level)
    new_pts = points + flow
    h, w = prev_pyramid[0].shape
    status = ok & in_border(new_pts, h, w, margin=1.0) & torch.isfinite(new_pts).all(dim=-1)
    return torch.where(status[:, None], new_pts, points), status


def track_forward_backward(prev_pyramid, next_pyramid, points, points_valid,
                           max_roundtrip_px: float = 30.0, levels: int = 4,
                           win_h: int = 53, win_w: int = 53, iterations: int = 10,
                           bwd_levels: int | None = None,
                           coarse_win: int | None = None, eps: float = 0.03,
                           coarse_from_level: int = 1):
    """Forward LK + backward validation; rejects tracks whose round trip exceeds
    ``max_roundtrip_px`` or whose forward point leaves the image.  The backward
    pass is zero-seeded and starts at ``bwd_levels`` (all levels when None).

    Returns (tracked_points [N, 2], status [N] bool); untracked rows keep their
    input position."""
    kw = dict(win_h=win_h, win_w=win_w, iterations=iterations, eps=eps,
              coarse_win=coarse_win, coarse_from_level=coarse_from_level)
    h, w = prev_pyramid[0].shape
    if points.shape[0] % 4 == 0:
        fwd, ok = lk_fwd_bwd(list(prev_pyramid), list(next_pyramid), points,
                             points_valid, levels=levels,
                             max_roundtrip=float(max_roundtrip_px),
                             bwd_levels=bwd_levels, **kw)
        status = ok & in_border(fwd, h, w, margin=1.0) & torch.isfinite(fwd).all(dim=-1)
        return torch.where(status[:, None], fwd, points), status

    fwd, fwd_ok = lk_track(prev_pyramid, next_pyramid, points, points_valid,
                           levels=levels, **kw)
    bwd_top = levels if bwd_levels is None or bwd_levels >= levels else bwd_levels
    bwd, bwd_ok = lk_track(next_pyramid, prev_pyramid, fwd, fwd_ok, levels=bwd_top, **kw)
    roundtrip = torch.linalg.vector_norm(points - bwd, dim=-1)
    status = fwd_ok & bwd_ok & (roundtrip <= max_roundtrip_px)
    return torch.where(status[:, None], fwd, points), status
