"""Forward-backward pyramidal Lucas-Kanade tracking (port of
``track_forward_backward`` in ``rgbd_slam_tpu/ops/optical_flow.py``).

The port follows the semantics of the JAX package's Pallas path
(``lk_fwd_bwd_pallas``), which every TPU measurement came from: windows clamp to
the level size - 8 and the backward point gets no border check.  The JAX XLA path
differs on both (ROADMAP queue 3).
"""

from __future__ import annotations

import torch

from .image import in_border
from .lk_cuda import lk_fwd_bwd


def track_forward_backward(prev_pyramid, next_pyramid, points, points_valid,
                           max_roundtrip_px: float = 30.0, levels: int = 4,
                           win_h: int = 53, win_w: int = 53, iterations: int = 10,
                           bwd_levels: int | None = None,
                           coarse_win: int | None = None, eps: float = 0.03,
                           coarse_from_level: int = 1):
    """Forward LK + backward validation; rejects tracks whose round trip exceeds
    ``max_roundtrip_px`` or whose forward point leaves the image.

    Returns (tracked_points [N, 2], status [N] bool); untracked rows keep their
    input position."""
    n = points.shape[0]
    if n % 4:
        # the JAX package sends N % 4 != 0 through lk_pyramid_pallas twice
        raise NotImplementedError(
            "track_forward_backward needs N % 4 == 0; the forward-only LK kernel "
            "(lk_pyramid_pallas) is ROADMAP queue 2 #2, still to port")
    fwd, ok = lk_fwd_bwd(list(prev_pyramid), list(next_pyramid), points,
                         points_valid, levels=levels, win_h=win_h, win_w=win_w,
                         iterations=iterations, eps=eps,
                         max_roundtrip=float(max_roundtrip_px),
                         bwd_levels=bwd_levels, coarse_win=coarse_win,
                         coarse_from_level=coarse_from_level)
    h, w = prev_pyramid[0].shape
    status = ok & in_border(fwd, h, w, margin=1.0) & torch.isfinite(fwd).all(dim=-1)
    return torch.where(status[:, None], fwd, points), status
