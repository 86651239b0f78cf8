"""Frozen plain copy: the kernel, its build and its binding are cut, and every
device runs the plain version (see the package's docstring).

Pyramidal Lucas-Kanade: the CUDA kernels' wrappers and their plain PyTorch
versions.

Three entry points, one per kernel of ``csrc/lk.cu``:

* ``lk_fwd_bwd``: fused forward + backward pyramidal LK with the round-trip gate
  (replaces ``rgbd_slam_tpu.ops.pallas_lk.lk_fwd_bwd_pallas``);
* ``lk_pyramid``: forward-only pyramidal LK, flow and status (replaces
  ``lk_pyramid_pallas``);
* ``lk_level``: one LK level from per-point guesses (replaces
  ``lk_level_pallas``).

For CUDA tensors each launches its hand-written Hopper kernel or raises; for CPU
tensors it runs its plain version (``*_reference``), the same semantics as
batched tensor code with lockstep masked iterations.

The kernels are compiled with ``nvcc`` on first use from the source in this
package, into ``rgbd_slam_tpu_torch/_build/``, and bound with ctypes.
"""

from __future__ import annotations


import torch


_MAX_LEVELS = 8  # LK_MAX_LEVELS in the kernel source


def window_sizes(dims, win_h: int, win_w: int, coarse_win: int | None,
                 coarse_from_level: int):
    """Per-level (rows, cols) windows, as lk_fwd_bwd_pallas computes them: the
    coarse window from ``coarse_from_level`` up, clamped to the level size - 8.
    At ``coarse_win`` None (or equal to the window) this is lk_pyramid_pallas's
    ``min(win, level - 8)``."""
    return tuple(
        (min(win_h if lvl < coarse_from_level else (coarse_win or win_h), lh - 8),
         min(win_w if lvl < coarse_from_level else (coarse_win or win_w), lw - 8))
        for lvl, (lh, lw) in enumerate(dims))


def _dims(pyramid, levels: int):
    return tuple((int(p.shape[0]), int(p.shape[1])) for p in pyramid[:levels + 1])


def _dispatch(points, cuda_fn, plain_fn, *args, **kw):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    return plain_fn(*args, **kw)


def lk_fwd_bwd(prev_pyramid, next_pyramid, points, valid, levels: int = 4,
               win_h: int = 53, win_w: int = 53, iterations: int = 10,
               eps: float = 0.03, max_roundtrip: float = 35.0,
               bwd_levels: int | None = None, coarse_win: int | None = None,
               coarse_from_level: int = 1):
    """Fused forward+backward pyramidal LK with the round-trip gate.

    ``points`` [N, 2] f32 (x, y) at level 0, ``valid`` [N] bool.  Returns
    (points + forward flow [N, 2], ok [N] bool)."""
    return _dispatch(points, None, lk_fwd_bwd_reference, prev_pyramid,
                     next_pyramid, points, valid, levels=levels, win_h=win_h, win_w=win_w,
                     iterations=iterations, eps=eps, max_roundtrip=max_roundtrip,
                     bwd_levels=bwd_levels, coarse_win=coarse_win,
                     coarse_from_level=coarse_from_level)


def lk_pyramid(prev_pyramid, next_pyramid, points, valid, levels: int = 4,
               win_h: int = 53, win_w: int = 53, iterations: int = 10,
               eps: float = 0.03, coarse_win: int | None = None,
               coarse_from_level: int = 1):
    """Forward-only pyramidal LK, zero-seeded at the top level, for any N >= 0.

    ``points`` [N, 2] f32 (x, y) at level 0, ``valid`` [N] bool.  Returns (flow
    [N, 2] at level 0, ok [N] bool); only level 0 sets ok."""
    return _dispatch(points, None, lk_pyramid_reference, prev_pyramid,
                     next_pyramid, points, valid, levels=levels, win_h=win_h, win_w=win_w,
                     iterations=iterations, eps=eps, coarse_win=coarse_win,
                     coarse_from_level=coarse_from_level)


def lk_level(prev_img, next_img, points, guesses, valid, win_h: int, win_w: int,
             iterations: int = 10, eps: float = 0.03):
    """One LK level.  ``points`` and ``guesses`` [N, 2] at this level's scale, an
    explicit window (no size clamp).  Returns (new guesses [N, 2], ok [N] bool),
    ok = det > 1e-6 & valid."""
    return _dispatch(points, None, lk_level_reference, prev_img, next_img,
                     points, guesses, valid, win_h=win_h, win_w=win_w,
                     iterations=iterations, eps=eps)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _sample_windows(img, x, y, h: int, w: int):
    """Bilinear [N, h, w] windows of ``img`` with float top-left (x[N], y[N]): the
    index clamps to ``l - (w + 1)``, the fraction comes from the unclamped floor."""
    lh, lw = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None, None]
    fy = (y - y0)[:, None, None]
    xi = x0.clamp(-1e9, 1e9).to(torch.int64).clamp(0, lw - (w + 1))
    yi = y0.clamp(-1e9, 1e9).to(torch.int64).clamp(0, lh - (h + 1))
    rows = yi[:, None] + torch.arange(h + 1, device=img.device)
    cols = xi[:, None] + torch.arange(w + 1, device=img.device)
    p = img[rows[:, :, None], cols[:, None, :]]
    return ((1 - fy) * ((1 - fx) * p[:, :h, :w] + fx * p[:, :h, 1:])
            + fy * ((1 - fx) * p[:, 1:, :w] + fx * p[:, 1:, 1:]))


def _level_reference(src, dst, tlx, tly, gx, gy, valid, wh: int, ww: int,
                     iterations: int, eps_sq: float, taken=None):
    """One LK level of all points in lockstep from the guesses (gx, gy); a
    converged point's step is frozen (the Pallas semantics), and the loop runs
    all ``iterations`` without asking the host whether every point is done, so
    that the step it is part of reads the host nowhere.  Returns (gx, gy,
    lvl_ok).  ``taken``, a list, receives the [N] count of iterations each point
    really ran (a point stops after the step that falls under eps)."""
    tp = _sample_windows(src, tlx - 1.0, tly - 1.0, wh + 2, ww + 2)
    t = tp[:, 1:-1, 1:-1]
    ix = 0.5 * (tp[:, 1:-1, 2:] - tp[:, 1:-1, :-2])
    iy = 0.5 * (tp[:, 2:, 1:-1] - tp[:, :-2, 1:-1])
    gxx = (ix * ix).sum(dim=(1, 2))
    gxy = (ix * iy).sum(dim=(1, 2))
    gyy = (iy * iy).sum(dim=(1, 2))
    det = gxx * gyy - gxy * gxy
    lvl_ok = (det > 1e-6) & valid
    inv_det = torch.where(lvl_ok, 1.0 / torch.where(lvl_ok, det, torch.ones_like(det)),
                          torch.zeros_like(det))
    done = ~lvl_ok
    n_taken = torch.zeros_like(done, dtype=torch.int64)
    for _ in range(iterations):
        n_taken += ~done
        j = _sample_windows(dst, tlx + gx, tly + gy, wh, ww)
        diff = t - j
        bx = (ix * diff).sum(dim=(1, 2))
        by = (iy * diff).sum(dim=(1, 2))
        dx = torch.where(done, torch.zeros_like(bx), (gyy * bx - gxy * by) * inv_det)
        dy = torch.where(done, torch.zeros_like(by), (gxx * by - gxy * bx) * inv_det)
        gx = gx + dx
        gy = gy + dy
        done = done | (dx * dx + dy * dy < eps_sq)
    if taken is not None:
        taken.append(n_taken)
    return gx, gy, lvl_ok


def _top_left(p, win: int, size: int):
    return torch.clamp(p - (win - 1) / 2.0, 2.0, size - win - 3.0)


def _track_direction_reference(src, dst, px, py, valid, top: int, dims, wins,
                               iterations: int, eps_sq: float, taken=None):
    """Coarse-to-fine LK of all points from level ``top`` down, zero-seeded.
    ``taken``, a list, receives one [N] iteration count per level, top first."""
    gx = torch.zeros_like(px)
    gy = torch.zeros_like(py)
    ok = valid.clone()
    for lvl in range(top, -1, -1):
        (lh, lw), (wh, ww) = dims[lvl], wins[lvl]
        scale = 0.5 ** lvl
        gx, gy, lvl_ok = _level_reference(
            src[lvl], dst[lvl], _top_left(px * scale, ww, lw), _top_left(py * scale, wh, lh),
            gx, gy, valid, wh, ww, iterations, eps_sq, taken=taken)
        if lvl == 0:  # only the finest level sets status
            ok = ok & lvl_ok
        else:
            gx = gx * 2.0
            gy = gy * 2.0
    return gx, gy, ok


def lk_fwd_bwd_reference(prev_pyramid, next_pyramid, points, valid, levels: int = 4,
                         win_h: int = 53, win_w: int = 53, iterations: int = 10,
                         eps: float = 0.03, max_roundtrip: float = 35.0,
                         bwd_levels: int | None = None,
                         coarse_win: int | None = None, coarse_from_level: int = 1):
    """Plain PyTorch version of the fused kernel: same semantics, batched."""
    dims = _dims(prev_pyramid, levels)
    wins = window_sizes(dims, win_h, win_w, coarse_win, coarse_from_level)
    bwd_top = levels if bwd_levels is None else bwd_levels
    px = points[:, 0].to(torch.float32)
    py = points[:, 1].to(torch.float32)
    kw = dict(dims=dims, wins=wins, iterations=iterations, eps_sq=float(eps * eps))
    fgx, fgy, fok = _track_direction_reference(prev_pyramid, next_pyramid, px, py,
                                               valid, levels, **kw)
    fx = px + fgx
    fy = py + fgy
    bgx, bgy, bok = _track_direction_reference(next_pyramid, prev_pyramid, fx, fy,
                                               fok, bwd_top, **kw)
    rt2 = (fgx + bgx) ** 2 + (fgy + bgy) ** 2
    ok = fok & bok & (rt2 <= float(max_roundtrip * max_roundtrip))
    return torch.stack([fx, fy], dim=-1), ok


def lk_pyramid_reference(prev_pyramid, next_pyramid, points, valid, levels: int = 4,
                         win_h: int = 53, win_w: int = 53, iterations: int = 10,
                         eps: float = 0.03, coarse_win: int | None = None,
                         coarse_from_level: int = 1):
    """Plain PyTorch version of the forward-only kernel."""
    dims = _dims(prev_pyramid, levels)
    wins = window_sizes(dims, win_h, win_w, coarse_win, coarse_from_level)
    gx, gy, ok = _track_direction_reference(
        prev_pyramid, next_pyramid, points[:, 0].to(torch.float32),
        points[:, 1].to(torch.float32), valid, levels, dims, wins, iterations,
        float(eps * eps))
    return torch.stack([gx, gy], dim=-1), ok


def lk_level_reference(prev_img, next_img, points, guesses, valid, win_h: int,
                       win_w: int, iterations: int = 10, eps: float = 0.03):
    """Plain PyTorch version of the single-level kernel."""
    _check_level_window(prev_img.shape, win_h, win_w)
    lh, lw = prev_img.shape
    gx, gy, ok = _level_reference(
        prev_img, next_img, _top_left(points[:, 0], win_w, lw),
        _top_left(points[:, 1], win_h, lh), guesses[:, 0].to(torch.float32),
        guesses[:, 1].to(torch.float32), valid, win_h, win_w, iterations,
        float(eps * eps))
    return torch.stack([gx, gy], dim=-1), ok


def roundtrip_px_reference(prev_pyramid, next_pyramid, points, tracked, levels: int = 4,
                           win_h: int = 53, win_w: int = 53, iterations: int = 10,
                           eps: float = 0.03, bwd_levels: int | None = None,
                           coarse_win: int | None = None, coarse_from_level: int = 1):
    """The distance the round-trip gate compares, from the plain version: for each
    row, |forward flow + backward flow| with the backward pass run from
    ``tracked`` (the forward result).  Comparisons of two LK versions use it to
    excuse flag disagreements on rows that sit at the gate."""
    dims = _dims(prev_pyramid, levels)
    wins = window_sizes(dims, win_h, win_w, coarse_win, coarse_from_level)
    bgx, bgy, _ = _track_direction_reference(
        next_pyramid, prev_pyramid, tracked[:, 0], tracked[:, 1],
        torch.ones(tracked.shape[0], dtype=torch.bool, device=tracked.device),
        levels if bwd_levels is None else bwd_levels, dims, wins, iterations,
        float(eps * eps))
    flow = tracked - points
    return torch.hypot(flow[:, 0] + bgx, flow[:, 1] + bgy)


# ---------------------------------------------------------------------------
# what a call needs: iterations, samples, FLOPs, bytes
# ---------------------------------------------------------------------------


