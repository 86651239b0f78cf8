"""FAST-9/16 corner detection over the whole image (port of
``rgbd_slam_tpu/ops/fast.py``).

16 rolled copies of the image give the Bresenham circle, bit tricks find
9-contiguous arcs, then non-maximum suppression and per-cell top-K budgeting.
``lax.top_k`` breaks ties by the lower index; ``torch.topk`` promises no order,
so every top-K here is a stable descending sort (FAST scores tie often, and the
detection order decides map slot allocation).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .image import max_pool_same

# Bresenham circle of radius 3, 16 points, in (dy, dx) order starting at 12 o'clock
# going clockwise (OpenCV order).
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

ARC_LENGTH = 9  # FAST-9


def top_k(x, k: int):
    """(values, indices) of the ``k`` largest entries along the last axis; ties go
    to the lower index, as in ``jax.lax.top_k``."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _shifted_stack(img):
    """[16, H, W] stack of the circle-neighbor images (borders wrap; border
    responses are suppressed later)."""
    return torch.stack([torch.roll(img, shifts=(-dy, -dx), dims=(0, 1))
                        for dy, dx in CIRCLE_OFFSETS], dim=0)


def _pack_bits(bools):
    """[16, H, W] bool -> [H, W] int64 bitmask."""
    shifts = torch.arange(bools.shape[0], device=bools.device)[:, None, None]
    return torch.sum(bools.to(torch.int64) << shifts, dim=0)


def _arc9(bits):
    """True where the circular 16-bit mask holds a run of >= 9 contiguous set bits
    (doubling-AND run-length trick; int64, so shifts stay logical)."""
    x = bits | (bits << 16)
    y = x & (x >> 1)
    y = y & (y >> 2)
    y = y & (y >> 4)
    y = y & (x >> 8)
    return (y & 0xFFFF) != 0


def _interior_mask(h, w, device):
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (ys >= 3) & (ys < h - 3) & (xs >= 3) & (xs < w - 3)


def fast_response_2tier(img, threshold, low_threshold):
    """FAST-9/16 segment test + corner score at two thresholds sharing one
    circle-neighbor stack.  Returns (corner_hi, score_hi, corner_lo, score_lo)."""
    diff = _shifted_stack(img) - img[None]
    interior = _interior_mask(*img.shape, img.device)
    absdiff = torch.abs(diff)

    def tier(t):
        is_corner = (_arc9(_pack_bits(diff > t)) | _arc9(_pack_bits(diff < -t))) \
            & interior
        # sequential sum over the 16 neighbors, in circle order (XLA's order)
        score = torch.zeros_like(img)
        for k in range(diff.shape[0]):
            score = score + torch.clamp_min(absdiff[k] - t, 0.0)
        return is_corner, torch.where(is_corner, score, torch.zeros_like(score))

    hi_c, hi_s = tier(threshold)
    lo_c, lo_s = tier(low_threshold)
    return hi_c, hi_s, lo_c, lo_s


def fast_response(img, threshold):
    """FAST-9/16 segment test + corner score over the whole image.  Returns
    (is_corner [H, W] bool, score [H, W]): the score sums the absolute circle
    differences beyond the threshold."""
    c, s, _, _ = fast_response_2tier(img, threshold, threshold)
    return c, s


def _subpixel_refine(score, ys, xs):
    """Quadratic 1D fits on the score surface around each detected corner."""
    h, w = score.shape
    flat = score.reshape(-1)

    def at(y, x):
        return flat[y.clamp(0, h - 1) * w + x.clamp(0, w - 1)]

    c = at(ys, xs)
    left, right = at(ys, xs - 1), at(ys, xs + 1)
    up, down = at(ys - 1, xs), at(ys + 1, xs)
    dx = left - 2 * c + right
    dy = up - 2 * c + down
    one = torch.ones_like(dx)
    ox = torch.where(torch.abs(dx) > 1e-6,
                     0.5 * (left - right) / torch.where(torch.abs(dx) > 1e-6, dx, one),
                     torch.zeros_like(dx))
    oy = torch.where(torch.abs(dy) > 1e-6,
                     0.5 * (up - down) / torch.where(torch.abs(dy) > 1e-6, dy, one),
                     torch.zeros_like(dy))
    return (xs.to(score.dtype) + torch.clamp(ox, -0.5, 0.5),
            ys.to(score.dtype) + torch.clamp(oy, -0.5, 0.5))


def detect_fast_grid(img, detection_mask=None, threshold=20.0, low_threshold=10.0,
                     max_points: int = 100, cell_rows: int = 3, cell_cols: int = 3):
    """Grid-budgeted two-tier FAST detection.  ``detection_mask`` ([H, W] bool)
    disables detection where False.  Returns (xy [max_points, 2], score
    [max_points], valid [max_points] bool)."""
    is_corner, score, is_corner_low, score_low = fast_response_2tier(
        img, threshold, low_threshold)
    if detection_mask is not None:
        is_corner = is_corner & detection_mask
        is_corner_low = is_corner_low & detection_mask

    def nms(corner, sc):
        sc = torch.where(corner, sc, torch.zeros_like(sc))
        pooled = max_pool_same(sc, 3)
        return torch.where((sc >= pooled) & corner, sc, torch.zeros_like(sc))

    nms_hi = nms(is_corner, score)
    nms_lo = nms(is_corner_low, score_low)

    h, w = img.shape
    n_cells = cell_rows * cell_cols
    per_cell = -(-max_points // n_cells)
    ph = -(-h // cell_rows) * cell_rows
    pw = -(-w // cell_cols) * cell_cols
    ch, cw = ph // cell_rows, pw // cell_cols

    def cells_of(x):
        xp = F.pad(x, (0, pw - w, 0, ph - h))
        return xp.reshape(cell_rows, ch, cell_cols, cw).permute(0, 2, 1, 3) \
            .reshape(n_cells, ch * cw)

    hi_cells = cells_of(nms_hi)
    lo_cells = cells_of(nms_lo)

    # the sensitive tier only in cells where the high tier found fewer than the
    # cell budget
    hi_counts = torch.sum(hi_cells > 0, dim=-1)
    use_low = (hi_counts < per_cell)[:, None]
    merged = torch.where(hi_cells > 0, hi_cells,
                         torch.where(use_low, lo_cells, torch.zeros_like(lo_cells)))

    cell_vals, cell_idx = top_k(merged, per_cell)
    top_scores, top_pos = top_k(cell_vals.reshape(-1), max_points)
    cell_of_top = top_pos // per_cell
    within = cell_idx.reshape(-1)[top_pos]
    valid = top_scores > 0

    ys_sel = (cell_of_top // cell_cols) * ch + within // cw
    xs_sel = (cell_of_top % cell_cols) * cw + within % cw
    refine_img = torch.where(score > 0, score, score_low)
    x_ref, y_ref = _subpixel_refine(refine_img, ys_sel, xs_sel)
    xy = torch.stack([x_ref, y_ref], dim=-1)
    xy = torch.where(valid[:, None], xy, torch.zeros_like(xy))
    return xy, torch.where(valid, top_scores, torch.zeros_like(top_scores)), valid


def tracked_points_mask(shape, tracked_xy, tracked_valid, radius: float = 15.0):
    """[H, W] bool detection mask, False in a square of half-size ``radius`` px
    around each valid tracked point."""
    h, w = shape
    xi = torch.round(tracked_xy[:, 0]).to(torch.int64).clamp(0, w - 1)
    yi = torch.round(tracked_xy[:, 1]).to(torch.int64).clamp(0, h - 1)
    # invalid points land in a sink element past the image
    seeds = torch.zeros((h * w + 1,), dtype=torch.float32, device=tracked_xy.device)
    seeds.index_fill_(0, torch.where(tracked_valid, yi * w + xi, h * w), 1.0)
    k = 2 * int(radius) + 1
    dil = F.max_pool2d(seeds[:h * w].reshape(1, 1, h, w), (k, 1), stride=1,
                       padding=(k // 2, 0))
    dil = F.max_pool2d(dil, (1, k), stride=1, padding=(0, k // 2))
    return dil[0, 0] < 0.5
