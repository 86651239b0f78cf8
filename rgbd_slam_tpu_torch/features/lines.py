"""Line segment detection (port of ``rgbd_slam_tpu/features/lines.py``).

The detector works on 16 px tiles, like the plane extractor one dimension down:

1. image gradients -> level-line orientation in the double-angle representation,
   so that edges of opposite polarity agree;
2. per-tile edge statistics: weighted centroid, second moments and orientation
   coherence (mean resultant length of the doubled angles);
3. directed mergeability edges between 8-adjacent coherent tiles (orientation
   and perpendicular-offset gates), and growth from the strongest seeds along
   them;
4. segments from the members' combined moments; endpoints from the projection
   extent along the principal direction.

Growth without host reads.  The JAX package grows each seed with a
``lax.while_loop``; here ``ops.line_grow_cuda.grow_seeds`` runs the seeds: on
the card one kernel searches the tile graph from each seed in turn, on the CPU
the plain version reads each seed's members off the graph's reach closure (or
grows it with a chunked loop when ``min_tiles > 2``).  Both give the same
member sets; every float after them is the same tensor code.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import profiling
from ..ops.image import gradients
from ..ops.line_grow_cuda import MAX_LINE_SEEDS, SHIFTS, _shifted, grow_seeds  # noqa: F401

MAX_LINES = 32
TILE = 16


class DetectedLines(NamedTuple):
    p0: torch.Tensor         # [MAX_LINES, 2] segment start (x, y) px
    p1: torch.Tensor         # [MAX_LINES, 2] segment end
    direction: torch.Tensor  # [MAX_LINES, 2] unit direction
    strength: torch.Tensor   # [MAX_LINES] accumulated gradient magnitude
    tile_count: torch.Tensor # [MAX_LINES] int32
    valid: torch.Tensor      # [MAX_LINES] bool


class _TileGrid(NamedTuple):
    weight: torch.Tensor     # [T] total gradient magnitude of edge pixels
    count: torch.Tensor      # [T] edge pixel count
    mean: torch.Tensor       # [T, 2] weighted centroid (x, y)
    m2: torch.Tensor         # [T, 2, 2] weighted centered second moment
    cos2: torch.Tensor       # [T] mean cos(2 theta) (magnitude-weighted)
    sin2: torch.Tensor       # [T] mean sin(2 theta)
    coherence: torch.Tensor  # [T] mean resultant length in [0, 1]
    is_line: torch.Tensor    # [T] bool


def _tile_stats(gray, mag_threshold: float, min_edge_frac: float, min_coherence: float):
    h, w = gray.shape
    gh, gw = h // TILE, w // TILE
    ix, iy = gradients(gray)
    mag = torch.sqrt(ix * ix + iy * iy)
    # level-line orientation: the edge runs perpendicular to the gradient;
    # doubled angle so theta and theta + pi agree
    theta = torch.atan2(iy, ix) + math.pi / 2.0
    c2 = torch.cos(2.0 * theta)
    s2 = torch.sin(2.0 * theta)
    wgt = torch.where(mag > mag_threshold, mag, torch.zeros_like(mag))

    ys = torch.arange(h, dtype=gray.dtype, device=gray.device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=gray.dtype, device=gray.device)[None, :].expand(h, w)

    def tiles_of(x):
        return x[: gh * TILE, : gw * TILE].reshape(gh, TILE, gw, TILE) \
            .permute(0, 2, 1, 3).reshape(gh * gw, TILE * TILE)

    tw, tx, ty = tiles_of(wgt), tiles_of(xs), tiles_of(ys)
    weight = tw.sum(dim=-1)
    count = (tw > 0).sum(dim=-1).to(torch.int32)
    safe_w = torch.clamp_min(weight, 1e-9)
    mean_x = (tw * tx).sum(dim=-1) / safe_w
    mean_y = (tw * ty).sum(dim=-1) / safe_w
    dx = tx - mean_x[:, None]
    dy = ty - mean_y[:, None]
    mxx, mxy, myy = (tw * dx * dx).sum(-1), (tw * dx * dy).sum(-1), (tw * dy * dy).sum(-1)
    m2 = torch.stack([torch.stack([mxx, mxy], -1), torch.stack([mxy, myy], -1)], dim=-2)
    mc2 = (tw * tiles_of(c2)).sum(dim=-1) / safe_w
    ms2 = (tw * tiles_of(s2)).sum(dim=-1) / safe_w
    coherence = torch.sqrt(mc2 * mc2 + ms2 * ms2)

    min_edges = int(TILE * TILE * min_edge_frac)
    is_line = (count >= min_edges) & (coherence > min_coherence)
    return _TileGrid(weight=weight, count=count, mean=torch.stack([mean_x, mean_y], -1),
                     m2=m2, cos2=mc2, sin2=ms2, coherence=coherence,
                     is_line=is_line), gh, gw


def _tile_direction(cos2, sin2):
    """Unit direction from the double-angle mean."""
    theta = 0.5 * torch.atan2(sin2, cos2)
    return torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)


def _line_edge_maps(grid: _TileGrid, gh: int, gw: int, max_angle_cos: float,
                    max_offset_px: float):
    """Directed mergeability between 8-adjacent line tiles, [8, gh, gw] bool:
    ``edges[s, y, x]`` says tile (y, x) may join from its neighbour at
    (y, x) - SHIFTS[s]: orientations agree (double-angle dot) and this tile's
    centroid lies near the neighbour's line."""
    d = _tile_direction(grid.cos2, grid.sin2).reshape(gh, gw, 2)
    # the double-angle vector's raw magnitude is the coherence; normalised so
    # that it does not scale the orientation-agreement dot product
    norm = torch.clamp_min(grid.coherence, 1e-9).reshape(gh, gw)
    c2 = grid.cos2.reshape(gh, gw) / norm
    s2 = grid.sin2.reshape(gh, gw) / norm
    cen = grid.mean.reshape(gh, gw, 2)
    ok = grid.is_line.reshape(gh, gw)

    edges = []
    for dy, dx in SHIFTS:
        df = _shifted(d, dy, dx)
        agree = (_shifted(c2, dy, dx) * c2 + _shifted(s2, dy, dx) * s2) > max_angle_cos
        rel = cen - _shifted(cen, dy, dx)
        perp = torch.abs(rel[..., 0] * (-df[..., 1]) + rel[..., 1] * df[..., 0])
        e = agree & (perp < max_offset_px) & ok & _shifted(ok, dy, dx)
        # no edge across the wrap-around of the shift
        if dx == 1:
            e[:, 0] = False
        if dx == -1:
            e[:, -1] = False
        if dy == 1:
            e[0, :] = False
        if dy == -1:
            e[-1, :] = False
        edges.append(e)
    return torch.stack(edges), SHIFTS


def detect_lines(gray, mag_threshold: float = 15.0, min_edge_frac: float = 0.06,
                 min_coherence: float = 0.7, min_tiles: int = 2) -> DetectedLines:
    """Detect up to MAX_LINES line segments in a gray image [H, W] float32."""
    dev = gray.device
    dt = gray.dtype
    grid, gh, gw = _tile_stats(gray, mag_threshold, min_edge_frac, min_coherence)
    # double-angle cos gate ~ 2x the angular tolerance (12.5 deg -> cos(25 deg))
    edges, _ = _line_edge_maps(grid, gh, gw, math.cos(math.radians(25.0)), max_offset_px=6.0)
    # the seeds in turn: each takes the heaviest available line tile and
    # consumes what it reaches (or itself alone when that is under min_tiles)
    active, proceed = grow_seeds(edges, grid.is_line, grid.weight, min_tiles)  # [S, T], [S]
    # the end of the step's section ``line_tiles``: gradients, tiles, the tile
    # graph and its search from the seeds (a stamp node under a recorded
    # capture, else nothing)
    profiling.stamp("line_tiles")
    n_tiles = active.sum(dim=-1).to(torch.int32)

    # combined weighted moments over each seed's member tiles (Chan combination)
    w = torch.where(active, grid.weight, torch.zeros_like(grid.weight))      # [S, T]
    tot = torch.clamp_min(w.sum(dim=-1), 1e-9)
    mean = (w[:, :, None] * grid.mean[None]).sum(dim=1) / tot[:, None]       # [S, 2]
    dev_ = grid.mean[None] - mean[:, None, :]                                # [S, T, 2]
    m2 = torch.where(active[:, :, None, None], grid.m2[None],
                     torch.zeros_like(grid.m2[None])).sum(dim=1) \
        + torch.einsum("st,sti,stj->sij", w, dev_, dev_)

    # principal direction of the 2x2 weighted scatter (closed form)
    ang = 0.5 * torch.atan2(2.0 * m2[:, 0, 1], m2[:, 0, 0] - m2[:, 1, 1])
    direction = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)        # [S, 2]

    # endpoints: projection extent of the member tiles' centroids (+ half a tile)
    proj = (dev_ * direction[:, None, :]).sum(dim=-1)
    inf = torch.full_like(proj, float("inf"))
    lo = torch.where(active, proj, inf).min(dim=-1).values - TILE / 2
    hi = torch.where(active, proj, -inf).max(dim=-1).values + TILE / 2
    p0 = mean + lo[:, None] * direction
    p1 = mean + hi[:, None] * direction

    # accepted seeds fill the output slots in order
    ok = proceed & (n_tiles >= min_tiles)
    slot = torch.cumsum(ok.to(torch.int64), dim=0) - ok.to(torch.int64)
    accept = ok & (slot < MAX_LINES)
    dest = torch.where(accept, slot, MAX_LINES)      # row MAX_LINES is a sink

    def place(values, dtype=dt):
        out = torch.zeros((MAX_LINES + 1,) + values.shape[1:], dtype=dtype, device=dev)
        out[dest] = values.to(dtype)
        return out[:MAX_LINES]

    return DetectedLines(p0=place(p0), p1=place(p1), direction=place(direction),
                         strength=place(tot), tile_count=place(n_tiles, torch.int32),
                         valid=torch.arange(MAX_LINES, device=dev) < accept.sum())
