"""Debug image rendering (port of ``rgbd_slam_tpu/io/debug_image.py``): header
band with FPS and per-map staged/local counts, per-feature overlays (staged vs
local colors, optical-flow tracked markers), projected plane polygons, and a red
tint on lost-tracking frames.

Host-side: what the image needs of the state comes from the device in one copy,
and the projections run on those host copies.  Returns an RGB uint8 image.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import CameraIntrinsics
from ..geometry import pinhole, se3
from ..mapping import maps as maps_mod
from .map_writer import fetch

STAGED_COLOR = (80, 180, 255)   # staged features: orange-ish (BGR-free RGB)
LOCAL_COLOR = (80, 255, 120)    # local features: green
TRACKED_COLOR = (255, 230, 60)  # optical-flow tracked: yellow
PLANE_COLOR = (255, 120, 200)
CYLINDER_COLOR = (120, 200, 255)  # detected cylinder cells: light blue tint


def _draw_square(img, x, y, half, color):
    h, w = img.shape[:2]
    x0, x1 = max(int(x - half), 0), min(int(x + half) + 1, w)
    y0, y1 = max(int(y - half), 0), min(int(y + half) + 1, h)
    if x0 < x1 and y0 < y1:
        img[y0:y1, x0] = color
        img[y0:y1, x1 - 1] = color
        img[y0, x0:x1] = color
        img[y1 - 1, x0:x1] = color


def _draw_line(img, p0, p1, color):
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]))) + 1
    ts = np.linspace(0.0, 1.0, n)
    xs = np.clip(np.round(p0[0] + ts * (p1[0] - p0[0])).astype(int), 0,
                 img.shape[1] - 1)
    ys = np.clip(np.round(p0[1] + ts * (p1[1] - p0[1])).astype(int), 0,
                 img.shape[0] - 1)
    img[ys, xs] = color


def render_debug_image(gray, state, cam: CameraIntrinsics,
                       fps: float = 0.0, is_lost: bool = False,
                       cylinder_cells=None,
                       patch_size: int = 20) -> np.ndarray:
    """Render the current frame with map overlays.  ``cylinder_cells`` is the
    StepOutput's [C] union mask of detected cylinder inlier cells, which are
    tinted."""
    g = gray.detach().cpu().numpy() if isinstance(gray, torch.Tensor) else np.asarray(gray)
    img = np.clip(g, 0, 255).astype(np.uint8)
    rgb = np.stack([img, img, img], axis=-1)

    pts, pl = state.points, state.planes
    no_cells = torch.zeros(0, dtype=torch.bool, device=pts.pos.device)
    (quat, position, alive, pos, is_local, t_ok, t_uv, alive_p, counts, poly_verts,
     centers, us, vs, cells) = fetch(
        state.quat, state.position, maps_mod.alive(pts), pts.pos, pts.is_local,
        state.tracked_ok, state.tracked_uv, maps_mod.alive(pl), pl.poly_count,
        pl.poly_verts, pl.basis_center, pl.basis_u, pl.basis_v,
        no_cells if cylinder_cells is None else cylinder_cells)

    # cylinder cells: tint the 20x20 cells claimed by cylinder sub-segments
    gw = cam.width // patch_size
    for ci in np.nonzero(cells)[0]:
        cy, cx = (ci // gw) * patch_size, (ci % gw) * patch_size
        patch = rgb[cy:cy + patch_size, cx:cx + patch_size].astype(np.int32)
        rgb[cy:cy + patch_size, cx:cx + patch_size] = np.minimum(
            255, (patch * 2 + np.asarray(CYLINDER_COLOR)) // 3
        ).astype(np.uint8)

    w2c = se3.world_to_camera(torch.from_numpy(quat), torch.from_numpy(position))

    def to_screen(points):
        scr, ok = pinhole.world_to_screen(torch.from_numpy(points), w2c, cam)
        return scr.numpy(), ok.numpy()

    # 3D map points: project, color by staged/local
    proj, ok = to_screen(pos)
    ok = ok & alive
    for i in np.nonzero(ok)[0]:
        x, y = proj[i, 0], proj[i, 1]
        if 0 <= x < cam.width and 0 <= y < cam.height:
            _draw_square(rgb, x, y, 3,
                         LOCAL_COLOR if is_local[i] else STAGED_COLOR)

    # optical-flow tracked positions
    for i in np.nonzero(t_ok)[0]:
        _draw_square(rgb, t_uv[i, 0], t_uv[i, 1], 1, TRACKED_COLOR)

    # plane polygons: project world polygon vertices to screen and draw edges
    for i in np.nonzero(alive_p)[0]:
        cnt = int(counts[i])
        if cnt < 3:
            continue
        verts2 = poly_verts[i][:cnt]
        verts3 = centers[i] + verts2[:, 0:1] * us[i] + verts2[:, 1:2] * vs[i]
        scr, okv = to_screen(verts3)
        for k in range(cnt):
            k2 = (k + 1) % cnt
            if okv[k] and okv[k2]:
                _draw_line(rgb, scr[k, :2], scr[k2, :2], PLANE_COLOR)

    # red tint on lost frames
    if is_lost:
        rgb[..., 0] = np.minimum(255, rgb[..., 0].astype(np.int32) + 80)

    # header band: FPS + per-map counts
    n_local = int((alive & is_local).sum())
    n_staged = int((alive & ~is_local).sum())
    n_planes = int(alive_p.sum())
    band_h = 18
    rgb[:band_h] = (40, 40, 40)
    _draw_header_text(
        rgb, f"fps {fps:5.1f} | pts {n_local}L/{n_staged}S | planes {n_planes}"
             + (" | LOST" if is_lost else ""))
    return rgb


_FONT = {  # minimal 3x5 digit/letter raster font for the header band
    "0": ["111", "101", "101", "101", "111"], "1": ["010", "110", "010", "010", "111"],
    "2": ["111", "001", "111", "100", "111"], "3": ["111", "001", "111", "001", "111"],
    "4": ["101", "101", "111", "001", "001"], "5": ["111", "100", "111", "001", "111"],
    "6": ["111", "100", "111", "101", "111"], "7": ["111", "001", "010", "010", "010"],
    "8": ["111", "101", "111", "101", "111"], "9": ["111", "101", "111", "001", "111"],
    ".": ["000", "000", "000", "000", "010"], " ": ["000", "000", "000", "000", "000"],
    "|": ["010", "010", "010", "010", "010"], "/": ["001", "001", "010", "100", "100"],
    "f": ["011", "010", "111", "010", "010"], "p": ["110", "101", "110", "100", "100"],
    "s": ["011", "100", "010", "001", "110"], "t": ["010", "111", "010", "010", "011"],
    "l": ["100", "100", "100", "100", "111"], "a": ["010", "101", "111", "101", "101"],
    "n": ["110", "101", "101", "101", "101"], "e": ["111", "100", "110", "100", "111"],
    "L": ["100", "100", "100", "100", "111"], "S": ["011", "100", "010", "001", "110"],
    "O": ["111", "101", "101", "101", "111"], "T": ["111", "010", "010", "010", "010"],
}


def _draw_header_text(img, text, x0=4, y0=5, color=(230, 230, 230)):
    x = x0
    for ch in text:
        glyph = _FONT.get(ch, _FONT[" "])
        for r, row in enumerate(glyph):
            for c, bit in enumerate(row):
                if bit == "1" and y0 + r < img.shape[0] and x + c < img.shape[1]:
                    img[y0 + r, x + c] = color
        x += 4
