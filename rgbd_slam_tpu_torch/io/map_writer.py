"""Streaming map export: .xyz, .pcd, .obj writers (port of
``rgbd_slam_tpu/io/map_writer.py``).

Features are appended when they die or at shutdown; the OBJ writer is what the
local map uses.  The writers are host-side file IO.  The functions that read a
``StepOutput`` or a ``SlamState`` of tensors bring what they write to the host
in one copy per call (:func:`fetch`), not one per field.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import inverse_depth as idp
from ..mapping import maps as maps_mod


class MapWriter:
    """Interface parity: add_point / add_line / add_polygon
    (map_writer.hpp:12-33)."""

    def __init__(self, filename: str):
        self._file = open(filename, "w")
        self._write_header()

    def _write_header(self):
        pass

    def add_point(self, point):
        raise NotImplementedError

    def add_line(self, points):
        raise NotImplementedError

    def add_polygon(self, points, normal):
        raise NotImplementedError

    def close(self):
        if not self._file.closed:
            self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class XYZWriter(MapWriter):
    """Points only (XYZ_Map_Writer, map_writer.cpp)."""

    def add_point(self, point):
        p = np.asarray(point)
        self._file.write(f"{p[0]} {p[1]} {p[2]}\n")

    def add_line(self, points):
        for p in points:
            self.add_point(p)

    def add_polygon(self, points, normal):
        for p in points:
            self.add_point(p)


class PCDWriter(MapWriter):
    """Point Cloud Data format with a patched-up header on close
    (PCD_Map_Writer)."""

    def _write_header(self):
        self._count = 0
        self._points = []

    def add_point(self, point):
        p = np.asarray(point)
        self._points.append(p)
        self._count += 1

    def add_line(self, points):
        for p in points:
            self.add_point(p)

    def add_polygon(self, points, normal):
        for p in points:
            self.add_point(p)

    def close(self):
        if self._file.closed:
            return
        n = self._count
        self._file.write(
            "# .PCD v.7 - Point Cloud Data file format\nVERSION .7\n"
            "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
            f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
            f"POINTS {n}\nDATA ascii\n")
        for p in self._points:
            self._file.write(f"{p[0]} {p[1]} {p[2]}\n")
        self._file.close()


class OBJWriter(MapWriter):
    """Wavefront OBJ with points, polylines and polygons with normals
    (OBJ_Map_Writer, map_writer.cpp — what Local_Map exports as out.obj)."""

    def _write_header(self):
        self._vertex_index = 1
        self._normal_index = 1

    def add_point(self, point):
        p = np.asarray(point)
        self._file.write(f"v {p[0]} {p[1]} {p[2]}\n")
        self._file.write(f"p {self._vertex_index}\n")
        self._vertex_index += 1

    def add_line(self, points):
        start = self._vertex_index
        for p in points:
            self._file.write(f"v {p[0]} {p[1]} {p[2]}\n")
            self._vertex_index += 1
        idxs = " ".join(str(i) for i in range(start, self._vertex_index))
        self._file.write(f"l {idxs}\n")

    def add_polygon(self, points, normal):
        n = np.asarray(normal)
        self._file.write(f"vn {n[0]} {n[1]} {n[2]}\n")
        start = self._vertex_index
        for p in points:
            self._file.write(f"v {p[0]} {p[1]} {p[2]}\n")
            self._vertex_index += 1
        idxs = " ".join(f"{i}//{self._normal_index}"
                        for i in range(start, self._vertex_index))
        self._file.write(f"f {idxs}\n")
        self._normal_index += 1


def fetch(*tensors):
    """The tensors as numpy arrays of their own shapes and kinds (bool, integer
    or float32), read from the device in one copy: they travel as one float32
    buffer.  Integers must be exact in float32 (counts, below 2^24)."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors]).cpu().numpy()
    out, offset = [], 0
    for t in tensors:
        a = flat[offset:offset + t.numel()].reshape(tuple(t.shape))
        offset += t.numel()
        if t.dtype == torch.bool:
            a = a > 0.5
        elif not t.dtype.is_floating_point:
            a = a.astype(np.int64)
        out.append(a)
    return out


def _add_polygons(writer, mask, counts, verts, centers, us, vs, params) -> int:
    n = 0
    for i in np.nonzero(mask)[0]:
        cnt = int(counts[i])
        if cnt < 3:
            continue
        v2 = verts[i][:cnt]
        v3 = centers[i] + v2[:, 0:1] * us[i] + v2[:, 1:2] * vs[i]
        writer.add_polygon(v3, params[i][:3])
        n += 1
    return n


def _add_lines(writer, mask, eps) -> int:
    idx = np.nonzero(mask)[0]
    for i in idx:
        writer.add_line(np.stack([eps[i, :3], eps[i, 3:]]))
    return len(idx)


def append_dying_features(writer: MapWriter, out) -> int:
    """Append one frame's dying LOCAL features to an open writer: every lost
    local feature reaches the map file at death, so the final export is the
    union of everything ever mapped.  ``out`` is an ``engine.StepOutput``;
    returns the number of features written."""
    (pm, ppos, qm, qpos, km, verts, counts, centers, us, vs, params, lm, eps) = fetch(
        out.point_evicted, out.point_evict_pos, out.point2d_evicted, out.point2d_evict_pos,
        out.plane_evicted, out.plane_evict_verts, out.plane_evict_count,
        out.plane_evict_center, out.plane_evict_u, out.plane_evict_v,
        out.plane_evict_params, out.line_evicted, out.line_evict_eps)
    n = 0
    for p in ppos[pm]:
        writer.add_point(p)
        n += 1
    for p in qpos[qm]:
        writer.add_point(p)
        n += 1
    n += _add_polygons(writer, km, counts, verts, centers, us, vs, params)
    n += _add_lines(writer, lm, eps)
    return n


def append_alive_features(writer: MapWriter, state, only_local: bool = True) -> int:
    """Append the currently alive map features to an open writer: the shutdown
    half of the streaming export, which writes the surviving LOCAL map
    (``only_local``) or every alive feature.  Returns the number of features
    written."""
    def sel(m):
        alive = maps_mod.alive(m)
        return alive & m.is_local if only_local else alive

    pts, p2, ln, pl = state.points, state.points2d, state.lines, state.planes
    (m3, pos3, m2, pos2, ml, eps, mp, counts, verts, centers, us, vs, params) = fetch(
        sel(pts), pts.pos, sel(p2), idp.to_world(p2.state), sel(ln), ln.endpoints,
        sel(pl), pl.poly_count, pl.poly_verts, pl.basis_center, pl.basis_u, pl.basis_v,
        pl.params)
    for p in pos3[m3]:
        writer.add_point(p)
    for p in pos2[m2]:
        writer.add_point(p)
    return (int(m3.sum()) + int(m2.sum()) + _add_lines(writer, ml, eps)
            + _add_polygons(writer, mp, counts, verts, centers, us, vs, params))


def export_slam_map(state, path: str):
    """Write the current map state (every alive feature) to an OBJ file, as the
    shutdown export does."""
    with OBJWriter(path) as w:
        append_alive_features(w, state, only_local=False)
