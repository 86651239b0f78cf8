"""Depth image -> organized camera-space point cloud, its reorganization by cells
and the depth map's rectification into the RGB camera (port of
``rgbd_slam_tpu/ops/depth_cloud.py``)."""

from __future__ import annotations

import torch

from ..config import CameraIntrinsics


def depth_to_cloud(depth_mm, cam: CameraIntrinsics, min_depth: float = 40.0,
                   max_depth: float = 6000.0):
    """[H, W] depth (mm) -> ([H, W, 3] camera-space cloud in mm, [H, W] valid
    mask).  Invalid depths give zero points."""
    h, w = depth_mm.shape
    dt = depth_mm.dtype
    xs = torch.arange(w, dtype=dt, device=depth_mm.device)[None, :]
    ys = torch.arange(h, dtype=dt, device=depth_mm.device)[:, None]
    valid = (depth_mm > min_depth) & (depth_mm <= max_depth)
    z = torch.where(valid, depth_mm, torch.zeros_like(depth_mm))
    x_pre = (xs - cam.cx) / cam.fx
    y_pre = (ys - cam.cy) / cam.fy
    return torch.stack([x_pre * z, y_pre * z, z], dim=-1), valid


def organize_by_cells(arr, patch: int = 20):
    """[H, W, C] -> [n_cells, patch*patch, C] with each ``patch x patch`` cell
    contiguous.  H and W must be divisible by ``patch`` (640x480 / 20 -> 32x24 =
    768 cells)."""
    h, w = arr.shape[:2]
    c = arr.shape[2] if arr.ndim == 3 else 1
    gh, gw = h // patch, w // patch
    x = arr.reshape(gh, patch, gw, patch, c).permute(0, 2, 1, 3, 4)
    return x.reshape(gh * gw, patch * patch, c)


def rectify_depth(depth_mm, depth_cam: CameraIntrinsics, rgb_cam: CameraIntrinsics,
                  depth_to_rgb_44):
    """Reproject the depth map from the depth camera into the RGB camera's
    frame: a forward warp by scatter that keeps the nearest depth per target
    pixel.  Target pixels that no source pixel reaches are 0 (holes).

    The pixel index is the projected coordinate plus one half, truncated toward
    zero as the JAX package's cast does, and tested for the image after the
    cast.  The scatter is a minimum, which has no order: the result is the same
    from run to run."""
    h, w = depth_mm.shape
    dt = depth_mm.dtype
    dev = depth_mm.device
    cloud, valid = depth_to_cloud(depth_mm, depth_cam)
    m = torch.as_tensor(depth_to_rgb_44, dtype=dt, device=dev)
    pts = torch.einsum("ij,hwj->hwi", m[:3, :3], cloud) + m[:3, 3]
    z = torch.clamp_min(pts[..., 2], 1e-6)
    u = (rgb_cam.fx * pts[..., 0] / z + rgb_cam.cx + 0.5).to(torch.int32)
    v = (rgb_cam.fy * pts[..., 1] / z + rgb_cam.cy + 0.5).to(torch.int32)
    ok = valid & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    # invalid pixels all write infinity to index 0, which changes nothing
    flat_idx = torch.where(ok, v * w + u, torch.zeros_like(u)).reshape(-1).to(torch.int64)
    big = torch.full((), float("inf"), dtype=dt, device=dev)
    src = torch.where(ok, pts[..., 2], big).reshape(-1)
    out = torch.full((h * w,), float("inf"), dtype=dt, device=dev)
    out = out.scatter_reduce(0, flat_idx, src, "amin", include_self=True)
    out = torch.where(torch.isinf(out), torch.zeros_like(out), out)
    return out.reshape(h, w)
