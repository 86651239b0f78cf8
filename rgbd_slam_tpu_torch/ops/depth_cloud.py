"""Depth image -> organized camera-space point cloud (port of ``depth_to_cloud``
in ``rgbd_slam_tpu/ops/depth_cloud.py``)."""

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
