"""Pinhole projections (port of ``rgbd_slam_tpu/geometry/pinhole.py``).

Screen coordinates are ``[u px, v px, depth mm]``, camera coordinates mm in the
optical frame, world coordinates mm in the physical frame.  Points have shape
``[..., 3]``; a 4x4 transform broadcasts against the leading axes of the points,
so a batch of poses needs ``m44[..., None, :, :]`` against ``[..., N, 3]`` points.
"""

from __future__ import annotations

import torch

from ..config import CameraIntrinsics


def is_depth_valid(depth_mm, min_depth=40.0, max_depth=6000.0):
    """Valid measured-depth gate."""
    return (depth_mm > min_depth) & (depth_mm <= max_depth)


def screen_to_camera(screen, cam: CameraIntrinsics):
    """[u, v, z_mm] -> camera-space mm point."""
    u, v, z = screen[..., 0], screen[..., 1], screen[..., 2]
    x = (u - cam.cx) / cam.fx * z
    y = (v - cam.cy) / cam.fy * z
    return torch.stack([x, y, z], dim=-1)


def camera_to_screen(pt_cam, cam: CameraIntrinsics):
    """camera mm point -> [u, v, z_mm]; z==0 is guarded with a tiny epsilon."""
    x, y, z = pt_cam[..., 0], pt_cam[..., 1], pt_cam[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = cam.fx * x / safe_z + cam.cx
    v = cam.fy * y / safe_z + cam.cy
    return torch.stack([u, v, z], dim=-1)


def apply_transform(m44, pts):
    """Apply a homogeneous 4x4 to [..., 3] points."""
    return (m44[..., :3, :3] @ pts[..., None])[..., 0] + m44[..., :3, 3]


def camera_to_world_point(pt_cam, c2w):
    return apply_transform(c2w, pt_cam)


def world_to_camera_point(pt_world, w2c):
    return apply_transform(w2c, pt_world)


def screen_to_world(screen, c2w, cam: CameraIntrinsics):
    return camera_to_world_point(screen_to_camera(screen, cam), c2w)


def world_to_screen(pt_world, w2c, cam: CameraIntrinsics):
    """World point -> screen [u,v,z]; also returns a validity mask (z>0, finite)."""
    pt_cam = world_to_camera_point(pt_world, w2c)
    screen = camera_to_screen(pt_cam, cam)
    valid = (pt_cam[..., 2] > 0) & torch.all(torch.isfinite(screen), dim=-1)
    return screen, valid


def is_in_screen_boundaries(screen, cam: CameraIntrinsics):
    u, v = screen[..., 0], screen[..., 1]
    ok = (u >= 0) & (u <= cam.width) & (v >= 0) & (v <= cam.height)
    if screen.shape[-1] >= 3:
        ok = ok & (screen[..., 2] > 0)
    return ok


def signed_screen_distance_2d(world_pt, screen_obs_uv, w2c, cam: CameraIntrinsics, big=1e10):
    """Signed px reprojection error of a world point against a 2D screen
    observation; invalid projections map to ``big``."""
    proj, valid = world_to_screen(world_pt, w2c, cam)
    d = screen_obs_uv[..., :2] - proj[..., :2]
    return torch.where(valid[..., None], d, torch.full_like(d, big))


def screen_distance_px(world_pt, screen_obs_uv, w2c, cam: CameraIntrinsics, big=1e10):
    """L1 reprojection distance in px."""
    return torch.sum(torch.abs(
        signed_screen_distance_2d(world_pt, screen_obs_uv, w2c, cam, big)), dim=-1)
