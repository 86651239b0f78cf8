"""Synthetic RGB-D scenes and trajectories: the benchmark's frames.

A frozen copy of ``rgbd_slam_tpu_torch/synthetic.py`` (commit 01a0d89, pure
numpy), with ``AXIS_CORRECTION`` copied from ``geometry/se3.py`` beside it, so
that the traffic depends on nothing the program may change.  ``cam`` is any
object with the fields of ``config.CameraIntrinsics``.  The scenes are analytic,
with exact ground-truth poses.
"""

from __future__ import annotations

import numpy as np

#: world (x forward, y left, z up) from the camera's axes (x right, y down, z
#: forward): ``rgbd_slam_tpu_torch/geometry/se3.py``'s constant
AXIS_CORRECTION = np.array(
    [[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]]
)


def _c2w_numpy(quat, position):
    """Host-side camera->world matrix (pure numpy: the renderer never touches the
    device)."""
    w, x, y, z = [float(v) for v in quat]
    r = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    m = np.eye(4)
    m[:3, :3] = AXIS_CORRECTION @ r
    m[:3, 3] = AXIS_CORRECTION @ np.asarray(position, dtype=np.float64)
    return m


class WallScene:
    """Textured wall at world x = wall_x (world x is forward)."""

    def __init__(self, cam, wall_x: float = 2800.0,
                 block_mm: float = 60.0, seed: int = 0):
        self.cam = cam
        self.wall_x = wall_x
        self.block = block_mm
        self._grid = np.random.default_rng(seed).uniform(
            40, 220, (256, 256)).astype(np.float32)

    def texture(self, y, z):
        yi = np.floor(y / self.block).astype(int) % 256
        zi = np.floor(z / self.block).astype(int) % 256
        return (self._grid[yi, zi]
                + 15 * np.sin(y / 140.0) + 10 * np.cos(z / 170.0))

    def render(self, quat, position):
        """Returns (gray [H,W] f32, depth_mm [H,W] f32)."""
        cam = self.cam
        c2w = _c2w_numpy(quat, position)
        origin, rot = c2w[:3, 3], c2w[:3, :3]
        us, vs = np.meshgrid(np.arange(cam.width), np.arange(cam.height))
        d = np.stack([(us - cam.cx) / cam.fx, (vs - cam.cy) / cam.fy,
                      np.ones_like(us, dtype=np.float64)], -1)
        dw = d @ rot.T
        t = (self.wall_x - origin[0]) / dw[..., 0]
        w = origin + t[..., None] * dw
        gray = self.texture(w[..., 1], w[..., 2]).astype(np.float32)
        return gray, t.astype(np.float32)


class StripeWallScene(WallScene):
    """Wall with bold straight stripes: strong line structure, weak corner
    texture.  Exercises the line-feature pose path (north-star config 2 —
    'points+lines pose'); the stripe edges are the only high-contrast structure,
    so a points-only run sees far fewer features than a points+lines run."""

    def __init__(self, cam, wall_x: float = 2800.0,
                 stripe_period: float = 500.0, stripe_width: float = 80.0,
                 texture_scale: float = 0.12, seed: int = 0,
                 stripe_period_z: float | None = None):
        super().__init__(cam, wall_x=wall_x, seed=seed)
        self.period = stripe_period
        self.period_z = stripe_period if stripe_period_z is None \
            else stripe_period_z
        self.width = stripe_width
        self.texture_scale = texture_scale

    def texture(self, y, z):
        base = (130.0 + 8.0 * np.sin(y / 900.0) + 6.0 * np.cos(z / 1100.0)
                + self._grid[np.floor(y / self.block).astype(int) % 256,
                             np.floor(z / self.block).astype(int) % 256]
                * self.texture_scale)
        sy = (np.mod(y, self.period) < self.width)
        sz = (np.mod(z, self.period_z) < self.width)
        return base - 70.0 * sy - 50.0 * sz


class TunnelScene:
    """Camera inside a textured cylindrical tunnel whose axis is world x
    (forward) — the CAPE-tunnel analogue (reference README.md:90-100)."""

    def __init__(self, cam, radius_mm: float = 1500.0,
                 center_yz=(0.0, 0.0), block_mm: float = 80.0, seed: int = 2):
        self.cam = cam
        self.r = radius_mm
        self.cy, self.cz = center_yz
        self.block = block_mm
        self._grid = np.random.default_rng(seed).uniform(
            40, 220, (256, 256)).astype(np.float32)

    def texture(self, x, ang):
        xi = np.floor(x / self.block).astype(int) % 256
        ai = np.floor(ang / (2 * np.pi) * 160).astype(int) % 256
        return (self._grid[xi, ai]
                + 12 * np.sin(x / 180.0) + 8 * np.cos(3.0 * ang))

    def render(self, quat, position):
        cam = self.cam
        c2w = _c2w_numpy(quat, position)
        origin, rot = c2w[:3, 3], c2w[:3, :3]
        us, vs = np.meshgrid(np.arange(cam.width), np.arange(cam.height))
        d = np.stack([(us - cam.cx) / cam.fx, (vs - cam.cy) / cam.fy,
                      np.ones_like(us, dtype=np.float64)], -1)
        dw = d @ rot.T
        # |(o + t d) - c|^2 = r^2 in the world (y, z) plane
        oy, oz = origin[1] - self.cy, origin[2] - self.cz
        a = dw[..., 1] ** 2 + dw[..., 2] ** 2
        b = 2.0 * (oy * dw[..., 1] + oz * dw[..., 2])
        c = oy * oy + oz * oz - self.r * self.r
        disc = np.maximum(b * b - 4 * a * c, 0.0)
        a_safe = np.where(np.abs(a) < 1e-12, 1e-12, a)
        t = (-b + np.sqrt(disc)) / (2 * a_safe)
        t = np.where((np.abs(a) < 1e-12) | (t <= 100.0), 0.0, t)
        w = origin + t[..., None] * dw
        ang = np.arctan2(w[..., 2] - self.cz, w[..., 1] - self.cy)
        gray = self.texture(w[..., 0], ang).astype(np.float32)
        return np.where(t > 0, gray, 0.0).astype(np.float32), \
            t.astype(np.float32)


class RoomScene:
    """Three mutually orthogonal textured planes (front wall, side wall, floor)
    — a structured scene for full-trajectory ATE benchmarks with rotation."""

    def __init__(self, cam, front_x: float = 3000.0,
                 side_y: float = 1800.0, floor_z: float = -1200.0,
                 block_mm: float = 60.0, seed: int = 1,
                 depth_noise=None):
        self.cam = cam
        self.front_x, self.side_y, self.floor_z = front_x, side_y, floor_z
        self.block = block_mm
        self._grids = [np.random.default_rng(seed + i).uniform(
            40, 220, (256, 256)).astype(np.float32) for i in range(3)]
        self.depth_noise = depth_noise  # optional DepthNoiseModel
        self._noise_rng = np.random.default_rng(seed + 99)

    def _tex(self, i, a, b):
        ai = np.floor(a / self.block).astype(int) % 256
        bi = np.floor(b / self.block).astype(int) % 256
        return (self._grids[i][ai, bi]
                + 14 * np.sin(a / 150.0) + 9 * np.cos(b / 130.0))

    def render(self, quat, position):
        cam = self.cam
        c2w = _c2w_numpy(quat, position)
        origin, rot = c2w[:3, 3], c2w[:3, :3]
        us, vs = np.meshgrid(np.arange(cam.width), np.arange(cam.height))
        d = np.stack([(us - cam.cx) / cam.fx, (vs - cam.cy) / cam.fy,
                      np.ones_like(us, dtype=np.float64)], -1)
        dw = d @ rot.T

        def hit(axis, value):
            dirc = dw[..., axis]
            t = (value - origin[axis]) / np.where(np.abs(dirc) < 1e-12,
                                                  1e-12, dirc)
            return np.where((np.abs(dirc) < 1e-12) | (t <= 100.0), np.inf, t)

        t0 = hit(0, self.front_x)
        t1 = hit(1, self.side_y)
        t2 = hit(2, self.floor_z)
        ts = np.stack([t0, t1, t2])
        best = np.argmin(ts, axis=0)
        t = np.take_along_axis(ts, best[None], axis=0)[0]
        w = origin + t[..., None] * dw
        gray = np.where(
            best == 0, self._tex(0, w[..., 1], w[..., 2]),
            np.where(best == 1, self._tex(1, w[..., 0], w[..., 2]),
                     self._tex(2, w[..., 0], w[..., 1]))).astype(np.float32)
        depth = np.where(np.isfinite(t), t, 0.0).astype(np.float32)
        if self.depth_noise is not None:
            q = (self.depth_noise.quadratic * depth * depth
                 + self.depth_noise.linear * depth + self.depth_noise.constant)
            sigma = np.maximum(q, self.depth_noise.floor_mm)
            depth = np.where(
                depth > 0,
                depth + sigma * self._noise_rng.standard_normal(depth.shape)
                .astype(np.float32), 0.0).astype(np.float32)
        return gray, depth


class HardRoomScene(RoomScene):
    """RoomScene hardened with real-sensor pathologies (VERDICT r3 weak #4):

    * **depth holes** — per-frame random elliptical dropout blobs (depth=0),
      the failure mode of IR-absorbing / specular surfaces;
    * **noise bursts** — every ``burst_every``-th frame multiplies the Kinect
      depth-noise sigma by ``burst_scale`` (interference / exposure flicker);
    * **occluding foreground object** — a textured sphere hanging in front of
      the wall: rays hitting it see its surface instead, its rim creates
      depth discontinuities, and points detected on it occlude map features;
    * **texture-poor stretch** — a band of the front wall with contrast
      crushed to ~6%, starving the corner detector as the camera pans
      across it.
    """

    def __init__(self, cam, hole_count: int = 6,
                 hole_radius_px: float = 28.0, burst_every: int = 17,
                 burst_scale: float = 4.0,
                 occluder_center=(2200.0, 300.0, -100.0),
                 occluder_radius: float = 260.0,
                 weak_band_y=(-900.0, -200.0), **kw):
        kw.setdefault("depth_noise", None)
        super().__init__(cam, **kw)
        self.hole_count = hole_count
        self.hole_radius_px = hole_radius_px
        self.burst_every = burst_every
        self.burst_scale = burst_scale
        self.occ_c = np.asarray(occluder_center, np.float64)
        self.occ_r = occluder_radius
        self.weak_y = weak_band_y
        self._frame = 0

    def render(self, quat, position):
        cam = self.cam
        c2w = _c2w_numpy(quat, position)
        origin, rot = c2w[:3, 3], c2w[:3, :3]
        us, vs = np.meshgrid(np.arange(cam.width), np.arange(cam.height))
        d = np.stack([(us - cam.cx) / cam.fx, (vs - cam.cy) / cam.fy,
                      np.ones_like(us, dtype=np.float64)], -1)
        dw = d @ rot.T

        def hit(axis, value):
            dirc = dw[..., axis]
            t = (value - origin[axis]) / np.where(np.abs(dirc) < 1e-12,
                                                  1e-12, dirc)
            return np.where((np.abs(dirc) < 1e-12) | (t <= 100.0), np.inf, t)

        ts = np.stack([hit(0, self.front_x), hit(1, self.side_y),
                       hit(2, self.floor_z)])
        best = np.argmin(ts, axis=0)
        t = np.take_along_axis(ts, best[None], axis=0)[0]

        # occluding sphere: |o + s d - c|^2 = r^2, nearest positive root
        oc = origin - self.occ_c
        b = 2.0 * np.sum(dw * oc, axis=-1)
        cc = float(oc @ oc) - self.occ_r ** 2
        disc = b * b - 4.0 * cc
        s = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0.0))) / 2.0,
                     np.inf)
        s = np.where(s > 100.0, s, np.inf)
        occ = s < t
        t = np.where(occ, s, t)

        w = origin + t[..., None] * dw
        gray = np.where(
            best == 0, self._tex(0, w[..., 1], w[..., 2]),
            np.where(best == 1, self._tex(1, w[..., 0], w[..., 2]),
                     self._tex(2, w[..., 0], w[..., 1]))).astype(np.float32)
        # texture-poor band on the front wall
        weak = ((best == 0) & ~occ
                & (w[..., 1] > self.weak_y[0]) & (w[..., 1] < self.weak_y[1]))
        gray = np.where(weak, 128.0 + (gray - 128.0) * 0.06, gray)
        # sphere surface: banded texture by latitude (keeps a few trackable
        # edges so the occluder also contributes features)
        lat = np.arccos(np.clip((w[..., 2] - self.occ_c[2])
                                / max(self.occ_r, 1e-6), -1.0, 1.0))
        gray = np.where(occ, 90.0 + 70.0 * np.cos(10.0 * lat), gray)

        depth = np.where(np.isfinite(t), t, 0.0).astype(np.float32)
        # depth-noise model + periodic burst frames
        noise = self.depth_noise
        sigma_mult = (self.burst_scale
                      if (self.burst_every
                          and self._frame % self.burst_every == self.burst_every - 1)
                      else 1.0)
        if noise is not None:
            q = (noise.quadratic * depth * depth + noise.linear * depth
                 + noise.constant)
            sigma = np.maximum(q, noise.floor_mm) * sigma_mult
            depth = np.where(
                depth > 0,
                depth + sigma * self._noise_rng.standard_normal(depth.shape)
                .astype(np.float32), 0.0).astype(np.float32)
        # depth holes: random elliptical dropouts
        for _ in range(self.hole_count):
            hx = self._noise_rng.uniform(0, cam.width)
            hy = self._noise_rng.uniform(0, cam.height)
            rx = self.hole_radius_px * self._noise_rng.uniform(0.4, 1.6)
            ry = self.hole_radius_px * self._noise_rng.uniform(0.4, 1.6)
            hole = (((us - hx) / rx) ** 2 + ((vs - hy) / ry) ** 2) < 1.0
            depth = np.where(hole, 0.0, depth)
        self._frame += 1
        return gray.astype(np.float32), depth


def rotation_trajectory(n_frames: int, yaw_rate_d: float = 0.6,
                        pitch_rate_d: float = 0.15, speed_mm: float = 0.8):
    """Rotation-dominant ground truth (fr1_rpy analogue): fast yaw + pitch with
    near-zero translation — image motion is dominated by rotation, the regime
    where LK search windows and match gates are stressed hardest."""
    poses = []
    for i in range(n_frames):
        quat = _quat_from_euler(np.radians(yaw_rate_d) * i,
                                np.radians(pitch_rate_d) * i, 0.0)
        pos = np.array([0.3 * i, speed_mm * i, 0.0], np.float32)
        poses.append((quat, pos))
    return poses


def _quat_from_euler(yaw, pitch, roll):
    cy, sy = np.cos(yaw / 2), np.sin(yaw / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    return np.array([
        cr * cp * cy + sr * sp * sy,
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
    ], np.float32)


def orbit_trajectory(n_frames: int, speed_mm: float = 4.0,
                     yaw_rate_d: float = 0.05, pitch_rate_d: float = 0.02):
    """6-DoF ground truth: lateral+forward translation with slow yaw/pitch
    rotation (the full-trajectory bench's rotating analogue of fr1 motion)."""
    poses = []
    for i in range(n_frames):
        yaw = np.radians(yaw_rate_d) * i
        pitch = np.radians(pitch_rate_d) * i
        quat = _quat_from_euler(yaw, pitch, 0.0)
        pos = np.array([1.5 * i, speed_mm * i, 0.4 * speed_mm * i], np.float32)
        poses.append((quat, pos))
    return poses


def roll_trajectory(n_frames: int, roll_amp_d: float = 30.0,
                    speed_mm: float = 2.0, yaw_rate_d: float = 0.05):
    """Roll-heavy ground truth (fr1_rpy analogue, reference README.md:40-43):
    the camera rolls +-``roll_amp_d`` about its optical axis while translating
    slowly.  Roll is the axis BRIEF descriptors are NOT invariant to
    (keypoint_detection.cpp:34-45 carries an ORB option for exactly this), so
    this leg measures the rotation-robustness bound of the BRIEF+LK pipeline."""
    poses = []
    for i in range(n_frames):
        roll = np.radians(roll_amp_d) * np.sin(2.0 * np.pi * i / n_frames)
        yaw = np.radians(yaw_rate_d) * i
        quat = _quat_from_euler(yaw, 0.0, roll)
        pos = np.array([0.5 * i, speed_mm * i, 0.0], np.float32)
        poses.append((quat, pos))
    return poses


def lateral_trajectory(n_frames: int, speed_mm: float = 4.0):
    """Ground-truth poses: lateral + slight forward translation."""
    poses = []
    for i in range(n_frames):
        quat = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
        pos = np.array([1.5 * i, speed_mm * i, 0.0], np.float32)
        poses.append((quat, pos))
    return poses
