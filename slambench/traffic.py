"""The benchmark's one traffic generator: every mix under ``slambench/traffic/``
is a file of parameters that this module reads.

A mix names a scene of :mod:`slambench.scenes` with its arguments, a
trajectory with its arguments, the Kinect depth noise, and how the frames reach
the program (``delivery``):

* ``staged``: the frames are uploaded to the card in the set-up
  (``runner.stage_frames``), and ``run_frames`` takes them as they are;
* ``tum_files``: the frames are written in the set-up as a TUM RGB-D directory
  (8-bit RGB, 16-bit depth at ``depth_units_per_mm``, ground truth in metres)
  and read back in the window through ``cli.open_frames``; ``loader`` says
  which of its paths (``native``: the C++ prefetching loader).

A mix lists a fixed pool of realisations, each a pair (noise seed, state
seed): the depth noise of frame ``i`` of a realisation is drawn from (its noise
seed, ``i``), and its sequences start from ``engine.init_state(seed=<its state
seed>)``.  The scene's textures and the trajectory are fixed.  A run goes
through the pool in an order drawn from ``--seed`` (:func:`order`), so every
seed gives the same sizes, work and frames, in another order, and the
trajectory error over the pool does not depend on the seed.  Each pose is
rendered once and the realisations' noise added to its clean depth, so frame
``i`` is the same whatever process renders it.
"""

from __future__ import annotations

import multiprocessing
import os
from typing import NamedTuple

import numpy as np

from . import scenes, tum

SCENES = {"WallScene": scenes.WallScene, "StripeWallScene": scenes.StripeWallScene,
          "TunnelScene": scenes.TunnelScene, "RoomScene": scenes.RoomScene,
          "HardRoomScene": scenes.HardRoomScene}


def tunnel_trajectory(n_frames: int):
    """Forward flight along the tunnel axis (world x) with slow yaw
    (``bench_torch.tunnel_trajectory``, commit 01a0d89)."""
    poses = []
    for i in range(n_frames):
        quat = scenes._quat_from_euler(np.radians(0.03) * i, 0.0, 0.0)
        pos = np.array([8.0 * i, 0.3 * i, 0.2 * i], np.float32)
        poses.append((quat, pos))
    return poses


TRAJECTORIES = {"orbit": scenes.orbit_trajectory, "roll": scenes.roll_trajectory,
                "lateral": scenes.lateral_trajectory,
                "rotation": scenes.rotation_trajectory, "tunnel": tunnel_trajectory}
DELIVERIES = ("staged", "tum_files")


class Camera(NamedTuple):
    """The fields of ``config.CameraIntrinsics`` that a scene reads."""
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float


class DepthNoise(NamedTuple):
    """``config.DepthNoiseModel`` in its published units, with the terms the
    scenes read (``config.py``'s properties, commit 01a0d89)."""
    sigma_error: float
    sigma_multiplier: float
    sigma_margin: float
    floor_mm: float

    @property
    def quadratic(self):
        return self.sigma_error * 1e-6

    @property
    def linear(self):
        return self.sigma_multiplier * 1e-3

    @property
    def constant(self):
        return self.sigma_margin


def check_mix(mix: dict):
    """Raises on a mix this generator cannot make."""
    if not mix.get("realizations") or any(len(r) != 2 for r in mix["realizations"]):
        raise ValueError("a mix lists its realisations as [noise seed, state seed] pairs")
    if mix["scene"] not in SCENES:
        raise ValueError(f"unknown scene {mix['scene']!r}; known: {sorted(SCENES)}")
    if mix["trajectory"] not in TRAJECTORIES:
        raise ValueError(f"unknown trajectory {mix['trajectory']!r}")
    if mix["delivery"] not in DELIVERIES:
        raise ValueError(f"unknown delivery {mix['delivery']!r}; known: {DELIVERIES}")


def poses_of(mix: dict, n_frames: int):
    """The trajectory's (quaternion wxyz, position mm) of every frame."""
    return TRAJECTORIES[mix["trajectory"]](n_frames, **mix.get("trajectory_args", {}))


def add_depth_noise(depth, noise: DepthNoise, rng):
    """Kinect depth noise on a clean depth map: ``RoomScene.render``'s
    formula (a sigma quadratic in depth, floored), zero depth kept."""
    q = noise.quadratic * depth * depth + noise.linear * depth + noise.constant
    sigma = np.maximum(q, noise.floor_mm)
    return np.where(depth > 0, depth + sigma * rng.standard_normal(depth.shape)
                    .astype(np.float32), 0.0).astype(np.float32)


def _render_chunk(mix: dict, cam: tuple, first: int, poses: list, roots):
    """Frames ``first``, ``first + 1``, ... of the mix (a worker's share): the
    gray image and the clean depth of each pose, rendered once, and the depth
    of each realisation, with the noise of (its noise seed, the frame).  With
    ``roots`` (one a realisation) it also writes them as TUM files there."""
    kw = dict(mix.get("scene_args", {}))
    scene = SCENES[mix["scene"]](Camera(*cam), **kw)
    noise = DepthNoise(**mix["depth_noise"]) if mix.get("depth_noise") else None
    out = []
    for k, (quat, pos) in enumerate(poses):
        i = first + k
        scene._noise_rng = np.random.default_rng([0, i])
        if hasattr(scene, "_frame"):
            scene._frame = i
        gray, depth = scene.render(quat, pos)
        depths = [depth if noise is None else
                  add_depth_noise(depth, noise, np.random.default_rng([noise_seed, i]))
                  for noise_seed, _ in mix["realizations"]]
        out.append((gray, depths))
        for root, depth_r in zip(roots or (), depths):
            tum.write_frame(root, i, gray, depth_r, mix["depth_units_per_mm"])
    return out


def order(mix: dict, seed: int) -> list[int]:
    """The order in which a run goes through the mix's realisations: a
    permutation drawn from the seed.  Every seed runs the same set."""
    rng = np.random.default_rng([seed % 2 ** 64, 3])
    return rng.permutation(len(mix["realizations"])).tolist()


def render(mix: dict, cam, n_frames: int, workers: int, workdir: str | None = None):
    """Start rendering the mix's ``n_frames`` poses in ``workers`` processes;
    a ``tum_files`` mix also writes them as one TUM directory a realisation
    under ``workdir``.  Returns the :class:`RenderJob`."""
    check_mix(mix)
    poses = poses_of(mix, n_frames)
    cam = tuple(Camera(*[getattr(cam, f) for f in Camera._fields]))
    roots = None
    if mix["delivery"] == "tum_files":
        roots = [os.path.join(workdir, f"r{r}") for r in range(len(mix["realizations"]))]
        for root in roots:
            tum.make_dataset(root)
    step = -(-n_frames // workers)
    chunks = [(mix, cam, c, poses[c:c + step], roots) for c in range(0, n_frames, step)]
    return RenderJob(mix, poses, roots, chunks)


class RenderJob:
    """The workers rendering a mix; :meth:`wait` collects their frames, and
    :meth:`close` stops them if nobody will."""

    #: one BLAS thread a worker: the workers already take every core
    WORKER_ENV = {"OPENBLAS_NUM_THREADS": "1", "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}

    def __init__(self, mix, poses, roots, chunks):
        self.mix, self.poses, self.roots = mix, poses, roots
        saved = {k: os.environ.get(k) for k in self.WORKER_ENV}
        os.environ.update(self.WORKER_ENV)   # read by the workers as they start
        try:
            self.pool = multiprocessing.get_context("spawn").Pool(len(chunks))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
        self.pending = self.pool.starmap_async(_render_chunk, chunks)

    def wait(self):
        """(frames of each realisation [[(gray, depth)] float32], ground-truth
        positions [N, 3] mm, poses, the TUM datasets or None)."""
        try:
            parts = self.pending.get()
        finally:
            self.close()
        rows = [f for part in parts for f in part]
        frames = [[(gray, depths[r]) for gray, depths in rows]
                  for r in range(len(self.mix["realizations"]))]
        gt = np.stack([p for _, p in self.poses]).astype(np.float64)
        datasets = ([tum.write_lists(root, self.poses) for root in self.roots]
                    if self.roots else None)
        return frames, gt, self.poses, datasets

    def close(self):
        if self.pool is not None:
            self.pool.terminate()
            self.pool.join()
            self.pool = None


def expected_decode(mix: dict, frames):
    """What a TUM directory written by :func:`write_files` decodes to, frame by
    frame: the gray image of the 8-bit RGB triple (ITU-R 601 weights in float32,
    the order of ``native/png_loader.cpp``) and the 16-bit depth over
    ``depth_units_per_mm``, in float32."""
    units = mix["depth_units_per_mm"]
    f32 = np.float32
    out = []
    for gray, depth in frames:
        g8 = tum.gray8(gray).astype(f32)
        g = f32(0.299) * g8 + f32(0.587) * g8 + f32(0.114) * g8
        d = tum.depth16(depth, units).astype(f32) * f32(1.0 / units)
        out.append((g, d))
    return out


def workers_for(mix: dict) -> int:
    return max(1, min(int(mix.get("render_workers", 8)), os.cpu_count() or 1))
