"""``ops/depth_cloud``: the cell reorganization and the depth map's rectification
into the RGB camera, the port against the JAX package on the same seeded inputs.

``organize_by_cells`` moves values and must be bit-equal.  ``rectify_depth``
computes a pixel index from a projection and truncates it: the two packages may
round the projection differently in the last float32 bit, which can move a source
pixel to the next target only where its projected coordinate + 0.5 lies within
1e-4 of an integer.  The targets of such pixels are excused (a few tens of a
map's pixels lie that near an edge, and up to 4 targets a map do differ);
everywhere else the holes must be the same set and the depths equal to 1e-3 mm.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_slam_tpu.config import CameraIntrinsics as JCam
from rgbd_slam_tpu.ops import depth_cloud as j_dc
from rgbd_slam_tpu_torch.config import CameraIntrinsics
from rgbd_slam_tpu_torch.ops import depth_cloud as dc

CAMS = {(480, 640): dict(width=640, height=480, fx=517.3, fy=516.5, cx=318.6, cy=255.3),
        (240, 320): dict(width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0)}


def _extrinsic(name):
    m = np.eye(4)
    if name != "identity":
        m[0, 3] = 25.0                                       # a 25 mm baseline
    if name == "baseline_and_2deg":
        a = math.radians(2.0)
        m[:3, :3] = [[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                     [-math.sin(a), 0.0, math.cos(a)]]
    return m


def _depth_map(seed, shape):
    """A slanted wall with a nearer box, sensor noise, dropouts and a band beyond
    the valid range."""
    rng = np.random.default_rng(seed)
    h, w = shape
    ys, xs = np.mgrid[0:h, 0:w]
    depth = 2500.0 + rng.uniform(-2, 2) * xs + rng.uniform(-1, 1) * ys
    y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
    depth[y0:y0 + h // 3, x0:x0 + w // 3] = rng.uniform(900, 1500)
    depth += rng.normal(0, 3.0, shape)
    depth[rng.uniform(size=shape) < 0.05] = 0.0
    depth[:, : w // 20] = 7000.0
    return depth.astype(np.float32)


@pytest.mark.parametrize("shape", [(480, 640, 3), (240, 320, 1), (60, 80)])
def test_organize_by_cells_bit_equal(shape):
    arr = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = np.asarray(j_dc.organize_by_cells(jnp.asarray(arr)))
    got = dc.organize_by_cells(torch.from_numpy(arr)).numpy()
    assert got.shape == want.shape == (shape[0] // 20 * (shape[1] // 20), 400,
                                       shape[2] if len(shape) == 3 else 1)
    np.testing.assert_array_equal(got, want)
    patch = dc.organize_by_cells(torch.from_numpy(arr), patch=10)
    assert patch.shape[:2] == (shape[0] // 10 * (shape[1] // 10), 100)


def _targets_near_a_pixel_edge(depth, cam, ext):
    """[H, W] mask of the target pixels that a valid source pixel may or may
    not reach, depending on rounding: the targets on both sides of an edge from
    which its projected coordinate + 0.5 lies within 1e-4 (float64).  Also the
    number of such source pixels."""
    h, w = depth.shape
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    z = depth.astype(np.float64)
    valid = (z > 40.0) & (z <= 6000.0)
    pts = np.stack([(xs - cam.cx) / cam.fx * z, (ys - cam.cy) / cam.fy * z, z], -1)
    pts = pts @ ext[:3, :3].T + ext[:3, 3]
    zz = np.maximum(pts[..., 2], 1e-6)
    u = cam.fx * pts[..., 0] / zz + cam.cx + 0.5
    v = cam.fy * pts[..., 1] / zz + cam.cy + 0.5
    near = valid & ((np.abs(u - np.round(u)) < 1e-4) | (np.abs(v - np.round(v)) < 1e-4))
    targets = np.zeros((h, w), bool)
    for du in (-1e-4, 1e-4):
        for dv in (-1e-4, 1e-4):
            tu, tv = np.trunc(u[near] + du).astype(int), np.trunc(v[near] + dv).astype(int)
            ok = (tu >= 0) & (tu < w) & (tv >= 0) & (tv < h)
            targets[tv[ok], tu[ok]] = True
    return targets, int(near.sum())


@pytest.mark.parametrize("shape", sorted(CAMS))
@pytest.mark.parametrize("extrinsic", ["identity", "baseline", "baseline_and_2deg"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rectify_depth_matches_jax(seed, extrinsic, shape):
    depth = _depth_map(seed, shape)
    ext = _extrinsic(extrinsic)
    want = np.asarray(j_dc.rectify_depth(jnp.asarray(depth), JCam(**CAMS[shape]),
                                         JCam(**CAMS[shape]), jnp.asarray(ext)))
    cam = CameraIntrinsics(**CAMS[shape])
    got = dc.rectify_depth(torch.from_numpy(depth), cam, cam, ext).numpy()
    assert got.shape == want.shape == shape and np.isfinite(got).all()
    excused, n_near = _targets_near_a_pixel_edge(depth, cam, ext)
    holes_differ = (got == 0) != (want == 0)
    values_differ = (got != 0) & (want != 0) & (np.abs(got - want) > 1e-3)
    if extrinsic == "identity":
        # every valid pixel lands on itself; what was invalid is a hole
        valid = (depth > 40.0) & (depth <= 6000.0)
        np.testing.assert_array_equal(got, np.where(valid, depth, 0.0))
    else:
        assert (got == 0).sum() > (depth == 0).sum()         # the warp leaves holes
    # a few tens of a map's source pixels lie that near an edge, and a handful of
    # their targets differ; nothing differs anywhere else
    assert n_near < 1e-3 * depth.size
    assert not (holes_differ & ~excused).any() and not (values_differ & ~excused).any()
    assert (holes_differ | values_differ).sum() <= 4


def test_rectify_depth_keeps_the_nearest_of_duplicate_targets():
    """An RGB camera of half the focal length: four source pixels land on one
    target, which must hold the least of their depths."""
    rng = np.random.default_rng(3)
    depth = rng.uniform(800, 3000, (48, 64)).astype(np.float32)
    depth_cam = CameraIntrinsics(width=64, height=48, fx=60.0, fy=60.0, cx=32.0, cy=24.0)
    rgb_cam = CameraIntrinsics(width=64, height=48, fx=30.0, fy=30.0, cx=32.3, cy=24.2)
    got = dc.rectify_depth(torch.from_numpy(depth), depth_cam, rgb_cam, np.eye(4)).numpy()
    want = np.full((48, 64), np.inf, np.float32)
    for y in range(48):
        for x in range(64):
            u = int(30.0 * ((x - 32.0) / 60.0) + 32.3 + 0.5)
            v = int(30.0 * ((y - 24.0) / 60.0) + 24.2 + 0.5)
            want[v, u] = min(want[v, u], depth[y, x])
    want[np.isinf(want)] = 0.0
    assert ((want > 0).sum() < 0.3 * want.size)              # targets are shared
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_rectify_depth_is_deterministic_and_out_of_image_is_dropped():
    depth = _depth_map(5, (240, 320))
    cam = CameraIntrinsics(**CAMS[(240, 320)])
    ext = _extrinsic("baseline")
    ext[0, 3] = 400.0                          # a baseline that pushes columns off the image
    a = dc.rectify_depth(torch.from_numpy(depth), cam, cam, ext)
    b = dc.rectify_depth(torch.from_numpy(depth), cam, cam, ext)
    assert torch.equal(a, b)
    assert float((a[:, :20] == 0).float().mean()) == 1.0     # nothing maps to the left edge
    assert (a > 0).sum() > 0
