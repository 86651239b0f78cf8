"""Parity of the port's image ops, FAST, BRIEF and matching with the JAX package.

Tolerances: the pyramid's horizontal pass is a matmul whose sum order differs
from XLA's, so levels agree to 1e-3 gray levels; the stencil sums (box filter,
FAST score) are the same sequences of adds, so FAST positions agree to 1e-4 px
and BRIEF descriptors bit for bit; matching is integer and must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_slam_tpu.config import CameraIntrinsics
from rgbd_slam_tpu.ops import brief as j_brief
from rgbd_slam_tpu.ops import fast as j_fast
from rgbd_slam_tpu.ops import image as j_image
from rgbd_slam_tpu.ops import matching as j_matching
from rgbd_slam_tpu.synthetic import RoomScene, orbit_trajectory
from rgbd_slam_tpu_torch.ops import brief, fast, image, matching

torch.set_num_threads(2)

CAM = CameraIntrinsics(width=160, height=120, fx=130.0, fy=130.0, cx=80.0, cy=60.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _room(i=0):
    scene = RoomScene(CAM)
    q, p = orbit_trajectory(i + 1)[i]
    return scene.render(q, p)[0]


def _tie_image():
    """Identical bright squares in the same grid cell: their FAST corners score
    exactly the same, so the order of ties decides the detection order."""
    img = np.full((120, 160), 40.0, np.float32)
    for y0, x0 in ((10, 10), (10, 30), (25, 10), (25, 30), (80, 120)):
        img[y0:y0 + 6, x0:x0 + 6] = 200.0
    return img


@pytest.mark.parametrize("shape", [(120, 160), (61, 81)])
def test_pyramid_and_stencils(shape):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    for port, ref in zip(image.build_pyramid(_t(img), 3),
                         j_image.build_pyramid(jnp.asarray(img), 3)):
        assert port.shape == ref.shape
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=1e-3)
    np.testing.assert_array_equal(image.box_filter(_t(img), 9).numpy(),
                                  np.asarray(j_image.box_filter(jnp.asarray(img), 9)))
    np.testing.assert_array_equal(image.max_pool_same(_t(img), 3).numpy(),
                                  np.asarray(j_image.max_pool_same(jnp.asarray(img), 3)))
    xy = rng.uniform(-2, 170, (64, 2)).astype(np.float32)
    np.testing.assert_array_equal(image.in_border(_t(xy), *shape).numpy(),
                                  np.asarray(j_image.in_border(xy, *shape)))


@pytest.mark.parametrize("which", ["room", "ties"])
def test_fast_grid_detection(which):
    img = _room() if which == "room" else _tie_image()
    rng = np.random.default_rng(1)
    tracked = rng.uniform(0, 160, (16, 2)).astype(np.float32)
    tvalid = rng.uniform(size=16) > 0.5
    j_mask = j_fast.tracked_points_mask(img.shape, jnp.asarray(tracked),
                                        jnp.asarray(tvalid), 15.0)
    t_mask = fast.tracked_points_mask(img.shape, _t(tracked), _t(tvalid), 15.0)
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    mask = None if which == "ties" else j_mask
    thr, thr_low = np.float32(24.0), np.float32(8.0)
    j_xy, j_score, j_valid = j_fast.detect_fast_grid(
        jnp.asarray(img), detection_mask=mask, threshold=thr, low_threshold=thr_low,
        max_points=40)
    t_xy, t_score, t_valid = fast.detect_fast_grid(
        _t(img), detection_mask=None if mask is None else t_mask,
        threshold=torch.tensor(thr), low_threshold=torch.tensor(thr_low), max_points=40)
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
    np.testing.assert_allclose(t_xy.numpy(), np.asarray(j_xy), atol=1e-4)
    np.testing.assert_allclose(t_score.numpy(), np.asarray(j_score), rtol=1e-6)
    if which == "ties":
        scores = t_score.numpy()[t_valid.numpy()]
        assert len(scores) > len(np.unique(scores))   # the scene does tie


def test_brief_descriptors_are_bit_equal():
    img = _room(3)
    rng = np.random.default_rng(2)
    xy = np.concatenate([rng.uniform(0, 160, (60, 1)), rng.uniform(0, 120, (60, 1))],
                        -1).astype(np.float32)
    valid = rng.uniform(size=60) > 0.1
    j_desc, j_ok = j_brief.compute_brief(jnp.asarray(img), jnp.asarray(xy),
                                         jnp.asarray(valid))
    t_desc, t_ok = brief.compute_brief(_t(img), _t(xy), _t(valid))
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    np.testing.assert_array_equal(t_desc.numpy().view(np.uint32), np.asarray(j_desc))
    j_ham = j_brief.hamming_distance_matrix(j_desc, j_desc[::-1])
    t_ham = brief.hamming_distance_matrix(t_desc, t_desc.flip(0))
    np.testing.assert_array_equal(t_ham.numpy(), np.asarray(j_ham))


def test_matching_with_ties_and_conflicts():
    rng = np.random.default_rng(3)
    det_desc = rng.integers(0, 2 ** 32, (40, 8), dtype=np.uint32)
    det_desc[20:30] = det_desc[10:20]            # duplicate detections: Hamming ties
    map_desc = det_desc[rng.integers(0, 40, 64)] ^ (
        rng.uniform(size=(64, 8)) < 0.02).astype(np.uint32)
    det_uv = rng.uniform(0, 160, (40, 2)).astype(np.float32)
    map_uv = (det_uv[rng.integers(0, 40, 64)] + rng.normal(0, 8, (64, 2))).astype(np.float32)
    map_valid = rng.uniform(size=64) > 0.1
    det_valid = rng.uniform(size=40) > 0.1
    taken = rng.uniform(size=40) > 0.8
    j_idx, j_dist = j_matching.match_descriptors(
        jnp.asarray(map_desc), jnp.asarray(map_uv), jnp.asarray(map_valid),
        jnp.asarray(det_desc), jnp.asarray(det_uv), jnp.asarray(det_valid),
        jnp.asarray(taken), search_radius=30.0, lowe_ratio=0.7)
    t_idx, t_dist = matching.match_descriptors(
        _t(map_desc.view(np.int32)), _t(map_uv), _t(map_valid),
        _t(det_desc.view(np.int32)), _t(det_uv), _t(det_valid), _t(taken),
        search_radius=30.0, lowe_ratio=0.7)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_dist.numpy(), np.asarray(j_dist))
    assert (np.asarray(j_idx) >= 0).sum() > 10
    j_res = j_matching.resolve_match_conflicts(j_idx, j_dist, 40)
    t_res = matching.resolve_match_conflicts(t_idx, t_dist, 40)
    np.testing.assert_array_equal(t_res.numpy(), np.asarray(j_res))


@pytest.mark.parametrize("shape", [(120, 160), (61, 81)])
def test_gradients_and_bilinear_sample(shape):
    """Central differences and bilinear taps are the same products and sums in
    both packages: equal to 1e-6 relative (of the gray range for the
    differences of neighbouring pixels)."""
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    for port, ref in zip(image.gradients(_t(img)), j_image.gradients(jnp.asarray(img))):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-6, atol=255e-6)
    h, w = shape
    # inside, on the borders, and outside on every side (clipped to the border)
    xy = np.concatenate([
        rng.uniform(-3, w + 3, (200, 1)), rng.uniform(-3, h + 3, (200, 1))], -1)
    xy = np.concatenate([xy, [[0, 0], [w - 1, h - 1], [w - 1, 0], [0.5, h - 1], [w, h]]])
    xy = xy.astype(np.float32).reshape(5, 41, 2)
    port = image.bilinear_sample(_t(img), _t(xy))
    ref = j_image.bilinear_sample(jnp.asarray(img), jnp.asarray(xy))
    assert port.shape == (5, 41)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-6, atol=255e-6)
