"""Parity of the port's line detector and line matcher with the JAX package.

Images: the five of tests/test_lines.py at 240x320 (horizontal, diagonal, two
lines, flat, noise) and one RoomScene and one StripeWallScene frame at 480x640.
Each stage is compared: the tile statistics, the directed edge maps, every
seed's member tiles (the JAX ``lax.while_loop`` growth against both of the
port's forms: the chunked loop and the closure rows), and the segments.

Tolerances.  The tile sums are taken in a different order and ``atan2``, ``cos``,
``sin`` differ in the last bits between XLA's CPU code and PyTorch, so tile
weights and moments agree to 1e-5 relative, centroids to 1e-3 px, the
double-angle means and the coherence to 5e-6.  The discrete outcomes cut on
those: ``mag > 15`` per pixel, ``coherence > 0.7`` per tile, the double-angle
dot against cos 25 deg and the offset against 6 px per edge.  ``_near_a_cut``
marks what sits within a stated tolerance of a cut (8e-6 gray levels for a
pixel's magnitude, 5e-5 for the coherence and the dot, 1e-2 px for the
offset); the test images have no such tile or edge (asserted), so masks, member
sets, ``valid`` and ``tile_count`` must be equal, and ``p0``, ``p1`` and
``direction`` agree to 1e-2 px.

A segment's orientation is the one thing left open: the direction is
``0.5 * atan2(2 b, a - c)`` of the scatter matrix, and for a vertical segment
(``a < c``) the sign of a ``b`` that is zero up to rounding decides between
(0, 1) and (0, -1), which swaps ``p0`` and ``p1``.  Everything that consumes a
segment is symmetric in that swap.  ``_orient`` turns such a segment of the
port to the JAX one's orientation, and only where its direction's x is under
1e-3.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rgbd_slam_tpu_torch.config as tcfg
from rgbd_slam_tpu import engine as j_engine
from rgbd_slam_tpu.config import TUM_FR1, DepthNoiseModel, SlamConfig
from rgbd_slam_tpu.features import lines as j_lines
from rgbd_slam_tpu.geometry import se3 as j_se3
from rgbd_slam_tpu.mapping import maps as j_maps
from rgbd_slam_tpu.ops import image as j_image
from rgbd_slam_tpu.synthetic import RoomScene, StripeWallScene, lateral_trajectory, \
    orbit_trajectory
from rgbd_slam_tpu_torch import engine
from rgbd_slam_tpu_torch.features import lines
from rgbd_slam_tpu_torch.geometry import se3
from rgbd_slam_tpu_torch.mapping import maps
from test_lines import draw_line

torch.set_num_threads(2)

MAG_THRESHOLD, MIN_EDGE_FRAC, MIN_COHERENCE = 15.0, 0.06, 0.7
ANGLE_COS, OFFSET_PX = math.cos(math.radians(25.0)), 6.0
#: how close to a cut a tile's or an edge's continuous quantity may sit before
#: its discrete outcome is excused: 10x the agreement asked of these quantities
CUT_TOL = 5e-5
#: the same for a pixel's gradient magnitude against 15: a square root of two
#: products and a sum, equal in both packages to a few float32 ulps (1.9e-6)
PIXEL_CUT_TOL = 8e-6


def _blank(value=50.0):
    return np.full((240, 320), value, np.float32)


def _image(name):
    if name == "horizontal":
        return draw_line(_blank(), (40, 120), (280, 120))
    if name == "diagonal":
        return draw_line(_blank(), (50, 50), (250, 200))
    if name == "two_lines":
        return draw_line(draw_line(_blank(), (30, 60), (290, 60)), (160, 20), (160, 220))
    if name == "flat":
        return _blank(100.0)
    if name == "noise":
        return np.random.default_rng(1000).uniform(0, 255, (240, 320)).astype(np.float32)
    if name == "room":
        scene = RoomScene(TUM_FR1, depth_noise=DepthNoiseModel())
        return scene.render(*orbit_trajectory(6, speed_mm=4.0)[5])[0]
    scene = StripeWallScene(TUM_FR1, texture_scale=0.03, stripe_period_z=2400.0)
    return scene.render(*lateral_trajectory(4, speed_mm=4.0)[3])[0]


IMAGES = ("horizontal", "diagonal", "two_lines", "flat", "noise", "room", "stripe_wall")


def _seed_members(grid, edges, shifts, gh, gw, grow, xp):
    """The member tiles of each of the MAX_LINE_SEEDS seeds, taken in turn as
    ``detect_lines`` does (min_tiles = 2), with ``grow(seed, available)`` as the
    growth; ``xp`` is numpy-like access for the host bookkeeping."""
    is_line = xp(grid.is_line)
    weight = xp(grid.weight)
    available = is_line.copy()
    members = []
    for _ in range(j_lines.MAX_LINE_SEEDS):
        seed_w = np.where(available & is_line, weight, -1.0)
        seed = int(np.argmax(seed_w))
        proceed = seed_w[seed] > 0
        active = xp(grow(seed, available)) & is_line & available
        members.append(active)
        if proceed and active.sum() >= 2:
            available = available & ~active
        elif proceed:
            available[seed] = False
    return np.stack(members)


@functools.lru_cache(maxsize=None)
def _stages(name):
    """Every stage of both detectors on one image."""
    img = _image(name)
    j_grid, gh, gw = j_lines._tile_stats(jnp.asarray(img), MAG_THRESHOLD, MIN_EDGE_FRAC,
                                         MIN_COHERENCE)
    j_edges, shifts = j_lines._line_edge_maps(j_grid, gh, gw, ANGLE_COS, OFFSET_PX)
    t_grid, t_gh, t_gw = lines._tile_stats(torch.from_numpy(img), MAG_THRESHOLD,
                                           MIN_EDGE_FRAC, MIN_COHERENCE)
    assert (t_gh, t_gw) == (gh, gw)
    t_edges, t_shifts = lines._line_edge_maps(t_grid, gh, gw, ANGLE_COS, OFFSET_PX)
    assert tuple(t_shifts) == tuple(shifts)
    return dict(img=img, gh=gh, gw=gw, shifts=shifts, j_grid=j_grid, j_edges=j_edges,
                t_grid=t_grid, t_edges=t_edges,
                j_det=j_lines.detect_lines(jnp.asarray(img)),
                t_det=lines.detect_lines(torch.from_numpy(img)))


def _near_a_cut(st):
    """(tiles [T] bool, edges [8, gh, gw] bool) whose discrete outcome sits
    within CUT_TOL of a cut in the JAX package's own values."""
    g, gh, gw = st["j_grid"], st["gh"], st["gw"]
    ix, iy = (np.asarray(a, np.float64) for a in j_image.gradients(jnp.asarray(st["img"])))
    near_px = np.abs(np.sqrt(ix * ix + iy * iy) - MAG_THRESHOLD) < PIXEL_CUT_TOL
    t = lines.TILE
    near_px = near_px[:gh * t, :gw * t].reshape(gh, t, gw, t).any(axis=(1, 3)).reshape(-1)
    tiles = near_px | (np.abs(np.asarray(g.coherence) - MIN_COHERENCE) < CUT_TOL)
    # edges: recompute the two gated quantities from the JAX grid in float64
    coh = np.maximum(np.asarray(g.coherence, np.float64), 1e-9).reshape(gh, gw)
    c2 = np.asarray(g.cos2, np.float64).reshape(gh, gw) / coh
    s2 = np.asarray(g.sin2, np.float64).reshape(gh, gw) / coh
    d = np.asarray(j_lines._tile_direction(g.cos2, g.sin2), np.float64).reshape(gh, gw, 2)
    cen = np.asarray(g.mean, np.float64).reshape(gh, gw, 2)
    ok = np.asarray(g.is_line).reshape(gh, gw)
    edges = []
    for dy, dx in st["shifts"]:
        def roll(a):
            return np.roll(a, (dy, dx), (0, 1))
        dot = roll(c2) * c2 + roll(s2) * s2
        rel = cen - roll(cen)
        perp = np.abs(rel[..., 0] * -roll(d)[..., 1] + rel[..., 1] * roll(d)[..., 0])
        edges.append(ok & roll(ok) & ((np.abs(dot - ANGLE_COS) < CUT_TOL)
                                      | (np.abs(perp - OFFSET_PX) < 1e-2)))
    return tiles, np.stack(edges)


@pytest.mark.parametrize("name", IMAGES)
def test_tile_grid_matches_jax(name):
    st = _stages(name)
    j, t = st["j_grid"], st["t_grid"]
    near_tiles, _ = _near_a_cut(st)
    assert not near_tiles.any()        # the image decides every tile clearly
    np.testing.assert_array_equal(t.count.numpy(), np.asarray(j.count))
    np.testing.assert_array_equal(t.is_line.numpy(), np.asarray(j.is_line))
    has_edges = np.asarray(j.count) > 0
    w = np.asarray(j.weight)
    np.testing.assert_allclose(t.weight.numpy(), w, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(t.mean.numpy()[has_edges], np.asarray(j.mean)[has_edges],
                               atol=1e-3)
    # second moments: relative to the tile's weight x its 16 px extent squared
    np.testing.assert_allclose(t.m2.numpy(), np.asarray(j.m2), rtol=1e-4,
                               atol=1e-5 * (w[:, None, None] * lines.TILE ** 2 + 1.0).max())
    for f in ("cos2", "sin2", "coherence"):
        np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                   atol=5e-6, err_msg=f)
    assert t.count.dtype == torch.int32 and t.is_line.dtype == torch.bool


@pytest.mark.parametrize("name", IMAGES)
def test_edges_and_seed_members_match_jax(name):
    st = _stages(name)
    gh, gw, shifts = st["gh"], st["gw"], st["shifts"]
    _, near_edges = _near_a_cut(st)
    assert not near_edges.any()
    np.testing.assert_array_equal(st["t_edges"].numpy(), np.asarray(st["j_edges"]))

    j_members = _seed_members(
        st["j_grid"], st["j_edges"], shifts, gh, gw,
        lambda s, av: j_lines._propagate(jnp.asarray(s), st["j_edges"], shifts,
                                         jnp.asarray(av), gh, gw), np.asarray)
    loop = _seed_members(
        st["t_grid"], st["t_edges"], shifts, gh, gw,
        lambda s, av: lines._propagate(torch.tensor([s]), st["t_edges"], shifts,
                                       torch.from_numpy(av), gh, gw),
        lambda x: x.numpy())
    reach = lines._reach_closure(st["t_edges"], shifts, gh, gw)
    closure = _seed_members(st["t_grid"], st["t_edges"], shifts, gh, gw,
                            lambda s, av: reach[s], lambda x: x.numpy())
    np.testing.assert_array_equal(loop, j_members)
    np.testing.assert_array_equal(closure, j_members)
    grown = {"two_lines": 2, "room": 1, "stripe_wall": 4}
    assert (j_members.sum(axis=1) >= 2).sum() >= grown.get(name, 0)


def _orient(t, j):
    """The port's (p0, p1, direction) as numpy, vertical segments turned to the
    JAX segment's orientation (see the module docstring)."""
    p0, p1, d = t.p0.numpy(), t.p1.numpy(), t.direction.numpy()
    flip = (np.sum(d * np.asarray(j.direction), axis=-1) < 0) & (np.abs(d[:, 0]) < 1e-3)
    f = flip[:, None]
    return np.where(f, p1, p0), np.where(f, p0, p1), np.where(f, -d, d)


def _assert_segments_close(t, j):
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_array_equal(t.tile_count.numpy(), np.asarray(j.tile_count))
    for got, f in zip(_orient(t, j), ("p0", "p1", "direction")):
        np.testing.assert_allclose(got, np.asarray(getattr(j, f)), atol=1e-2, err_msg=f)
    np.testing.assert_allclose(t.strength.numpy(), np.asarray(j.strength), rtol=1e-5)


@pytest.mark.parametrize("name", IMAGES)
def test_segments_match_jax(name):
    st = _stages(name)
    j, t = st["j_det"], st["t_det"]
    assert t._fields == j._fields
    assert t.tile_count.dtype == torch.int32
    _assert_segments_close(t, j)
    expect = {"horizontal": 1, "diagonal": 1, "two_lines": 2, "room": 1, "stripe_wall": 4}
    assert int(t.valid.sum()) >= expect.get(name, 0)
    if name == "flat":
        assert int(t.valid.sum()) == 0


@pytest.mark.parametrize("name", ["two_lines", "stripe_wall"])
def test_min_tiles_over_two_grows_each_seed(name):
    """min_tiles = 3: a seed may consume itself alone, so detect_lines grows
    every seed with the loop; the segments still equal the JAX package's."""
    img = _image(name)
    j = j_lines.detect_lines(jnp.asarray(img), min_tiles=3)
    t = lines.detect_lines(torch.from_numpy(img), min_tiles=3)
    _assert_segments_close(t, j)


def test_growth_reads_the_host_only_in_the_loop(monkeypatch):
    """The default detector takes every seed's members from the closure: no
    host read; min_tiles = 3 reads once per GROW_CHUNK rounds of each seed."""
    reads = []
    real = torch.Tensor.item
    monkeypatch.setattr(torch.Tensor, "item", lambda self: reads.append(1) or real(self))
    img = torch.from_numpy(_image("two_lines"))
    lines.detect_lines(img)
    assert not reads
    lines.detect_lines(img, min_tiles=3)
    assert len(reads) >= lines.MAX_LINE_SEEDS


# ---------------------------------------------------------------------------
# _match_lines
# ---------------------------------------------------------------------------

def _match_case(seed):
    """A seeded line map and detections: most detections are a map line's
    projection, jittered; two map lines are identical (both claim the same
    detection with the same distance, so the first wins); some map rows are
    dead, some project nowhere near a detection, some detections are invalid
    and one pair of detections is identical (a tie inside a row)."""
    rng = np.random.default_rng(seed)
    ml, nd = 16, lines.MAX_LINES
    cam = TUM_FR1
    quat = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    pos = np.zeros(3, np.float32)
    w2c = np.asarray(j_se3.world_to_camera(jnp.asarray(quat), jnp.asarray(pos)))
    mids = np.concatenate([rng.uniform(2000, 3500, (ml, 1)),
                           rng.uniform(-900, 900, (ml, 2))], axis=1)
    dirs = rng.normal(0, 1, (ml, 3))
    dirs[:, 0] *= 0.2
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    endpoints = np.concatenate([mids - 300 * dirs, mids + 300 * dirs], 1).astype(np.float32)
    endpoints[5] = endpoints[4]                       # identical map lines
    fid = np.arange(ml, dtype=np.int32)
    fid[[2, 9]] = -1                                  # dead rows

    def project(p):
        c = p @ w2c[:3, :3].T + w2c[:3, 3]
        return np.stack([cam.fx * c[:, 0] / c[:, 2] + cam.cx,
                         cam.fy * c[:, 1] / c[:, 2] + cam.cy], -1)

    s0, s1 = project(endpoints[:, :3]), project(endpoints[:, 3:])
    p0 = np.zeros((nd, 2), np.float32)
    p1 = np.zeros((nd, 2), np.float32)
    src = [4] + [m for m in rng.permutation(ml) if m not in (4, 5)][:11]
    for d, m in enumerate(src):
        jitter = rng.normal(0, 2.0, (2, 2)) * (d > 0)
        p0[d], p1[d] = s0[m] + jitter[0], s1[m] + jitter[1]
    p0[12], p1[12] = p0[0], p1[0]                     # identical detections
    p0[13], p1[13] = [10.0, 470.0], [60.0, 472.0]     # matches nothing
    valid = np.zeros(nd, bool)
    valid[:14] = True
    valid[3] = False
    seg = p1 - p0
    direction = seg / np.maximum(np.linalg.norm(seg, axis=1, keepdims=True), 1e-9)
    return dict(endpoints=endpoints, fid=fid, p0=p0, p1=p1,
                direction=direction.astype(np.float32), valid=valid, quat=quat, pos=pos)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_lines_matches_jax(seed):
    c = _match_case(seed)
    ml, nd = len(c["fid"]), len(c["valid"])
    j_map = j_maps.empty_line_map(ml)._replace(endpoints=jnp.asarray(c["endpoints"]),
                                               fid=jnp.asarray(c["fid"]))
    t_map = maps.empty_line_map(ml, device="cpu")._replace(
        endpoints=torch.from_numpy(c["endpoints"]), fid=torch.from_numpy(c["fid"]))
    zeros = np.zeros(nd, np.float32)
    j_det = j_lines.DetectedLines(
        p0=jnp.asarray(c["p0"]), p1=jnp.asarray(c["p1"]),
        direction=jnp.asarray(c["direction"]), strength=jnp.asarray(zeros),
        tile_count=jnp.zeros(nd, jnp.int32), valid=jnp.asarray(c["valid"]))
    t_det = lines.DetectedLines(*[torch.from_numpy(np.array(x)) for x in j_det])
    j_w2c = j_se3.world_to_camera(jnp.asarray(c["quat"]), jnp.asarray(c["pos"]))
    t_w2c = se3.world_to_camera(torch.from_numpy(c["quat"]), torch.from_numpy(c["pos"]))
    j_idx, j_l0, j_l1 = j_engine._match_lines(j_map, j_det, j_w2c, TUM_FR1, SlamConfig())
    t_idx, t_l0, t_l1 = engine._match_lines(t_map, t_det, t_w2c, tcfg.TUM_FR1,
                                            tcfg.SlamConfig())
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    assert t_idx.dtype == torch.int32
    alive = c["fid"] >= 0
    np.testing.assert_allclose(t_l0.numpy()[alive], np.asarray(j_l0)[alive], atol=1e-2)
    np.testing.assert_allclose(t_l1.numpy()[alive], np.asarray(j_l1)[alive], atol=1e-2)
    idx = np.asarray(j_idx)
    assert (idx >= 0).sum() >= 6 and (idx[alive] < 0).any()
    assert idx[4] >= 0 and idx[5] < 0      # the first of two identical map lines wins
    assert len(set(idx[idx >= 0])) == (idx >= 0).sum()
