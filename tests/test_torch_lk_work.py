"""The LK kernels' work counts (``lk_cuda.lk_work``) against counts worked out by
hand, a plain model of the CUDA kernels' staged-tile sampling against the plain
sampler, and the port's default device.

This file imports no jax: the counts and the tile model concern the port alone.
"""

import numpy as np
import pytest
import torch

from rgbd_slam_tpu_torch import config, convert, engine, runner, synthetic
from rgbd_slam_tpu_torch.mapping import maps
from rgbd_slam_tpu_torch.ops import lk_cuda
from rgbd_slam_tpu_torch.tracking import motion_model

torch.set_num_threads(2)

WIN = 9
PATCH = (WIN + 2) ** 2       # 121 samples of the template patch
PIXELS = WIN * WIN           # 81 window pixels
SETUP_FLOPS = PATCH * 9 + PIXELS * 10    # patch samples + structure tensor
ITER_FLOPS = PIXELS * 14


def _bowl_pyramids():
    """Two-level pyramids, 40x70 and 20x35.  Level 0 is a quadratic bowl
    (x - cx)^2 + (y - cy)^2 left of column 40 and flat right of it; the next
    image's bowl sits (2, 1) px further.  Level 1 is flat.  Around its centre the
    bowl's gradients are exact and sum to zero over the window, so the first
    Gauss-Newton step lands on the shift exactly and the second, a zero step,
    stops the point: 2 iterations."""
    y, x = np.mgrid[0:40, 0:70].astype(np.float32)

    def level0(cx, cy):
        img = (x - cx) ** 2 + (y - cy) ** 2
        img[:, 40:] = 7.0
        return torch.from_numpy(img)

    flat = torch.full((20, 35), 3.0)
    prev = [level0(20.0, 20.0), flat]
    nxt = [level0(22.0, 21.0), flat.clone()]
    # the bowl's centre, a point on the flat part, an invalid point
    pts = torch.tensor([[20.0, 20.0], [52.0, 20.0], [20.0, 20.0]])
    valid = torch.tensor([True, True, False])
    return prev, nxt, pts, valid


KW = dict(levels=1, win_h=WIN, win_w=WIN, iterations=10, eps=0.03)


def test_lk_work_counts_the_forward_pass_by_hand():
    prev, nxt, pts, valid = _bowl_pyramids()
    flow, ok = lk_cuda.lk_pyramid_reference(prev, nxt, pts, valid, **KW)
    np.testing.assert_array_equal(flow[0].numpy(), [2.0, 1.0])
    assert ok.tolist() == [True, False, False]

    work = lk_cuda.lk_work(prev, nxt, pts, valid, backward=False, **KW)
    top, fine = work["levels"]
    # level 1 is flat: singular for both valid points, so set-up only
    assert (top["direction"], top["level"], top["window"]) == ("forward", 1, (WIN, WIN))
    assert top["points"] == 2 and top["iterations"] == 0
    assert top["samples"] == 2 * PATCH and top["flops"] == 2 * SETUP_FLOPS
    # level 0: the bowl point takes 2 iterations, the flat point none
    assert fine["level"] == 0 and fine["iterations"] == 2 and fine["iterations_max"] == 2
    assert fine["samples"] == 2 * PATCH + 2 * PIXELS
    assert fine["flops"] == 2 * SETUP_FLOPS + 2 * ITER_FLOPS
    assert work["iterations"] == 2 and work["longest_chain"] == 2
    assert work["samples"] == 4 * PATCH + 2 * PIXELS == 646
    assert work["flops"] == 4 * SETUP_FLOPS + 2 * ITER_FLOPS == 9864
    # both pyramids once in f32, 3 points in (8 + 1 bytes) and out (8 + 1)
    assert work["bytes"] == 2 * 4 * (40 * 70 + 20 * 35) + 3 * 18 == 28054


def test_lk_work_counts_the_backward_pass_of_kept_points_only():
    prev, nxt, pts, valid = _bowl_pyramids()
    fwd = lk_cuda.lk_work(prev, nxt, pts, valid, backward=False, **KW)
    both = lk_cuda.lk_work(prev, nxt, pts, valid, backward=True, bwd_levels=0, **KW)
    back = both["levels"][-1]
    # only the bowl point survives the forward pass; its way back is 2 iterations
    assert (back["direction"], back["level"], back["points"]) == ("backward", 0, 1)
    assert back["iterations"] == 2
    assert back["samples"] == PATCH + 2 * PIXELS == 283
    assert back["flops"] == SETUP_FLOPS + 2 * ITER_FLOPS == 4167
    assert both["samples"] == fwd["samples"] + 283
    assert both["flops"] == fwd["flops"] + 4167 == 14031
    assert both["iterations"] == 4 and both["longest_chain"] == 4
    assert both["bytes"] == fwd["bytes"]
    # a backward pass from the top level adds that level's set-up for the point
    full = lk_cuda.lk_work(prev, nxt, pts, valid, backward=True, bwd_levels=None, **KW)
    assert full["flops"] == both["flops"] + SETUP_FLOPS
    assert [r["level"] for r in full["levels"]] == [1, 0, 1, 0]


def test_lk_level_work_counts_one_level():
    prev, nxt, pts, valid = _bowl_pyramids()
    zero = torch.zeros_like(pts)
    work = lk_cuda.lk_level_work(prev[0], nxt[0], pts, zero, valid, win_h=WIN, win_w=WIN)
    assert len(work["levels"]) == 1 and work["iterations"] == 2
    assert work["samples"] == 2 * PATCH + 2 * PIXELS
    assert work["flops"] == 2 * SETUP_FLOPS + 2 * ITER_FLOPS
    assert work["bytes"] == 2 * 4 * 40 * 70 + 3 * (8 + 8 + 1) + 3 * (8 + 1)
    # from the exact answer the first step is already under eps: 1 iteration
    exact = torch.tensor([[2.0, 1.0]]).expand(3, 2).contiguous()
    assert lk_cuda.lk_level_work(prev[0], nxt[0], pts, exact, valid, win_h=WIN,
                                 win_w=WIN)["iterations"] == 1
    # the iteration cap counts as reached
    capped = lk_cuda.lk_level_work(prev[0], nxt[0], pts, zero, valid, win_h=WIN,
                                   win_w=WIN, iterations=1)
    assert capped["iterations"] == 1 and capped["longest_chain"] == 1


# ---------------------------------------------------------------------------
# the staged tile of csrc/lk.cu, modelled in plain Python
# ---------------------------------------------------------------------------

MARGIN = 8   # LK_MARGIN


class StagedTile:
    """The kernels' destination sampling, line for line: a tile of the level
    (window + MARGIN on every side, cut to the level, widened to whole 4-pixel
    columns where the level is ``aligned``) is copied out around the window; a
    window is sampled from the copy, and one that the copy does not hold
    restages it first (``tile_around`` / ``region_of`` / ``tile_holds``)."""

    def __init__(self, img, wh, ww, aligned):
        self.img, self.wh, self.ww, self.aligned = img, wh, ww, aligned
        self.lh, self.lw = img.shape
        self.stages = 0
        self.tile = None

    def window_at(self, x, y):
        x0, y0 = np.floor(np.float32(x)), np.floor(np.float32(y))
        fx, fy = np.float32(x) - x0, np.float32(y) - y0
        xi = min(max(int(np.clip(x0, -1e9, 1e9)), 0), self.lw - (self.ww + 1))
        yi = min(max(int(np.clip(y0, -1e9, 1e9)), 0), self.lh - (self.wh + 1))
        return xi, yi, fx, fy

    def stage(self, xi, yi):
        w = min(self.ww + 1 + 2 * MARGIN, self.lw)
        self.h = min(self.wh + 1 + 2 * MARGIN, self.lh)
        x0 = min(max(xi - MARGIN, 0), self.lw - w)
        self.y0 = min(max(yi - MARGIN, 0), self.lh - self.h)
        self.x0 = x0 & ~3 if self.aligned else x0
        self.w = ((x0 + w + 3) & ~3) - self.x0 if self.aligned else w
        self.tile = self.img[self.y0:self.y0 + self.h, self.x0:self.x0 + self.w].copy()
        assert self.tile.shape == (self.h, self.w)   # the copy never leaves the level
        self.stages += 1

    def holds(self, xi, yi):
        return (self.tile is not None and xi >= self.x0
                and xi + self.ww + 1 <= self.x0 + self.w and yi >= self.y0
                and yi + self.wh + 1 <= self.y0 + self.h)

    def sample(self, x, y):
        xi, yi, fx, fy = self.window_at(x, y)
        if not self.holds(xi, yi):
            self.stage(xi, yi)
        r, c = yi - self.y0, xi - self.x0
        p = self.tile[r:r + self.wh + 1, c:c + self.ww + 1]
        one = np.float32(1.0)
        return ((one - fy) * ((one - fx) * p[:-1, :-1] + fx * p[:-1, 1:])
                + fy * ((one - fx) * p[1:, :-1] + fx * p[1:, 1:]))


def _walk(kind, rng, lh, lw, wh, ww):
    """Top-left positions of a window's successive iterations."""
    cx, cy = (lw - ww) / 2.0, (lh - wh) / 2.0
    if kind == "inside_margin":      # a track that stays within the margin of its start
        return [(cx, cy)] + [(cx + dx, cy + dy)
                             for dx, dy in rng.uniform(-MARGIN + 1, MARGIN - 1, (11, 2))]
    if kind == "beyond_margin":      # steps that leave the staged tile
        return [(cx + dx, cy + dy) for dx, dy in rng.uniform(-3 * MARGIN, 3 * MARGIN, (12, 2))]
    far = 40.0
    start = {"left": (-far, cy), "right": (lw + far, cy), "top": (cx, -far),
             "bottom": (cx, lh + far)}[kind]
    # from outside the level (the index clamps, the fraction does not), across
    # the border and along it
    return [(start[0] + t * (cx - start[0]) + jx, start[1] + t * (cy - start[1]) + jy)
            for t, (jx, jy) in zip(np.linspace(0.0, 1.0, 12), rng.uniform(-1, 1, (12, 2)))]


@pytest.mark.parametrize("shape,win,aligned", [((120, 160), (25, 25), True),
                                               ((120, 158), (25, 25), False),
                                               ((30, 40), (22, 32), True)],
                         ids=["level", "unaligned_level", "coarse_level"])
@pytest.mark.parametrize("kind", ["inside_margin", "beyond_margin", "left", "right", "top",
                                  "bottom"])
def test_staged_tile_sampling_equals_the_plain_sampler(kind, shape, win, aligned):
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    (lh, lw), (wh, ww) = shape, win
    staged = StagedTile(img, wh, ww, aligned)
    for x, y in _walk(kind, rng, lh, lw, wh, ww):
        want = lk_cuda._sample_windows(
            torch.from_numpy(img), torch.tensor([x], dtype=torch.float32),
            torch.tensor([y], dtype=torch.float32), wh, ww)[0]
        np.testing.assert_array_equal(staged.sample(x, y), want.numpy())
    whole_level = staged.w == lw and staged.h == lh
    if kind == "inside_margin" or whole_level:
        assert staged.stages == 1     # one copy serves every step
    elif kind == "beyond_margin":
        assert staged.stages > 1


# ---------------------------------------------------------------------------
# the default device
# ---------------------------------------------------------------------------

CAM = config.CameraIntrinsics(width=160, height=120, fx=130.0, fy=130.0, cx=80.0, cy=60.0)
CFG = config.SlamConfig(detection=config.DetectionConfig(optical_flow_pyramid_depth=2))


def _frames(n):
    scene = synthetic.RoomScene(CAM)
    return [scene.render(q, p) for q, p in synthetic.orbit_trajectory(n, speed_mm=6.0)]


def _numpy_state():
    return convert.state_to_numpy(engine.init_state(CAM, CFG, device="cpu"))


ENTRY_POINTS = {
    "init_state": lambda **kw: engine.init_state(CAM, CFG, **kw).quat,
    "run_frames": lambda **kw: runner.run_frames(_frames(1), CAM, CFG, with_planes=False,
                                                 **kw)[0].quat,
    "state_from_numpy": lambda **kw: convert.state_from_numpy(_numpy_state(), **kw).quat,
    "empty_point_map": lambda **kw: maps.empty_point_map(8, **kw).pos,
    "empty_plane_map": lambda **kw: maps.empty_plane_map(4, **kw).params,
    "motion_model_reset": lambda **kw: motion_model.reset(**kw).last_q,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name):
    """Without ``device`` an entry point uses the card, and raises where there is
    none; it never moves to the CPU by itself."""
    if torch.cuda.is_available():
        assert ENTRY_POINTS[name]().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_run_on_the_cpu_when_asked(name):
    assert ENTRY_POINTS[name](device="cpu").device.type == "cpu"


def test_run_frames_on_the_cpu_tracks():
    state, traj, stats = runner.run_frames(_frames(3), CAM, CFG, with_planes=False,
                                           device="cpu")
    assert stats.frame_count == 3 and stats.success_count == 3
    assert state.quat.device.type == "cpu" and len(traj.positions) == 3
