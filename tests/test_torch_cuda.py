"""Tests of the port that need an NVIDIA card; they skip without one.

Run them on the card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
This file imports no jax, so it runs where only PyTorch is installed.
"""

import gc

import numpy as np
import pytest
import torch

from rgbd_slam_tpu_torch import config, convert, engine, synthetic
from rgbd_slam_tpu_torch.ops import fast, image, lk_cuda, lm_cuda, ransac_score_cuda
from rgbd_slam_tpu_torch.pose.optimizer import PoseDraws
from rgbd_slam_tpu_torch.pose.residuals import VariationNoise, prepare_features

#: 0.05 px: the kernel and the plain version sum the window's products in a
#: different order, which can move one convergence test by one iteration, and
#: that iteration moves a point by less than eps = 0.03 px
TOL_PX = 0.05


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _room_pair(cam, device):
    scene = synthetic.RoomScene(cam)
    poses = synthetic.orbit_trajectory(2, speed_mm=8.0)
    (g0, _), (g1, _) = [scene.render(q, p) for q, p in poses]
    g0 = torch.as_tensor(g0, device=device)
    g1 = torch.as_tensor(g1, device=device)
    return g0, g1


#: the Kinect v2's 1080p colour camera: level 0's 120x160 window does not fit a
#: CTA's shared memory twice, so the kernel sweeps that level in place
KV2_HD = config.CameraIntrinsics(width=1920, height=1080, fx=1081.37, fy=1081.37, cx=959.5,
                                 cy=539.5)


@pytest.mark.cuda
@pytest.mark.parametrize("cam", [config.TUM_FR1, KV2_HD], ids=["640x480", "1920x1080"])
def test_lk_kernel_matches_reference_at_engine_shapes(cuda, cam):
    det = config.DetectionConfig()
    g0, g1 = _room_pair(cam, cuda)
    levels = det.optical_flow_pyramid_depth
    p0, p1 = image.build_pyramid(g0, levels), image.build_pyramid(g1, levels)
    xy, _, valid = fast.detect_fast_grid(g0, threshold=20.0, low_threshold=10.0,
                                         max_points=128)
    kw = dict(levels=levels, win_h=cam.height // det.optical_flow_window_height,
              win_w=cam.width // det.optical_flow_window_width,
              iterations=det.optical_flow_iterations, eps=det.optical_flow_eps_px,
              max_roundtrip=det.optical_flow_roundtrip_px,
              bwd_levels=det.optical_flow_backward_depth,
              coarse_win=det.optical_flow_coarse_window_px,
              coarse_from_level=det.optical_flow_coarse_from_level)
    before = lk_cuda.LAUNCHES["lk_fwd_bwd"]
    k_pts, k_ok = lk_cuda.lk_fwd_bwd(p0, p1, xy, valid, **kw)
    torch.cuda.synchronize()
    assert lk_cuda.LAUNCHES["lk_fwd_bwd"] == before + 1
    r_pts, r_ok = lk_cuda.lk_fwd_bwd_reference(p0, p1, xy, valid, **kw)
    both = (k_ok & r_ok).cpu().numpy()
    assert both.sum() >= 64
    np.testing.assert_allclose(k_pts.cpu().numpy()[both], r_pts.cpu().numpy()[both],
                               atol=TOL_PX)
    # flags agree on all but points whose round trip sits at the 3 px gate
    assert (k_ok != r_ok).sum().item() <= 2


def _engine_lk_kwargs(cam, det):
    return dict(levels=det.optical_flow_pyramid_depth,
                win_h=cam.height // det.optical_flow_window_height,
                win_w=cam.width // det.optical_flow_window_width,
                iterations=det.optical_flow_iterations, eps=det.optical_flow_eps_px,
                coarse_win=det.optical_flow_coarse_window_px,
                coarse_from_level=det.optical_flow_coarse_from_level)


@pytest.mark.cuda
def test_lk_pyramid_kernel_matches_reference_at_engine_shapes(cuda):
    """Forward-only kernel, 99 FAST points (N % 4 != 0) at 640x480."""
    cam = config.TUM_FR1
    kw = _engine_lk_kwargs(cam, config.DetectionConfig())
    g0, g1 = _room_pair(cam, cuda)
    p0, p1 = image.build_pyramid(g0, kw["levels"]), image.build_pyramid(g1, kw["levels"])
    xy, _, valid = fast.detect_fast_grid(g0, max_points=99)
    before = lk_cuda.LAUNCHES["lk_pyramid"]
    k_flow, k_ok = lk_cuda.lk_pyramid(p0, p1, xy, valid, **kw)
    torch.cuda.synchronize()
    assert lk_cuda.LAUNCHES["lk_pyramid"] == before + 1
    r_flow, r_ok = lk_cuda.lk_pyramid_reference(p0, p1, xy, valid, **kw)
    np.testing.assert_array_equal(k_ok.cpu().numpy(), r_ok.cpu().numpy())
    ok = r_ok.cpu().numpy()
    assert ok.sum() >= 64
    np.testing.assert_allclose(k_flow.cpu().numpy()[ok], r_flow.cpu().numpy()[ok],
                               atol=TOL_PX)


@pytest.mark.cuda
def test_lk_level_kernel_matches_reference(cuda):
    """Single-level kernel at level 0, seeded with the plain pyramid tracker's
    level-1 result doubled."""
    cam = config.TUM_FR1
    kw = _engine_lk_kwargs(cam, config.DetectionConfig())
    g0, g1 = _room_pair(cam, cuda)
    p0, p1 = image.build_pyramid(g0, kw["levels"]), image.build_pyramid(g1, kw["levels"])
    xy, _, valid = fast.detect_fast_grid(g0, max_points=99)
    g1_flow, _ = lk_cuda.lk_pyramid_reference(
        p0[1:], p1[1:], (xy * 0.5).contiguous(), valid, **{**kw, "levels": kw["levels"] - 1})
    guesses = (g1_flow * 2.0).contiguous()
    before = lk_cuda.LAUNCHES["lk_level"]
    k_g, k_ok = lk_cuda.lk_level(p0[0], p1[0], xy, guesses, valid, win_h=kw["win_h"],
                                 win_w=kw["win_w"])
    torch.cuda.synchronize()
    assert lk_cuda.LAUNCHES["lk_level"] == before + 1
    r_g, r_ok = lk_cuda.lk_level_reference(p0[0], p1[0], xy, guesses, valid,
                                           win_h=kw["win_h"], win_w=kw["win_w"])
    np.testing.assert_array_equal(k_ok.cpu().numpy(), r_ok.cpu().numpy())
    ok = r_ok.cpu().numpy()
    np.testing.assert_allclose(k_g.cpu().numpy()[ok], r_g.cpu().numpy()[ok], atol=TOL_PX)


@pytest.mark.cuda
def test_lk_kernel_checks_its_inputs(cuda):
    pyr = image.build_pyramid(torch.zeros(120, 160, device=cuda), 2)
    pts = torch.zeros(8, 2, device=cuda)
    ok = torch.ones(8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        lk_cuda.lk_fwd_bwd(pyr, pyr, pts.double(), ok, levels=2, win_h=13, win_w=13)
    with pytest.raises(ValueError, match="shape"):
        lk_cuda.lk_fwd_bwd(pyr, pyr, pts, ok[:4], levels=2, win_h=13, win_w=13)
    with pytest.raises(ValueError, match="window"):
        lk_cuda.lk_level(pyr[2], pyr[2], pts, pts, ok, win_h=29, win_w=13)
    # empty inputs give empty outputs and launch nothing
    before = dict(lk_cuda.LAUNCHES)
    flow, status = lk_cuda.lk_pyramid(pyr, pyr, pts[:0], ok[:0], levels=2, win_h=13,
                                      win_w=13)
    assert flow.shape == (0, 2) and status.shape == (0,) and lk_cuda.LAUNCHES == before


@pytest.mark.cuda
def test_engine_step_launches_the_kernel_once_per_frame(cuda):
    cam = config.CameraIntrinsics(width=320, height=240, fx=260.0, fy=260.0,
                                  cx=160.0, cy=120.0)
    cfg = config.SlamConfig()
    scene = synthetic.RoomScene(cam)
    state = engine.init_state(cam, cfg, device=cuda)
    before = lk_cuda.LAUNCHES["lk_fwd_bwd"]
    for q, p in synthetic.orbit_trajectory(3):
        gray, depth = scene.render(q, p)
        state, out = engine.step(state, torch.as_tensor(gray, device=cuda),
                                 torch.as_tensor(depth, device=cuda), cam, cfg,
                                 with_planes=False)
        assert bool(out.success)
    assert lk_cuda.LAUNCHES["lk_fwd_bwd"] == before + 3


@pytest.mark.cuda
def test_plane_step_with_99_points_launches_the_forward_only_kernel(cuda):
    """max_tracked_points = 99 (N % 4 != 0): two forward-only launches a frame,
    no fused launch, planes in the map."""
    cam = config.CameraIntrinsics(width=320, height=240, fx=260.0, fy=260.0,
                                  cx=160.0, cy=120.0)
    cfg = config.SlamConfig(mapping=config.MappingConfig(max_tracked_points=99))
    scene = synthetic.RoomScene(cam)
    state = engine.init_state(cam, cfg, device=cuda)
    lk_cuda.LIBRARY.build()
    before = dict(lk_cuda.LAUNCHES)
    for q, p in synthetic.orbit_trajectory(3):
        gray, depth = scene.render(q, p)
        state, out = engine.step(state, torch.as_tensor(gray, device=cuda),
                                 torch.as_tensor(depth, device=cuda), cam, cfg)
        assert bool(out.success)
    assert lk_cuda.LAUNCHES["lk_pyramid"] == before["lk_pyramid"] + 6
    assert lk_cuda.LAUNCHES["lk_fwd_bwd"] == before["lk_fwd_bwd"]
    assert int((state.planes.fid >= 0).sum()) > 0


def _step_draws(cfg, generator):
    """Every draw of one engine step, from a CPU generator."""
    return engine.draw_step_draws(cfg, generator)


def _draws_to(draws, device):
    pose = draws.pose
    return engine.StepDraws(
        drop=draws.drop.to(device),
        pose=PoseDraws(pose.subset_priority.to(device), pose.p3p_priority.to(device),
                       VariationNoise(*[x.to(device) for x in pose.noise])))


@pytest.mark.cuda
@pytest.mark.parametrize("with_planes", [False, True], ids=["points", "planes"])
def test_engine_step_on_the_card_matches_the_cpu(cuda, with_planes):
    """Each frame steps the same state with the same draws on the CPU (plain LK)
    and on the card (the kernel): discrete outputs equal, the pose to 5e-2 mm
    (the LK results differ by < 0.05 px, see test_torch_engine.py)."""
    cam = config.CameraIntrinsics(width=160, height=120, fx=130.0, fy=130.0,
                                  cx=80.0, cy=60.0)
    cfg = config.SlamConfig(detection=config.DetectionConfig(optical_flow_pyramid_depth=2))
    scene = synthetic.RoomScene(cam, depth_noise=config.DepthNoiseModel())
    gen = torch.Generator().manual_seed(0)
    state = engine.init_state(cam, cfg, device="cpu")
    discrete = ("success", "is_lost", "n_point_matches", "n_point_inliers",
                "n_points_alive", "n_detected", "point_matched", "point_fid",
                "n_planes_alive", "n_cylinders", "cylinder_cells", "plane_evicted")
    for q, p in synthetic.orbit_trajectory(5, speed_mm=6.0):
        gray, depth = scene.render(q, p)
        draws = _step_draws(cfg, gen)
        on_card = convert.state_from_numpy(convert.state_to_numpy(state), device=cuda)
        state, out = engine.step(state, torch.from_numpy(gray), torch.from_numpy(depth),
                                 cam, cfg, with_planes=with_planes, draws=draws)
        _, k_out = engine.step(on_card, torch.as_tensor(gray, device=cuda),
                               torch.as_tensor(depth, device=cuda), cam, cfg,
                               with_planes=with_planes, draws=_draws_to(draws, cuda))
        for name in discrete:
            np.testing.assert_array_equal(getattr(k_out, name).cpu().numpy(),
                                          getattr(out, name).numpy(), err_msg=name)
        np.testing.assert_allclose(k_out.position.cpu().numpy(), out.position.numpy(),
                                   atol=5e-2)
        np.testing.assert_allclose(k_out.quat.cpu().numpy(), out.quat.numpy(), atol=1e-5)
        assert bool(out.success)


def _level0_case(device, n=99):
    """Level-0 inputs of the single-level kernel: the 640x480 pair, FAST points
    and the plain pyramid tracker's level-1 result doubled as guesses."""
    cam = config.TUM_FR1
    kw = _engine_lk_kwargs(cam, config.DetectionConfig())
    g0, g1 = _room_pair(cam, device)
    p0, p1 = image.build_pyramid(g0, kw["levels"]), image.build_pyramid(g1, kw["levels"])
    xy, _, valid = fast.detect_fast_grid(g0, max_points=n)
    flow, _ = lk_cuda.lk_pyramid_reference(
        p0[1:], p1[1:], (xy * 0.5).contiguous(), valid, **{**kw, "levels": kw["levels"] - 1})
    return kw, p0, p1, xy, valid, (flow * 2.0).contiguous()


@pytest.mark.cuda
def test_lk_level_kernel_restages_its_tile(cuda):
    """Guesses 9-11 px off on each axis, more than the 8 px the kernel stages
    around its window: a window that comes back leaves the staged tile, and the
    kernel must still follow the plain version."""
    kw, p0, p1, xy, valid, guesses = _level0_case(cuda)
    rng = np.random.default_rng(0)
    off = rng.uniform(9, 11, guesses.shape) * rng.choice([-1.0, 1.0], guesses.shape)
    far = (guesses + torch.as_tensor(off.astype(np.float32), device=cuda)).contiguous()
    lvl = dict(win_h=kw["win_h"], win_w=kw["win_w"], iterations=30)
    k_g, k_ok = lk_cuda.lk_level(p0[0], p1[0], xy, far, valid, **lvl)
    torch.cuda.synchronize()
    r_g, r_ok = lk_cuda.lk_level_reference(p0[0], p1[0], xy, far, valid, **lvl)
    np.testing.assert_array_equal(k_ok.cpu().numpy(), r_ok.cpu().numpy())
    # rows that moved more than the margin (and one pixel) up or down left the tile
    assert int(((r_g - far)[:, 1].abs() > 9).sum()) >= 32
    ok = r_ok.cpu().numpy()
    np.testing.assert_allclose(k_g.cpu().numpy()[ok], r_g.cpu().numpy()[ok], atol=TOL_PX)


@pytest.mark.cuda
def test_lk_level_kernel_with_a_window_larger_than_its_registers_hold(cuda):
    """A 61x61 window is 3721 pixels, over the 3072 the threads keep in
    registers: the rest runs from shared memory."""
    kw, p0, p1, xy, valid, guesses = _level0_case(cuda, n=40)
    k_g, k_ok = lk_cuda.lk_level(p0[0], p1[0], xy, guesses, valid, win_h=61, win_w=61)
    torch.cuda.synchronize()
    r_g, r_ok = lk_cuda.lk_level_reference(p0[0], p1[0], xy, guesses, valid, win_h=61,
                                           win_w=61)
    np.testing.assert_array_equal(k_ok.cpu().numpy(), r_ok.cpu().numpy())
    ok = r_ok.cpu().numpy()
    assert ok.sum() >= 32
    np.testing.assert_allclose(k_g.cpu().numpy()[ok], r_g.cpu().numpy()[ok], atol=TOL_PX)


@pytest.mark.cuda
def test_lk_kernels_repeat_bit_equal(cuda):
    """Two launches on the same inputs give the same bits: the block sums use no
    atomics and one fixed order."""
    kw, p0, p1, xy, valid, guesses = _level0_case(cuda, n=128)
    calls = {
        "lk_fwd_bwd": lambda: lk_cuda.lk_fwd_bwd(p0, p1, xy, valid, max_roundtrip=3.0,
                                                 bwd_levels=0, **kw),
        "lk_pyramid": lambda: lk_cuda.lk_pyramid(p0, p1, xy, valid, **kw),
        "lk_level": lambda: lk_cuda.lk_level(p0[0], p1[0], xy, guesses, valid,
                                             win_h=kw["win_h"], win_w=kw["win_w"]),
    }
    for name, call in calls.items():
        a_val, a_ok = call()
        b_val, b_ok = call()
        torch.cuda.synchronize()
        assert torch.equal(a_val, b_val) and torch.equal(a_ok, b_ok), name


@pytest.mark.cuda
def test_lk_pyramid_kernel_on_levels_off_the_16_byte_grid(cuda):
    """Levels whose first pixel is not 16-byte aligned are staged 4 bytes at a
    time; the results equal those on aligned copies of the same levels, bit for
    bit."""
    cam = config.TUM_FR1
    kw = _engine_lk_kwargs(cam, config.DetectionConfig())
    g0, g1 = _room_pair(cam, cuda)
    p0, p1 = image.build_pyramid(g0, kw["levels"]), image.build_pyramid(g1, kw["levels"])
    xy, _, valid = fast.detect_fast_grid(g0, max_points=99)

    def shifted(level):
        flat = torch.empty(level.numel() + 1, device=cuda)
        view = flat[1:].view(level.shape)
        view.copy_(level)
        assert view.data_ptr() % 16 == 4 and view.is_contiguous()
        return view

    a_flow, a_ok = lk_cuda.lk_pyramid(p0, p1, xy, valid, **kw)
    b_flow, b_ok = lk_cuda.lk_pyramid([shifted(a) for a in p0], [shifted(a) for a in p1],
                                      xy, valid, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a_flow, b_flow) and torch.equal(a_ok, b_ok)


@pytest.mark.cuda
@pytest.mark.parametrize("min_tiles", [2, 3], ids=["closure", "loop"])
def test_detect_lines_on_the_card_matches_the_cpu(cuda, min_tiles):
    """A 640x480 StripeWallScene frame through the line detector on the card
    (the seeds grown by the kernel) and on the CPU (by the closure rows, or
    the per-seed loop for min_tiles 3): the same tiles and counts, endpoints
    and directions to 1e-2 px, strengths to 1e-5 (a vertical segment may come
    in either orientation, see test_torch_lines.py)."""
    from rgbd_slam_tpu_torch.features import lines

    cam = config.TUM_FR1
    scene = synthetic.StripeWallScene(cam, texture_scale=0.03, stripe_period_z=2400.0)
    gray = scene.render(*synthetic.lateral_trajectory(4, speed_mm=4.0)[3])[0]
    cpu = lines.detect_lines(torch.from_numpy(gray), min_tiles=min_tiles)
    card = lines.detect_lines(torch.as_tensor(gray, device=cuda), min_tiles=min_tiles)
    assert int(cpu.valid.sum()) >= 4
    np.testing.assert_array_equal(card.valid.cpu().numpy(), cpu.valid.numpy())
    np.testing.assert_array_equal(card.tile_count.cpu().numpy(), cpu.tile_count.numpy())
    flip = ((card.direction.cpu() * cpu.direction).sum(-1) < 0)[:, None]
    p0 = torch.where(flip, card.p1.cpu(), card.p0.cpu())
    p1 = torch.where(flip, card.p0.cpu(), card.p1.cpu())
    np.testing.assert_allclose(p0.numpy(), cpu.p0.numpy(), atol=1e-2)
    np.testing.assert_allclose(p1.numpy(), cpu.p1.numpy(), atol=1e-2)
    direction = torch.where(flip, -card.direction.cpu(), card.direction.cpu())
    np.testing.assert_allclose(direction.numpy(), cpu.direction.numpy(), atol=1e-2)
    np.testing.assert_allclose(card.strength.cpu().numpy(), cpu.strength.numpy(), rtol=1e-5)


def _line_grow_case(name):
    """(edges, is_line, weight) numpy of a line growth case: a random graph
    (``chip_smoke.random_line_graph``, size and density in the name), a
    drawn-lines test image or a 640x480 striped-wall frame's tile graph."""
    import chip_smoke

    kind, _, size = name.rpartition("_")
    if kind in chip_smoke.DRAWN_LINES:
        graph = chip_smoke.line_graph(chip_smoke.drawn_lines_image(kind), "cpu")
    elif kind == "stripe_wall":
        frames = chip_smoke.stripe_wall_frames(config.TUM_FR1, int(size) + 1)[0]
        graph = chip_smoke.line_graph(frames[int(size)][0], "cpu")
    else:
        gw, gh = (int(n) for n in size.split("x"))
        density = {"sparse": 0.1, "maze": 0.45, "dense": 0.8, "full": 1.0,
                   "equal": 0.45}[kind]
        return chip_smoke.random_line_graph(
            gh, gw, 5, density, line_share=1.0 if kind == "full" else 0.7,
            weight_levels=3 if kind == "equal" else None)
    return tuple(x.numpy() for x in graph)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sparse_40x30", "maze_40x30", "dense_40x30", "full_40x30",
                                  "equal_40x30", "maze_120x67", "dense_120x67",
                                  "maze_37x29", "sparse_7x5", "dense_1x70", "dense_65x1",
                                  "horizontal_320", "diagonal_320", "two_lines_320",
                                  "flat_320", "stripe_wall_3", "stripe_wall_29"])
def test_line_grow_kernel_matches_its_plain_version(cuda, name):
    """The kernel's members and proceed equal the plain version's on the same
    card tensors to the bit for min_tiles 1-4 (the closure rows up to 2, the
    loop above), and its
    rounds a seed the numpy model's (``tests/test_torch_line_grow.py``), on
    random directed 8-neighbour graphs from sparse to full (1920x1080's
    120x67 among them, past the 48 KB a CTA gets without the opt-in), with
    equal weights, on the drawn-lines images and on striped-wall frames.
    One launch a call."""
    from rgbd_slam_tpu_torch.ops import line_grow_cuda
    from test_torch_line_grow import kernel_model

    edges, is_line, weight = _line_grow_case(name)
    on_card = [torch.from_numpy(x).to(cuda) for x in (edges, is_line, weight)]
    for min_tiles in (1, 2, 3, 4):
        before = line_grow_cuda.LAUNCHES["line_grow"]
        members, proceed, rounds = line_grow_cuda.grow_seeds_cuda(*on_card, min_tiles,
                                                                  details=True)
        torch.cuda.synchronize()
        assert line_grow_cuda.LAUNCHES["line_grow"] == before + 1
        want_m, want_p = line_grow_cuda.grow_seeds_reference(*on_card, min_tiles)
        assert torch.equal(proceed, want_p) and torch.equal(members, want_m)
        model_m, model_p, model_rounds = kernel_model(edges, is_line, weight, min_tiles)
        np.testing.assert_array_equal(members.cpu().numpy(), model_m)
        np.testing.assert_array_equal(proceed.cpu().numpy(), model_p)
        np.testing.assert_array_equal(rounds.cpu().numpy(), model_rounds)


@pytest.mark.cuda
def test_line_grow_kernel_repeats_and_replays_bit_equal(cuda):
    """32 launches on a maze give the first's outputs; the kernel recorded in
    a CUDA graph and replayed on new inputs copied into the captured ones
    gives the eager launch's outputs on each."""
    from rgbd_slam_tpu_torch.ops import line_grow_cuda

    cases = [[torch.from_numpy(x).to(cuda) for x in _line_grow_case(n)]
             for n in ("maze_40x30", "stripe_wall_3", "full_40x30", "equal_40x30")]
    first = line_grow_cuda.grow_seeds_cuda(*cases[0], 2)
    for _ in range(31):
        again = line_grow_cuda.grow_seeds_cuda(*cases[0], 2)
        assert all(torch.equal(a, b) for a, b in zip(again, first))
    inputs = [x.clone() for x in cases[0]]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        line_grow_cuda.grow_seeds_cuda(*inputs, 2)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = line_grow_cuda.grow_seeds_cuda(*inputs, 2)
    for case in cases:
        for x, y in zip(inputs, case):
            x.copy_(y)
        graph.replay()
        want = line_grow_cuda.grow_seeds_cuda(*case, 2)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, want))


@pytest.mark.cuda
@pytest.mark.parametrize("frame", [3, 15, 29])
@pytest.mark.parametrize("min_tiles", [2, 3])
def test_detect_lines_with_the_kernel_equals_its_plain_growth(cuda, monkeypatch, frame,
                                                              min_tiles):
    """``detect_lines`` on the card on a 640x480 striped-wall frame: every
    field of ``DetectedLines`` equal to the bit whether the kernel grows the
    seeds or the plain version does on the same card tensors (every float
    after the growth is the same tensor code)."""
    import chip_smoke
    from rgbd_slam_tpu_torch.features import lines
    from rgbd_slam_tpu_torch.ops import line_grow_cuda

    gray = torch.as_tensor(chip_smoke.stripe_wall_frames(config.TUM_FR1, frame + 1)[0][frame][0],
                           device=cuda)
    before = line_grow_cuda.LAUNCHES["line_grow"]
    kernel = lines.detect_lines(gray, min_tiles=min_tiles)
    assert line_grow_cuda.LAUNCHES["line_grow"] == before + 1
    monkeypatch.setattr(lines, "grow_seeds", line_grow_cuda.grow_seeds_reference)
    plain = lines.detect_lines(gray, min_tiles=min_tiles)
    assert int(plain.valid.sum()) >= 4
    _assert_bit_equal(kernel, plain, f"frame {frame}")


@pytest.mark.cuda
def test_lines_step_graph_runs_the_line_growth_kernel_once_a_frame(cuda, monkeypatch):
    """The points + lines step (planes off) as one CUDA graph over 6
    striped-wall frames with the plain growth patched to raise: every replay
    equal to the eager step to the bit, no host sync while the graph replays
    (``set_sync_debug_mode("error")``), one kernel launch a frame and one in
    the warm-up step, in a profiled replay the kernel once; ``detect_lines``
    alone runs the kernel once and no product of [T, T] matrices."""
    import chip_smoke
    from torch.autograd import DeviceType
    from torch.overrides import TorchFunctionMode
    from torch.profiler import ProfilerActivity, profile

    from rgbd_slam_tpu_torch import step_graph
    from rgbd_slam_tpu_torch.features import lines
    from rgbd_slam_tpu_torch.ops import line_grow_cuda

    def refuse(*args, **kw):
        raise AssertionError("the plain growth ran on the card")

    monkeypatch.setattr(line_grow_cuda, "grow_seeds_reference", refuse)
    cam, cfg = config.TUM_FR1, config.SlamConfig()
    frames = [tuple(torch.as_tensor(a, device=cuda) for a in f)
              for f in chip_smoke.stripe_wall_frames(cam, 6)[0]]
    eager = engine.init_state(cam, cfg, seed=0, device=cuda)
    graph = step_graph.StepGraph(engine.init_state(cam, cfg, seed=0, device=cuda), cam, cfg,
                                 with_planes=False, with_lines=True)
    launches = 0
    try:
        for i, (gray, depth) in enumerate(frames):
            before = line_grow_cuda.LAUNCHES["line_grow"]
            if i == 3:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    g_state, g_out = graph.step(gray, depth)
                    torch.cuda.synchronize()
            elif i > 0:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    g_state, g_out = graph.step(gray, depth)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            else:
                g_state, g_out = graph.step(gray, depth)
            launches += line_grow_cuda.LAUNCHES["line_grow"] - before
            eager, e_out = engine.step(eager, gray, depth, cam, cfg, with_planes=False,
                                       with_lines=True)
            _assert_bit_equal(g_out, e_out, f"frame {i} output")
            _assert_bit_equal(g_state, eager, f"frame {i} state")
    finally:
        graph.close()
    assert graph.warmup_steps == 1
    assert launches == len(frames) + 1
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert sum(n.startswith("line_grow_kernel") for n in names) == 1
    # the detector alone: the kernel once, and no product of tile-by-tile
    # matrices (its one product is the moments' einsum over the 16 seeds)
    products = []

    class Products(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if getattr(func, "__name__", "") in ("__matmul__", "matmul", "mm", "bmm", "einsum"):
                products.append([tuple(a.shape) for a in args if isinstance(a, torch.Tensor)])
            return func(*args, **(kwargs or {}))

    before = line_grow_cuda.LAUNCHES["line_grow"]
    with Products():
        lines.detect_lines(frames[3][0])
    assert line_grow_cuda.LAUNCHES["line_grow"] == before + 1
    assert products == [[(16, 1200), (16, 1200, 2), (16, 1200, 2)]], products


def _small_backend_setup():
    """A 160x120 camera and a configuration cut to its size, for runs of the
    backend on the card."""
    cam = config.CameraIntrinsics(width=160, height=120, fx=130.0, fy=130.0,
                                  cx=80.0, cy=60.0)
    cfg = config.SlamConfig(
        detection=config.DetectionConfig(optical_flow_pyramid_depth=2,
                                         optical_flow_coarse_window_px=13),
        mapping=config.MappingConfig(max_points_3d=128, max_points_2d=64, max_planes=8,
                                     max_lines=4, max_tracked_points=64),
        engine=config.EngineConfig(pose_covariance_mc_iterations=16,
                                   ransac_hypothesis_batch=16, p3p_hypothesis_batch=8))
    return cam, cfg


@pytest.mark.cuda
def test_backend_on_the_card_runs_and_repeats_bit_equal(cuda):
    """run_frames with lines, BA and the pose graph on the card at a small size,
    twice: refines are accepted, one copy each way per solve, and the two
    trajectories are equal to the last bit."""
    from rgbd_slam_tpu_torch import runner

    cam, cfg = _small_backend_setup()
    scene = synthetic.RoomScene(cam, depth_noise=config.DepthNoiseModel())
    frames = [scene.render(q, p) for q, p in synthetic.orbit_trajectory(24, speed_mm=8.0)]
    runs = []
    for _ in range(2):
        _, traj, stats = runner.run_frames(frames, cam, cfg, with_lines=True, ba_every=8,
                                           device=cuda)
        assert stats.success_count == 24 and stats.ba_runs >= 2 and stats.ba_accepted >= 1
        assert stats.backend_uploads == stats.backend_readbacks \
            == stats.ba_runs + stats.graph_solves
        runs.append((traj.positions_array(), np.array(traj.quaternions)))
    assert np.isfinite(runs[0][0]).all()
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


@pytest.mark.cuda
def test_rectify_depth_on_the_card_matches_the_cpu(cuda):
    """The scatter-min on the card against the CPU's, with deterministic
    algorithms demanded: it must neither raise nor warn, and repeat itself."""
    import warnings

    from rgbd_slam_tpu_torch.ops.depth_cloud import rectify_depth

    cam = config.TUM_FR1
    scene = synthetic.RoomScene(cam, depth_noise=config.DepthNoiseModel())
    depth = scene.render(*synthetic.orbit_trajectory(1)[0])[1]
    ext = np.eye(4)
    ext[0, 3] = 25.0
    want = rectify_depth(torch.from_numpy(depth), cam, cam, ext)
    torch.use_deterministic_algorithms(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = rectify_depth(torch.from_numpy(depth).to(cuda), cam, cam, ext)
            again = rectify_depth(torch.from_numpy(depth).to(cuda), cam, cam, ext)
    finally:
        torch.use_deterministic_algorithms(False)
    assert torch.equal(got, again)
    got = got.cpu()
    # the card fuses multiply-adds: a pixel within rounding of an edge may move
    assert int(((got == 0) != (want == 0)).sum()) <= 4
    both = (got != 0) & (want != 0)
    assert int(((got - want).abs()[both] > 1e-3).sum()) <= 4
    assert int((got == 0).sum()) > int((torch.from_numpy(depth) == 0).sum())


@pytest.mark.cuda
def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """A state saved from the card loads back onto it bit for bit, generator
    included, and onto the CPU with the same leaves (and a generator seeded from
    the saved state: a card's generator state means nothing to a CPU's)."""
    from rgbd_slam_tpu_torch.io import checkpoint

    cam = config.CameraIntrinsics(width=320, height=240, fx=260.0, fy=260.0, cx=160.0,
                                  cy=120.0)
    cfg = config.SlamConfig()
    scene = synthetic.RoomScene(cam)
    state = engine.init_state(cam, cfg, seed=3, device=cuda)
    for q, p in synthetic.orbit_trajectory(2):
        g, d = scene.render(q, p)
        state, _ = engine.step(state, torch.as_tensor(g, device=cuda),
                               torch.as_tensor(d, device=cuda), cam, cfg)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save_state(state, path)
    loaded = checkpoint.load_state(path, engine.init_state(cam, cfg, seed=8, device=cuda))
    on_cpu = checkpoint.load_state(path, engine.init_state(cam, cfg, device="cpu"))
    for a, b, c in zip(checkpoint._leaves(state), checkpoint._leaves(loaded),
                       checkpoint._leaves(on_cpu)):
        assert b.device.type == "cuda" and c.device.type == "cpu"
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
        assert torch.equal(a.cpu().nan_to_num(), c.nan_to_num())
    assert torch.equal(state.generator.get_state(), loaded.generator.get_state())
    twice = checkpoint.load_state(path, on_cpu)
    assert torch.equal(on_cpu.generator.get_state(), twice.generator.get_state())
    draws = [torch.rand(4, generator=s.generator, device=cuda) for s in (state, loaded)]
    assert torch.equal(*draws)


def _collectives_rank(rank, world_size, init_method, out_path):
    from rgbd_slam_tpu_torch import dryrun
    from rgbd_slam_tpu_torch.parallel import ba

    dryrun.join_group(rank, world_size, init_method)
    try:
        import torch.distributed as dist

        group = dist.group.WORLD
        device = torch.device("cuda")
        local = torch.arange(6, dtype=torch.float32, device=device).reshape(2, 3) + 10 * rank
        gathered = ba.all_gather_rows(local, group)
        full = torch.arange(4 * world_size, dtype=torch.float32,
                            device=device).reshape(-1, 2) * (rank + 1)
        scattered = ba.all_gather_rows(ba.reduce_scatter_rows(full, group), group)
        if rank == 0:
            np.savez(out_path, gathered=gathered.cpu().numpy(),
                     scattered=scattered.cpu().numpy())
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_gloo_collectives_on_cuda_tensors(cuda, tmp_path):
    """``all_gather_rows`` and ``reduce_scatter_rows`` over two ``gloo`` ranks
    that share the card, against what they give on the CPU (plain arithmetic)."""
    from rgbd_slam_tpu_torch import dryrun

    out = str(tmp_path / "out.npz")
    dryrun.run_ranks(_collectives_rank, 2, args=(out,), timeout=120.0)
    with np.load(out) as data:
        want = np.concatenate([np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r
                               for r in range(2)])
        np.testing.assert_array_equal(data["gathered"], want)
        np.testing.assert_array_equal(data["scattered"],
                                      3.0 * np.arange(8, dtype=np.float32).reshape(-1, 2))


# ---------------------------------------------------------------------------
# the components kernel and the step as one CUDA graph
# ---------------------------------------------------------------------------

def _components_case(name):
    """(edges [4, gh, gw], planar [C], gh, gw) of a named grid."""
    import chip_smoke
    from rgbd_slam_tpu_torch.ops import components_cuda

    if name == "full_1xmax":
        # the longest row the wrapper takes, one component: a chain of 32-cell
        # runs joined at every warp's last lane
        cells = components_cuda.MAX_SMEM_BYTES // components_cuda.SMEM_BYTES_PER_CELL
        return np.ones((4, 1, cells), bool), np.ones(cells, bool), 1, cells
    kind, size = name.rsplit("_", 1)
    gw, gh = map(int, size.split("x"))
    grid = {"serpentine": lambda: chip_smoke.serpentine_grid(gh, gw),
            "spiral": lambda: chip_smoke.spiral_grid(gh, gw),
            "full": lambda: (np.ones((4, gh, gw), bool), np.ones(gh * gw, bool)),
            # edges into planar cells only, as _edge_maps gives them
            "random": lambda: chip_smoke.random_grid(gh, gw, 0),
            "random_nonplanar_ends": lambda: chip_smoke.random_grid(gh, gw, 1,
                                                                    planar_ends=False)}[kind]()
    return (*grid, gh, gw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["random_32x24", "serpentine_32x24", "full_32x24",
                                  "random_7x5", "random_160x120", "spiral_32x24",
                                  "random_nonplanar_ends_32x24", "random_40x30", "full_1xmax"])
def test_components_kernel_matches_its_plain_version(cuda, name):
    """The kernel's labels equal the plain version's on random planar masks
    (the 640x480 grid, a grid under one warp, 1,200 cells at 16 px cells and
    19,200: more cells than threads, and shared memory past the 48 KB
    default), with edges into planar cells only, as ``_edge_maps`` gives, or
    at either end non-planar (they join nothing); on a serpentine and a spiral
    one-cell-wide component (the longest chains, the spiral cut in two); on
    the full grid in one component; and on the longest row the wrapper takes.
    One launch a call; a grid past shared memory raises."""
    from rgbd_slam_tpu_torch.ops import components_cuda

    edges, planar, gh, gw = _components_case(name)
    want = components_cuda.components_reference(torch.from_numpy(edges),
                                                torch.from_numpy(planar), gh, gw)
    before = components_cuda.LAUNCHES["components"]
    got = components_cuda.connected_components(torch.from_numpy(edges).to(cuda),
                                               torch.from_numpy(planar).to(cuda), gh, gw)
    torch.cuda.synchronize()
    assert components_cuda.LAUNCHES["components"] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    with pytest.raises(ValueError, match="shared memory"):
        components_cuda.connected_components(
            torch.zeros((4, 240, 320), dtype=torch.bool, device=cuda),
            torch.zeros(240 * 320, dtype=torch.bool, device=cuda), 240, 320)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["serpentine_32x24", "random_160x120"])
def test_components_kernel_repeats_bit_equal(cuda, name):
    """32 launches give the same labels: the hooks race on their atomics, and
    every order must reach the same roots."""
    from rgbd_slam_tpu_torch.ops import components_cuda

    edges, planar, gh, gw = _components_case(name)
    edges, planar = torch.from_numpy(edges).to(cuda), torch.from_numpy(planar).to(cuda)
    first = components_cuda.connected_components(edges, planar, gh, gw)
    runs = [components_cuda.connected_components(edges, planar, gh, gw) for _ in range(31)]
    torch.cuda.synchronize()
    for labels in runs:
        assert torch.equal(labels, first)


@pytest.mark.cuda
def test_components_kernel_replayed_from_a_graph_equals_its_launch(cuda):
    """The kernel recorded in a CUDA graph, replayed on new inputs copied into
    the captured ones, gives the eager launch's labels on each."""
    from rgbd_slam_tpu_torch.ops import components_cuda

    cases = [_components_case(n) for n in ("random_32x24", "spiral_32x24", "serpentine_32x24")]
    edges = torch.from_numpy(cases[0][0]).to(cuda)
    planar = torch.from_numpy(cases[0][1]).to(cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        components_cuda.connected_components(edges, planar, 24, 32)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = components_cuda.connected_components(edges, planar, 24, 32)
    for e, p, gh, gw in cases:
        edges.copy_(torch.from_numpy(e))
        planar.copy_(torch.from_numpy(p))
        graph.replay()
        want = components_cuda.connected_components(edges, planar, gh, gw)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        np.testing.assert_array_equal(want.cpu().numpy(), components_cuda.components_reference(
            torch.from_numpy(e), torch.from_numpy(p), gh, gw).numpy())


def _bits(t):
    return t.detach().contiguous().view(-1).view(torch.uint8).cpu()


def _assert_bit_equal(a, b, what):
    from rgbd_slam_tpu_torch.step_graph import tensor_leaves

    la, lb = tensor_leaves(a), tensor_leaves(b)
    assert len(la) == len(lb), what
    for k, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, k)
        assert torch.equal(_bits(x), _bits(y)), (what, k)


def _room_frames(cam, n, device):
    scene = synthetic.RoomScene(cam, depth_noise=config.DepthNoiseModel())
    return [tuple(torch.as_tensor(a, device=device) for a in scene.render(q, p))
            for q, p in synthetic.orbit_trajectory(n, speed_mm=4.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("with_lines", [False, True], ids=["planes", "lines"])
def test_step_graph_equals_the_eager_step(cuda, with_lines):
    """``StepGraph`` over 10 frames at 640x480 against ``engine.step`` in a
    loop from the same seed: every state leaf and output equal to the bit at
    every frame, and the launch counts those of the eager steps (one warm-up
    step more)."""
    from rgbd_slam_tpu_torch import step_graph
    from rgbd_slam_tpu_torch.ops import components_cuda, line_grow_cuda

    cam, cfg = config.TUM_FR1, config.SlamConfig()
    frames = _room_frames(cam, 10, cuda)
    eager = engine.init_state(cam, cfg, seed=0, device=cuda)
    graph = step_graph.StepGraph(engine.init_state(cam, cfg, seed=0, device=cuda), cam, cfg,
                                 with_lines=with_lines)
    counters = ((lk_cuda.LAUNCHES, "lk_fwd_bwd"), (components_cuda.LAUNCHES, "components"),
                (lm_cuda.LAUNCHES, "lm_solve"), (line_grow_cuda.LAUNCHES, "line_grow"),
                (ransac_score_cuda.LAUNCHES, "ransac_score"))
    counts = [0, 0, 0, 0, 0]
    try:
        for i, (gray, depth) in enumerate(frames):
            before = [c[k] for c, k in counters]
            g_state, g_out = graph.step(gray, depth)
            counts = [n + c[k] - b for n, (c, k), b in zip(counts, counters, before)]
            eager, e_out = engine.step(eager, gray, depth, cam, cfg, with_lines=with_lines)
            _assert_bit_equal(g_out, e_out, f"frame {i} output")
            _assert_bit_equal(g_state, eager, f"frame {i} state")
            assert torch.equal(g_state.generator.get_state(), eager.generator.get_state())
    finally:
        graph.close()
    # one launch of each kernel a replay (two of the LM and the scoring
    # kernels; the line growth kernel with lines on), and as many in the
    # warm-up step
    assert graph.warmup_steps == 1 and counts == [11, 11, 22, 11 * with_lines, 22], counts


@pytest.mark.cuda
def test_run_frames_on_the_card_equals_the_eager_runner(cuda, monkeypatch, tmp_path):
    """``run_frames`` (the step as a CUDA graph) with the backend, the streamed
    map and a frame callback, over 30 frames at 640x480, against the same
    runner with ``engine.step`` run eagerly: trajectories, callbacks, counts and
    map files equal to the bit."""
    from rgbd_slam_tpu_torch import runner, step_graph

    cam, cfg = config.TUM_FR1, config.SlamConfig()
    scene = synthetic.RoomScene(cam, depth_noise=config.DepthNoiseModel())
    frames = [scene.render(q, p) for q, p in synthetic.orbit_trajectory(30, speed_mm=4.0)]

    def run(tag):
        seen = []
        path = str(tmp_path / f"{tag}.obj")
        state, traj, stats = runner.run_frames(
            frames, cam, cfg, ba_every=8, export_map=path, device=cuda,
            on_frame=lambda i, s, o, dt: seen.append((o.position.cpu(), s.next_id.cpu())))
        with open(path) as f:
            return state, traj, stats, seen, f.read()

    graphed = run("graph")
    monkeypatch.setattr(step_graph, "stepper", step_graph.EagerStep)
    eager = run("eager")
    assert graphed[2].warmup_steps == 1 and eager[2].warmup_steps == 0
    assert graphed[2].ba_accepted >= 1
    np.testing.assert_array_equal(graphed[1].positions_array(), eager[1].positions_array())
    np.testing.assert_array_equal(np.array(graphed[1].quaternions),
                                  np.array(eager[1].quaternions))
    for key in ("keyframe_count", "ba_runs", "ba_accepted", "graph_solves", "map_streamed",
                "map_alive_at_end", "success_count", "lost_count"):
        assert getattr(graphed[2], key) == getattr(eager[2], key), key
    for (p_a, n_a), (p_b, n_b) in zip(graphed[3], eager[3], strict=True):
        assert torch.equal(p_a, p_b) and torch.equal(n_a, n_b)
    assert graphed[4] == eager[4]
    _assert_bit_equal(graphed[0], eager[0], "final state")


def _sync_sites(fn):
    """Package lines of the host syncs ``fn`` makes, by
    ``torch.cuda.set_sync_debug_mode("warn")``."""
    import traceback
    import warnings
    from pathlib import Path

    package = str(Path(engine.__file__).parent)
    sites = []
    inside = [False]

    def record(message, *_args, **_kw):
        # a warning the mode's own switch raises is not ``fn``'s
        if inside[0] and "synchroniz" in str(message):
            stack = traceback.extract_stack()[:-1]
            ours = [f for f in stack if f.filename.startswith(package)]
            sites.append(f"{Path(ours[-1].filename).name}:{ours[-1].lineno}" if ours
                         else "outside the package: " + " < ".join(
                             f"{Path(f.filename).name}:{f.lineno} {f.name}"
                             for f in reversed(stack[-6:])))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            inside[0] = True
            fn()
        finally:
            inside[0] = False
            torch.cuda.set_sync_debug_mode("default")
    return sites


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["planes", "lines", "points", "tracked_99", "prediction"])
def test_a_warmed_step_reads_the_host_nowhere(cuda, path):
    """One eager step at 640x480 warms every path's libraries and caches; the
    next makes no host sync, by ``set_sync_debug_mode``: first listing every
    site it finds ("warn"), then raising on the first ("error")."""
    import dataclasses

    cam, cfg = config.TUM_FR1, config.SlamConfig()
    kw = dict(with_planes=path != "points", with_lines=path == "lines")
    if path == "tracked_99":
        cfg = dataclasses.replace(cfg, mapping=dataclasses.replace(cfg.mapping,
                                                                   max_tracked_points=99))
    if path == "prediction":
        cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
            cfg.engine, use_motion_model_prediction=True))
    frames = _room_frames(cam, 3, cuda)
    state = engine.init_state(cam, cfg, seed=0, device=cuda)
    state, _ = engine.step(state, *frames[0], cam, cfg, **kw)
    gc.collect()   # what earlier tests left (a graph's pool) is not freed inside the watch
    torch.cuda.synchronize()
    box = [state]

    def step(frame):
        box[0], _ = engine.step(box[0], *frame, cam, cfg, **kw)

    assert _sync_sites(lambda: step(frames[1])) == []
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(frames[2])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def _lm_case(name, device):
    """(packed inputs, coeffs0 [B, 6], iterations) of an LM
    case of ``torch_lm_cases`` on ``device``: the main path's two shapes, or
    one of the CPU test's cases or of the kernel's edge cases."""
    import torch_lm_cases

    if name.startswith("main_"):
        feats, c0, iterations = torch_lm_cases.main_path_batches(11)[name[len("main_"):]]
        weights = None
    else:
        feats, c0, weights, iterations = torch_lm_cases.case(name)
    if weights is not None:
        feats = feats.with_masks(*(w > 0 for w in feats.split_unified(weights)))
    feats = type(feats)(*(t.to(device) for t in feats))
    inputs = lm_cuda.pack(prepare_features(feats, torch_lm_cases.CAM), torch_lm_cases.CAM)
    c0 = c0.to(device)
    return inputs, (c0 if c0.dim() > 1 else c0[None]), iterations


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["main_hypotheses", "main_refit_mc", "hypotheses", "refit",
                                  "unbatched_features", "single_pose", "weights",
                                  "batched_weights", "edges", "planes_and_lines_empty",
                                  "features_356", "features_45", "no_live_member_one_warp",
                                  "no_live_member", "iterations_0", "iterations_64"])
def test_lm_kernel_matches_its_plain_version(cuda, name):
    """The LM kernel against ``lm_solve_reference`` on the card: at the main
    path's two shapes (32 hypotheses over 6/6/3/6 subsets, 10 iterations; 101
    refit + Monte-Carlo members over 256/128/32/16 features, 6 iterations)
    and on the CPU test's cases (a point behind the camera, a zero-length
    inverse-depth segment and a degenerate line; empty plane and line blocks;
    unbatched features, a single pose, weights), and at the kernel's edges:
    356 and 45 feature slots (several features a thread; two warps), a member
    with no live feature beside others (one warp and two; shared blocks and
    per-member masks in one launch), 0 and 64 iterations.  One linearization,
    then the full LM held to the plain version step by step (``chip_smoke.lm_replay``,
    at ``chip_smoke``'s ``LM_*`` tolerances): every linearization, decision and
    trial of the kernel's run, and its result the best point's."""
    import chip_smoke

    inputs, c0, iterations = _lm_case(name, cuda)
    before = lm_cuda.LAUNCHES["lm_solve"]
    lin = lm_cuda.lm_solve(inputs, c0, 0, 1e-3, details=True)
    torch.cuda.synchronize()
    assert lm_cuda.LAUNCHES["lm_solve"] == before + 1
    assert torch.equal(lin.coeffs, c0) and torch.equal(lin.accepts, torch.zeros_like(lin.accepts))
    lin_err = chip_smoke.normal_equation_errors(inputs, 1e-3, lin.points, lin.costs, lin.jtjs,
                                                lin.jtrs)
    assert all(float(lin_err[k].max()) <= 1 for k in ("jtj", "jtr", "cost")), lin_err

    got = lm_cuda.lm_solve(inputs, c0, iterations, 1e-3, details=True)
    assert torch.isfinite(got.coeffs).all() and torch.isfinite(got.cost).all()
    assert got.points.shape == (c0.shape[0], iterations + 1, 6)
    assert torch.equal(got.points[:, 0], c0)
    replay = chip_smoke.lm_replay(inputs, 1e-3, got)
    bad = chip_smoke.lm_failures(replay)
    assert not bad.any(), {k: v[bad] for k, v in replay.items()}
    if name.startswith("no_live_member"):   # the member with no live row: cost 0
        assert float(got.cost[1 if name == "no_live_member" else 3]) == 0.0


@pytest.mark.cuda
def test_lm_kernel_repeats_bit_equal(cuda):
    """A fixed-order block reduction and no atomics: two launches on the same
    inputs give the same bits, at both main-path shapes."""
    for name in ("main_hypotheses", "main_refit_mc"):
        inputs, c0, iterations = _lm_case(name, cuda)
        first = lm_cuda.lm_solve(inputs, c0, iterations, 1e-3, details=True)
        second = lm_cuda.lm_solve(inputs, c0, iterations, 1e-3, details=True)
        _assert_bit_equal(first, second, name)


@pytest.mark.cuda
def test_lm_kernel_raises_and_never_falls_back(cuda, monkeypatch):
    """On the card ``optimizer.lm_solve`` launches the kernel or raises: a
    failed build and a failed launch raise, and the plain version is never
    called."""
    from rgbd_slam_tpu_torch.ops import nvcc
    from rgbd_slam_tpu_torch.pose import optimizer

    def refuse(*args, **kw):
        raise AssertionError("the plain LM ran on the card")

    monkeypatch.setattr(lm_cuda, "lm_solve_reference", refuse)
    import torch_lm_cases

    feats, c_cpu, _, _ = torch_lm_cases.cases()["single_pose"]
    feats = type(feats)(*(t.to(cuda) for t in feats))
    coeffs, cost = optimizer.lm_solve(c_cpu.to(cuda), feats, torch_lm_cases.CAM)
    assert coeffs.device.type == "cuda" and torch.isfinite(cost)

    class Refusing:
        @staticmethod
        def lm_solve_launch(*args):
            return 1   # cudaErrorInvalidValue

    monkeypatch.setattr(lm_cuda.LIBRARY, "lib", Refusing())
    with pytest.raises(RuntimeError, match="LM kernel launch failed"):
        optimizer.lm_solve(c_cpu.to(cuda), feats, torch_lm_cases.CAM)

    def no_nvcc(*args, **kw):
        raise RuntimeError("nvcc failed on lm.cu")

    monkeypatch.setattr(lm_cuda.LIBRARY, "lib", None)
    monkeypatch.setattr(nvcc, "load_library", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        optimizer.lm_solve(c_cpu.to(cuda), feats, torch_lm_cases.CAM)


@pytest.mark.cuda
def test_graph_step_runs_the_lm_kernel_and_not_its_plain_version(cuda, monkeypatch):
    """``run_frames`` on the card (the step as a CUDA graph) over 4 frames with
    ``lm_solve_reference`` patched to raise: the plain LM is off the main path,
    and the kernel runs twice a frame and twice in the warm-up step."""
    from rgbd_slam_tpu_torch import runner

    def refuse(*args, **kw):
        raise AssertionError("the plain LM ran on the card")

    monkeypatch.setattr(lm_cuda, "lm_solve_reference", refuse)
    cam, cfg = config.TUM_FR1, config.SlamConfig()
    scene = synthetic.RoomScene(cam, depth_noise=config.DepthNoiseModel())
    frames = [scene.render(q, p) for q, p in synthetic.orbit_trajectory(4, speed_mm=4.0)]
    before = lm_cuda.LAUNCHES["lm_solve"]
    _, traj, stats = runner.run_frames(frames, cam, cfg, device=cuda)
    assert stats.warmup_steps == 1
    assert lm_cuda.LAUNCHES["lm_solve"] - before == 2 * (4 + 1)
    assert np.isfinite(traj.positions_array()).all()


@pytest.mark.cuda
def test_backend_graphs_equal_the_eager_solves_at_full_width(cuda):
    """The windowed BA's packed solve at 8 keyframes x 512 landmarks x 8
    observations and the pose graph's at 64 nodes and 256 edges, each on two
    problems through the one ``SolveGraph`` that ``refine`` and
    ``PoseGraph.solve`` replay: every output equal to the eager solve on the
    card to the bit."""
    import functools

    import chip_smoke
    from rgbd_slam_tpu_torch import solve_graph
    from rgbd_slam_tpu_torch.parallel import keyframes, pose_graph

    cam = config.TUM_FR1
    windows = [chip_smoke.full_window(cam, seed, cuda) for seed in (0, 1)]
    graphs = [chip_smoke.full_pose_graph(seed, cuda) for seed in (0, 1)]
    solvers = [
        (windows[0]._get_solver(cam, 8, None),
         functools.partial(windows[0]._solve, cam=cam, iterations=8),
         [keyframes._pack_problem(w.build_problem()) for w in windows]),
        (graphs[0]._get_solver(10),
         functools.partial(pose_graph._solve_packed, max_nodes=64, max_edges=256,
                           iterations=10),
         [g._pack() for g in graphs])]
    try:
        for solve, fn, bufs in solvers:
            assert isinstance(solve, solve_graph.SolveGraph)
            eager = solve_graph.EagerSolve(fn, cuda)
            for buf in bufs:
                buf = torch.from_numpy(buf)
                _assert_bit_equal(solve(buf), eager(buf), fn)
    finally:
        windows[0].close()
        graphs[0].close()


@pytest.mark.cuda
def test_one_backend_graph_per_key_and_no_eager_solve_on_the_card(cuda, monkeypatch):
    """``run_frames`` with the backend on the card records one graph for the
    refine and one for the graph solve, and replays them: ``ba.ba_solve`` and
    ``solve_pose_graph`` run in Python only to warm up and to be captured.  A
    window asked for another iteration count records a second graph, as
    ``jax.jit`` retraces on a new static argument."""
    import chip_smoke
    from rgbd_slam_tpu_torch import runner, solve_graph
    from rgbd_slam_tpu_torch.parallel import ba, pose_graph

    records = []
    real_record = solve_graph.SolveGraph._record

    def counted(self, inputs):
        records.append(self)
        return real_record(self, inputs)

    monkeypatch.setattr(solve_graph.SolveGraph, "_record", counted)
    cam, cfg = _small_backend_setup()
    scene = synthetic.RoomScene(cam, depth_noise=config.DepthNoiseModel())
    frames = [scene.render(q, p) for q, p in synthetic.orbit_trajectory(16, speed_mm=8.0)]
    with chip_smoke.traced_solves() as traced:
        _, traj, stats = runner.run_frames(frames, cam, cfg, ba_every=4, kf_min_trans_mm=5.0,
                                           device=cuda)
    assert stats.ba_runs >= 3 and stats.graph_solves >= 2, stats
    assert traced == {"ba": 2, "pose_graph": 2} and len(records) == 2
    assert np.isfinite(traj.positions_array()).all()

    records.clear()
    window = chip_smoke.full_window(config.TUM_FR1, 0, cuda)
    try:
        with chip_smoke.traced_solves() as traced:
            costs = [window.refine(config.TUM_FR1, iterations=it)[2] for it in (8, 8, 4, 8)]
        assert len(window._solvers) == 2 and len(records) == 2
        assert traced == {"ba": 4, "pose_graph": 0}
        assert [len(c) for c in costs] == [8, 8, 4, 8]
        np.testing.assert_array_equal(costs[0], costs[1])
        np.testing.assert_array_equal(costs[0], costs[3])
        assert window.transfers == {"uploads": 4, "readbacks": 4}
    finally:
        window.close()


@pytest.mark.cuda
def test_singular_window_is_refused_on_the_card(cuda):
    """A full-width window whose reduced system is indefinite (a negative
    position anchor) through the refine's graph: the first cost is finite and
    the rest NaN, so the runner's accept test refuses it."""
    import chip_smoke
    from rgbd_slam_tpu_torch import solve_graph

    window = chip_smoke.full_window(config.TUM_FR1, 0, cuda)
    window.anchor_weights = (1e-3, -1e6, 1e-3)
    try:
        _, _, costs = window.refine(config.TUM_FR1, iterations=3)
        assert isinstance(next(iter(window._solvers.values())), solve_graph.SolveGraph)
    finally:
        window.close()
    assert np.isfinite(costs[0]) and np.isnan(costs[1:]).all()
    assert not (np.isfinite(costs).all() and costs[-1] < costs[0])


def _plane_depths(device, n_room=8, n_tunnel=8):
    """(name, depth on the card) of the plane path's first RoomScene orbit
    frames (depth noise on) and the tunnel leg's first frames, where the
    cylinders live."""
    import chip_smoke

    cam = config.TUM_FR1
    room = chip_smoke.room_frames(cam, n_room)[0] if n_room else []
    tunnel = chip_smoke._tunnel_depths(cam, n_tunnel)
    return ([(f"room{i}", torch.as_tensor(d, device=device)) for i, (_, d) in enumerate(room)]
            + [(f"tunnel{i}", torch.as_tensor(d, device=device)) for i, d in enumerate(tunnel)])


@pytest.mark.cuda
def test_cells_kernel_matches_its_plain_version(cuda):
    """The per-cell pass's kernels against ``cells_reference`` on the card at
    640x480 on room and tunnel frames, by ``chip_smoke.check_cells_frame``'s
    rules (continuous fields within the ``CELL_*`` tolerances, discrete ones
    equal or flipped inside their gate's margin); one launch a call."""
    import chip_smoke
    from rgbd_slam_tpu_torch.ops import cells_cuda

    det = config.DetectionConfig()
    for name, depth in _plane_depths(cuda):
        before = cells_cuda.LAUNCHES["cells"]
        chip_smoke.check_cells_frame(depth, config.TUM_FR1, det, name=name)
        assert cells_cuda.LAUNCHES["cells"] == before + 1


@pytest.mark.cuda
def test_cylinders_kernel_matches_its_plain_version(cuda):
    """The cylinder stage's kernel against ``cylinders_reference`` on the
    card, by ``chip_smoke.check_cylinder_stage``'s rules, on the inputs
    ``find_primitives`` gives it on room and tunnel frames and with the
    tunnel's region cut in six candidates (more than the four slots)."""
    import chip_smoke

    det = config.DetectionConfig()
    live = 0
    for name, depth in _plane_depths(cuda):
        _, n, _, _ = chip_smoke.check_cylinders_frame(config.TUM_FR1, det, depth, name=name)
        live += n
    assert live >= 8   # a live region on every tunnel frame
    grid, member, try_cyl, min_act = chip_smoke.cylinder_inputs(
        config.TUM_FR1, det, _plane_depths(cuda, 0, 1)[0][1])
    r = int((try_cyl & member.any(dim=-1)).nonzero()[0])
    cells = (member[r] & grid.planar).nonzero().flatten()
    member = torch.zeros_like(member)
    for i, chunk in enumerate(cells.chunk(6)):
        member[i, chunk] = True
    n, _, _ = chip_smoke.check_cylinder_stage((grid, member, member.any(dim=-1), min_act),
                                              det, name="tunnel_in_six")
    assert n == 4


@pytest.mark.cuda
def test_primitive_kernels_repeat_bit_equal(cuda):
    """Fixed-order reductions and no atomics: two launches of each kernel on
    the same inputs give the same bits."""
    import chip_smoke
    from rgbd_slam_tpu_torch.ops import cells_cuda, cylinders_cuda

    det = config.DetectionConfig()
    for name, depth in _plane_depths(cuda, 1, 1):
        _assert_bit_equal(cells_cuda.cell_pass(depth, config.TUM_FR1, det),
                          cells_cuda.cell_pass(depth, config.TUM_FR1, det), name)
        grid, member, try_cyl, min_act = chip_smoke.cylinder_inputs(config.TUM_FR1, det,
                                                                    depth)
        _assert_bit_equal(
            cylinders_cuda.cylinder_stage(grid, member, try_cyl, det, min_act),
            cylinders_cuda.cylinder_stage(grid, member, try_cyl, det, min_act), name)


@pytest.mark.cuda
def test_primitive_kernels_raise_and_never_fall_back(cuda, monkeypatch):
    """On the card ``find_primitives`` launches the two kernels or raises: a
    failed launch and a failed build raise, and the plain versions are never
    called."""
    from rgbd_slam_tpu_torch.features import primitives
    from rgbd_slam_tpu_torch.ops import cells_cuda, cylinders_cuda, nvcc

    def refuse(*args, **kw):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(cells_cuda, "cells_reference", refuse)
    monkeypatch.setattr(cylinders_cuda, "cylinders_reference", refuse)
    depth = _plane_depths(cuda, 0, 1)[0][1]
    det = config.DetectionConfig()
    planes, cyls = primitives.find_primitives(depth, config.TUM_FR1, det)
    assert int(cyls.valid.sum()) >= 1 and planes.valid.device.type == "cuda"

    class Refusing:
        @staticmethod
        def cells_launch(*args):
            return 1   # cudaErrorInvalidValue

        @staticmethod
        def cylinders_launch(*args):
            return 1

    for module, what in ((cells_cuda, "cells"), (cylinders_cuda, "cylinders")):
        with monkeypatch.context() as mp:
            mp.setattr(module.LIBRARY, "lib", Refusing())
            with pytest.raises(RuntimeError, match=f"{what} kernel launch failed"):
                primitives.find_primitives(depth, config.TUM_FR1, det)

        def no_nvcc(*args, **kw):
            raise RuntimeError(f"nvcc failed on {what}.cu")

        with monkeypatch.context() as mp:
            mp.setattr(module.LIBRARY, "lib", None)
            mp.setattr(nvcc, "load_library", no_nvcc)
            with pytest.raises(RuntimeError, match=f"nvcc failed on {what}.cu"):
                primitives.find_primitives(depth, config.TUM_FR1, det)


@pytest.mark.cuda
def test_graph_step_runs_the_primitive_kernels_and_not_their_plain_versions(cuda,
                                                                           monkeypatch):
    """``run_frames`` on the card (the step as a CUDA graph) over 4 frames with
    planes on and the plain versions patched to raise: each kernel runs once a
    frame and once in the warm-up step; with planes off, never."""
    from rgbd_slam_tpu_torch import runner
    from rgbd_slam_tpu_torch.ops import cells_cuda, cylinders_cuda

    def refuse(*args, **kw):
        raise AssertionError("a plain version ran on the card")

    monkeypatch.setattr(cells_cuda, "cells_reference", refuse)
    monkeypatch.setattr(cylinders_cuda, "cylinders_reference", refuse)
    cam, cfg = config.TUM_FR1, config.SlamConfig()
    scene = synthetic.RoomScene(cam, depth_noise=config.DepthNoiseModel())
    frames = [scene.render(q, p) for q, p in synthetic.orbit_trajectory(4, speed_mm=4.0)]
    for with_planes, per_frame in ((True, 1), (False, 0)):
        before = (cells_cuda.LAUNCHES["cells"], cylinders_cuda.LAUNCHES["cylinders"])
        _, traj, stats = runner.run_frames(frames, cam, cfg, with_planes=with_planes,
                                           device=cuda)
        assert stats.warmup_steps == 1
        assert cells_cuda.LAUNCHES["cells"] - before[0] == per_frame * (4 + 1)
        assert cylinders_cuda.LAUNCHES["cylinders"] - before[1] == per_frame * (4 + 1)
        assert np.isfinite(traj.positions_array()).all()


def _replayed(fn, replays, eager_between=True):
    """``fn()`` (a kernel wrapper on fixed inputs) captured into one CUDA graph
    after a warm-up on a side stream, then: its output after each of
    ``replays`` replays, then an eager call's, then one more replay's; every
    output copied out as it comes."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    copies = []
    for _ in range(replays):
        graph.replay()
        copies.append([x.clone() for x in out])
    if eager_between:
        copies.append([x.clone() for x in fn()])
        graph.replay()
        copies.append([x.clone() for x in out])
    torch.cuda.synchronize()
    return copies


@pytest.mark.cuda
def test_cell_pass_from_a_graph_keeps_its_bits(cuda):
    """The cell pass replayed from a CUDA graph three times, then called
    eagerly, then replayed again gives the eager pass's bits each time: the
    pair of kernels keeps no state from one launch to the next, however it
    was launched."""
    from rgbd_slam_tpu_torch.ops import cells_cuda

    det = config.DetectionConfig()
    for name, depth in _plane_depths(cuda, 1, 1):
        want = cells_cuda.cell_pass(depth, config.TUM_FR1, det)
        for k, got in enumerate(_replayed(
                lambda: cells_cuda.cell_pass(depth, config.TUM_FR1, det), 3)):
            _assert_bit_equal(want, tuple(got), f"{name} call {k}")


def _tunnel_cut(device, pieces):
    """The cylinder stage's inputs of the first tunnel frame with its region's
    planar cells cut into ``pieces`` candidate regions."""
    import chip_smoke

    det = config.DetectionConfig()
    grid, member, try_cyl, min_act = chip_smoke.cylinder_inputs(
        config.TUM_FR1, det, _plane_depths(device, 0, 1)[0][1])
    r = int((try_cyl & member.any(dim=-1)).nonzero()[0])
    cells = (member[r] & grid.planar).nonzero().flatten()
    member = torch.zeros_like(member)
    for i, chunk in enumerate(cells.chunk(pieces)):
        member[i, chunk] = True
    return grid, member, member.any(dim=-1), min_act


@pytest.mark.cuda
@pytest.mark.parametrize("pieces", [4, 6])
def test_cylinder_stage_with_every_slot_live(cuda, pieces):
    """The tunnel's region cut into 4 candidates (each holds a slot) and into
    6 (four hold the slots): all four slots live, by
    ``chip_smoke.check_cylinder_stage``'s rules; two launches, and three
    replays of a CUDA graph around an eager call, give the same bits."""
    import chip_smoke
    from rgbd_slam_tpu_torch.ops import cylinders_cuda

    det = config.DetectionConfig()
    grid, member, try_cyl, min_act = inputs = _tunnel_cut(cuda, pieces)
    n, _, _ = chip_smoke.check_cylinder_stage(inputs, det, name=f"tunnel_in_{pieces}")
    assert n == 4

    def stage():
        return cylinders_cuda.cylinder_stage(grid, member, try_cyl, det, min_act)

    want = stage()
    assert int(want.selected.sum()) == 4 and bool(want.valids[want.selected].any())
    _assert_bit_equal(want, stage(), "repeat")
    for k, got in enumerate(_replayed(stage, 3)):
        _assert_bit_equal(want, tuple(got), f"call {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("patch", [16, 32, 33])
def test_plane_kernels_at_other_patch_sizes(cuda, patch):
    """The cell pass and the cylinder stage against their plain versions, by
    ``chip_smoke``'s rules, with 16 px cells (1,200 cells: a larger grid than
    the main path's), 32 px cells (300 cells of 1,024 pixels: a lane's larger
    register share) and 33 px cells (the largest patch the kernel takes: its
    33rd column and row lie past the warp's lanes; the map cut to 627x462,
    19x14 cells), on a room frame and a tunnel frame; the cell pass repeats
    its bits."""
    import dataclasses

    import chip_smoke
    from rgbd_slam_tpu_torch.ops import cells_cuda

    det = dataclasses.replace(config.DetectionConfig(), depth_patch_size_px=patch)
    for name, depth in _plane_depths(cuda, 1, 1):
        h, w = depth.shape
        depth = depth[:h // patch * patch, :w // patch * patch].contiguous()
        chip_smoke.check_cells_frame(depth, config.TUM_FR1, det, name=f"{name}_{patch}px")
        chip_smoke.check_cylinders_frame(config.TUM_FR1, det, depth, name=f"{name}_{patch}px")
        _assert_bit_equal(cells_cuda.cell_pass(depth, config.TUM_FR1, det),
                          cells_cuda.cell_pass(depth, config.TUM_FR1, det), name)


#: seeds of each kind of feature set the scoring's card test draws: 8 kinds x
#: 25 seeds = 200 feature sets
SCORE_SEEDS = 25


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["main", "lines_off", "planes_off", "sparse", "empty", "odd",
                                  "tiny", "wide"])
def test_ransac_score_kernel_matches_its_plain_version(cuda, kind):
    """The scoring kernel against its plain version run on the card, on
    ``SCORE_SEEDS`` seeded feature sets of ``torch_score_cases.KINDS[kind]``
    (lines or planes all masked, rows past the caps, types that meet inside a
    warp, two passes of 1,024 rows, nothing live) with 96 hypotheses (a NaN
    one, two equal ones, a tenth not ok), then the refit's one pose: every
    tested value equal to the bit, and the masks, counts, scores, best index,
    its coefficients and score equal.  Tolerance: a decision may differ only
    where the plain version's value lies within ``SCORE_FLIP_ULPS`` ulps of its
    limit (``chip_smoke.score_agreement``), since the two round the same chain
    in the same order; none is expected.  Each launch counts once and repeats
    to the bit."""
    import chip_smoke
    import torch_score_cases as sc

    ransac = config.RansacConfig()
    for seed in range(SCORE_SEEDS):
        coeffs, ok, prep, caps = sc.case(seed, kind, device=cuda)
        for c, o, cp in ((coeffs, ok, caps), (coeffs[seed % coeffs.shape[0]], None, None)):
            before = ransac_score_cuda.LAUNCHES["ransac_score"]
            got, got_values = ransac_score_cuda.score(c, prep, sc.CAM, ransac, o, cp,
                                                      details=True)
            again = ransac_score_cuda.score(c, prep, sc.CAM, ransac, o, cp)
            torch.cuda.synchronize()
            assert ransac_score_cuda.LAUNCHES["ransac_score"] == before + 2
            want, want_values = ransac_score_cuda.score_reference(c, prep, sc.CAM, ransac, o,
                                                                  cp, details=True)
            fields = chip_smoke.score_agreement(got, got_values, want, want_values,
                                                ransac_score_cuda.capacities(prep),
                                                f"{kind} {seed}")
            assert fields["outputs_equal"] and fields["values_bit_equal"] == 1.0, fields
            _assert_bit_equal(again, got, f"{kind} {seed} repeat")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["main", "lines_off", "planes_off", "sparse"])
def test_compute_optimized_pose_equals_it_with_the_plain_scoring(cuda, monkeypatch, kind):
    """``compute_optimized_pose`` on the card with the scoring kernel, and again
    with the plain scoring patched in, from the same draws (five seeded
    feature sets): every output equal to the bit; the kernel ran twice a call
    and the plain version's call not at all."""
    import torch_score_cases as sc
    from rgbd_slam_tpu_torch.geometry import se3
    from rgbd_slam_tpu_torch.pose import optimizer

    ransac, eng = config.RansacConfig(), config.EngineConfig()
    for seed in range(5):
        feats, c_true = sc.features(seed, kind)
        feats = type(feats)(*(t.to(cuda) for t in feats))
        c0 = (c_true + torch.tensor([8.0, -5.0, 4.0, 0.004, -0.003, 0.002])).to(cuda)
        quat0, position0 = se3.coefficients_to_pose(c0)
        generator = torch.Generator(device=cuda).manual_seed(seed)
        draws = optimizer.draw_pose_draws(feats, eng, generator)
        before = ransac_score_cuda.LAUNCHES["ransac_score"]
        got = optimizer.compute_optimized_pose(quat0, position0, feats, sc.CAM, ransac, eng,
                                               draws=draws)
        torch.cuda.synchronize()
        assert ransac_score_cuda.LAUNCHES["ransac_score"] == before + 2
        with monkeypatch.context() as m:
            m.setattr(ransac_score_cuda, "score", ransac_score_cuda.score_reference)
            m.setattr(ransac_score_cuda, "score_cuda", None)
            want = optimizer.compute_optimized_pose(quat0, position0, feats, sc.CAM, ransac,
                                                    eng, draws=draws)
        assert ransac_score_cuda.LAUNCHES["ransac_score"] == before + 2
        _assert_bit_equal(got, want, f"{kind} {seed}")


@pytest.mark.cuda
def test_ransac_score_kernel_raises_and_never_falls_back(cuda, monkeypatch):
    """On the card the wrapper launches the kernel or raises: a failed launch
    and a failed build raise, and the plain version is never called."""
    import torch_score_cases as sc
    from rgbd_slam_tpu_torch.ops import nvcc

    def refuse(*args, **kw):
        raise AssertionError("the plain scoring ran on the card")

    monkeypatch.setattr(ransac_score_cuda, "score_reference", refuse)
    coeffs, ok, prep, caps = sc.case(0, "tiny", device=cuda)
    got = ransac_score_cuda.score(coeffs, prep, sc.CAM, ok=ok, caps=caps)
    assert got.best.device.type == "cuda"

    class Refusing:
        @staticmethod
        def ransac_score_launch(*args):
            return 1   # cudaErrorInvalidValue

    monkeypatch.setattr(ransac_score_cuda.LIBRARY, "lib", Refusing())
    with pytest.raises(RuntimeError, match="scoring kernel launch failed"):
        ransac_score_cuda.score(coeffs, prep, sc.CAM, ok=ok, caps=caps)

    def no_nvcc(*args, **kw):
        raise RuntimeError("nvcc failed on ransac_score.cu")

    monkeypatch.setattr(ransac_score_cuda.LIBRARY, "lib", None)
    monkeypatch.setattr(nvcc, "load_library", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ransac_score_cuda.score(coeffs[0], prep, sc.CAM)


@pytest.mark.cuda
def test_graph_step_runs_the_scoring_kernel_and_not_its_plain_version(cuda, monkeypatch):
    """``run_frames`` on the card (the step as a CUDA graph) over 4 frames with
    ``score_reference`` patched to raise: the plain scoring is off the main
    path, and the kernel runs twice a frame and twice in the warm-up step."""
    from rgbd_slam_tpu_torch import runner

    def refuse(*args, **kw):
        raise AssertionError("the plain scoring ran on the card")

    monkeypatch.setattr(ransac_score_cuda, "score_reference", refuse)
    cam, cfg = config.TUM_FR1, config.SlamConfig()
    scene = synthetic.RoomScene(cam, depth_noise=config.DepthNoiseModel())
    frames = [scene.render(q, p) for q, p in synthetic.orbit_trajectory(4, speed_mm=4.0)]
    before = ransac_score_cuda.LAUNCHES["ransac_score"]
    _, traj, stats = runner.run_frames(frames, cam, cfg, device=cuda)
    assert stats.warmup_steps == 1
    assert ransac_score_cuda.LAUNCHES["ransac_score"] - before == 2 * (4 + 1)
    assert np.isfinite(traj.positions_array()).all()
