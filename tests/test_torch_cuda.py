"""Tests of the port that need an NVIDIA card; they skip without one.

Run them on the card with ``python -m pytest -m cuda tests/test_torch_cuda.py``.
This file imports no jax, so it runs where only PyTorch is installed.
"""

import types

import numpy as np
import pytest
import torch

from rgbd_slam_tpu_torch import config, convert, engine, synthetic
from rgbd_slam_tpu_torch.ops import fast, image, lk_cuda
from rgbd_slam_tpu_torch.pose.optimizer import PoseDraws, draw_pose_draws
from rgbd_slam_tpu_torch.pose.residuals import VariationNoise

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


@pytest.mark.cuda
def test_lk_kernel_matches_reference_at_engine_shapes(cuda):
    cam = config.TUM_FR1
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
    lk_cuda.build()
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
    m = cfg.mapping
    caps = (m.max_points_3d, m.max_points_2d, m.max_planes, m.max_lines)
    shapes = types.SimpleNamespace(point_world=torch.zeros(m.max_points_3d, 3),
                                   point_mask=torch.zeros(m.max_points_3d, dtype=torch.bool),
                                   capacities=caps)
    drop = torch.randint(0, 2 * cfg.detection.keypoint_refresh_frequency,
                         (m.max_points_3d,), generator=generator)
    return engine.StepDraws(drop=drop,
                            pose=draw_pose_draws(shapes, cfg.engine, generator))


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
    """A 640x480 StripeWallScene frame through the line detector on the card and
    on the CPU, by the closure rows and by the per-seed loop: the same tiles and
    counts, endpoints to 1e-2 px (a vertical segment may come in either
    orientation, see test_torch_lines.py)."""
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


@pytest.mark.cuda
def test_backend_on_the_card_runs_and_repeats_bit_equal(cuda):
    """run_frames with lines, BA and the pose graph on the card at a small size,
    twice: refines are accepted, one copy each way per solve, and the two
    trajectories are equal to the last bit."""
    from rgbd_slam_tpu_torch import runner

    cam = config.CameraIntrinsics(width=160, height=120, fx=130.0, fy=130.0,
                                  cx=80.0, cy=60.0)
    cfg = config.SlamConfig(
        detection=config.DetectionConfig(optical_flow_pyramid_depth=2,
                                         optical_flow_coarse_window_px=13),
        mapping=config.MappingConfig(max_points_3d=128, max_points_2d=64, max_planes=8,
                                     max_lines=4, max_tracked_points=64),
        engine=config.EngineConfig(pose_covariance_mc_iterations=16,
                                   ransac_hypothesis_batch=16, p3p_hypothesis_batch=8))
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
