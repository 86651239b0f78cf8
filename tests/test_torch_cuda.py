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
    state = engine.init_state(cam, cfg)
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
