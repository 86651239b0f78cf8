"""The cylinder stage's kernel on grids past one CTA's shared memory, on the
card (marked ``cuda``; they skip without one).

Run them on the card with ``python -m pytest --noconftest -m cuda
tests/test_torch_cylinders_card.py``.  This file imports no jax, so it runs
where only PyTorch is installed.

* The global-memory path, forced on the 640x480 grids that the shared-memory
  path takes, gives that path's bits on every output: the two paths run the
  same arithmetic in the same order.
* At 5,184 cells (1920x1080 at 20 px: a room frame with no live region, and a
  tunnel frame with a live cylinder, whose MSAC rounds score every cell) and
  at 4,800 cells (640x480 at 8 px), the kernel against ``cylinders_reference``
  by ``chip_smoke.check_cylinder_stage``'s rules (the card check of the
  shared-memory path: the gate and the selection equal or flipped within
  their margin, a round's inliers equal or a flip its MSAC rule permits);
  two launches give the same bits.
* ``find_primitives`` on the card against the plain version on the CPU at
  those two grids: the same planes and cylinders (the cell pass's kernels sum
  in another order than the plain version, within ``chip_smoke``'s ``CELL_*``
  tolerances, so the fits agree to a tolerance, not to the bit).
"""

import dataclasses

import numpy as np
import pytest
import torch

from rgbd_slam_tpu_torch import config, synthetic
from rgbd_slam_tpu_torch.features import primitives
from rgbd_slam_tpu_torch.ops import cylinders_cuda

#: the Kinect v2's colour camera as ``kinect2_bridge`` publishes it at 1080p
KV2_HD = config.CameraIntrinsics(width=1920, height=1080, fx=1081.37, fy=1081.37, cx=959.5,
                                 cy=539.5)
DET = config.DetectionConfig()
DET_8PX = dataclasses.replace(DET, depth_patch_size_px=8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _room_depth(cam, device):
    scene = synthetic.RoomScene(cam, depth_noise=config.DepthNoiseModel())
    quat, pos = synthetic.orbit_trajectory(16, speed_mm=4.0)[15]
    return torch.as_tensor(scene.render(quat, pos)[1], device=device)


def _tunnel_depth(cam, device):
    import chip_smoke

    return torch.as_tensor(chip_smoke._tunnel_depths(cam, 1)[0], device=device)


#: (name, camera, detection config, depth maker) of the large grids
LARGE = {"room_1080p": (KV2_HD, DET, _room_depth),
         "tunnel_1080p": (KV2_HD, DET, _tunnel_depth),
         "room_8px": (config.TUM_FR1, DET_8PX, _room_depth),
         "tunnel_8px": (config.TUM_FR1, DET_8PX, _tunnel_depth)}


def _bits(t):
    return t.detach().contiguous().view(-1).view(torch.uint8).cpu()


def _assert_bit_equal(a, b, what):
    assert len(a) == len(b), what
    for name, x, y in zip(cylinders_cuda.CylinderStage._fields, a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, name)
        assert torch.equal(_bits(x), _bits(y)), (what, name)


def _tunnel_cut(grid, member, try_cyl, pieces):
    r = int((try_cyl & member.any(dim=-1)).nonzero()[0])
    cells = (member[r] & grid.planar).nonzero().flatten()
    member = torch.zeros_like(member)
    for i, chunk in enumerate(cells.chunk(pieces)):
        member[i, chunk] = True
    return member, member.any(dim=-1)


@pytest.mark.cuda
def test_the_global_path_gives_the_shared_paths_bits(cuda, monkeypatch):
    """On 768-cell grids (a room frame, a tunnel frame with its live region,
    the tunnel's region cut in four and in six candidates: every slot live)
    the global-memory path, forced, writes every output bit for bit as the
    shared-memory path does."""
    import chip_smoke

    cam = config.TUM_FR1
    cases = []
    for name, make in (("room", _room_depth), ("tunnel", _tunnel_depth)):
        grid, member, try_cyl, min_act = chip_smoke.cylinder_inputs(cam, DET, make(cam, cuda))
        cases.append((name, grid, member, try_cyl, min_act))
    grid, member, try_cyl, min_act = cases[1][1:]
    for pieces in (4, 6):
        cases.append((f"tunnel_in_{pieces}", grid,
                      *_tunnel_cut(grid, member, try_cyl, pieces), min_act))
    live = 0
    for name, grid, member, try_cyl, min_act in cases:
        assert cylinders_cuda.shared_path(*reversed(member.shape))
        shared = cylinders_cuda.cylinders_cuda(grid, member, try_cyl, DET, min_act)
        with monkeypatch.context() as m:
            m.setattr(cylinders_cuda, "shared_path", lambda c, k: False)
            before = cylinders_cuda.LAUNCHES["cylinders"]
            global_ = cylinders_cuda.cylinders_cuda(grid, member, try_cyl, DET, min_act)
            assert cylinders_cuda.LAUNCHES["cylinders"] == before + 1
        torch.cuda.synchronize()
        _assert_bit_equal(shared, global_, name)
        live += int(shared.selected.sum())
    assert live >= 1 + 4 + 4


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(LARGE))
def test_large_grids_take_the_global_path_and_match_the_plain_version(cuda, name):
    """5,184 cells (1920x1080 at 20 px) and 4,800 (640x480 at 8 px): past the
    shared-memory path, the kernel against ``cylinders_reference`` by the
    card check's rules; the tunnel frames hold a live region; two launches
    give the same bits."""
    import chip_smoke

    cam, det, make = LARGE[name]
    inputs, live, _, _ = chip_smoke.check_cylinders_frame(cam, det, make(cam, cuda), name=name)
    grid, member, try_cyl, min_act = inputs
    k, c = member.shape
    assert c == {20: 5184, 8: 4800}[det.depth_patch_size_px]
    assert not cylinders_cuda.shared_path(c, k)
    if name.startswith("tunnel"):
        assert live >= 1
    _assert_bit_equal(cylinders_cuda.cylinders_cuda(grid, member, try_cyl, det, min_act),
                      cylinders_cuda.cylinders_cuda(grid, member, try_cyl, det, min_act), name)


def _find_on(depth, cam, det, device):
    planes, cyls = primitives.find_primitives(depth.to(device), cam, det)
    return (tuple(x.cpu() for x in planes), tuple(x.cpu() for x in cyls))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["room_1080p", "tunnel_1080p", "room_8px"])
def test_find_primitives_on_large_grids_matches_the_plain_version(cuda, name):
    """``find_primitives`` on the card (the cell pass, the components and the
    cylinder stage's global path) against the plain version on the CPU: the
    same valid planes, each plane's normal within 1e-3 and offset within 2 mm,
    its cells the same but for 2% of them (cells whose fit sits at a gate's
    threshold, which the kernels' order of sums may tip), and the same number
    of valid cylinders; the room frames hold planes, the tunnel frame a
    cylinder."""
    cam, det, make = LARGE[name]
    depth = make(cam, cuda)
    (gp, gc), (wp, wc) = (_find_on(depth, cam, det, d) for d in (cuda, "cpu"))
    got, want = primitives.DetectedPlanes(*gp), primitives.DetectedPlanes(*wp)
    got_c, want_c = primitives.DetectedCylinders(*gc), primitives.DetectedCylinders(*wc)
    assert torch.equal(got.valid, want.valid), name
    if name.startswith("tunnel"):
        assert int(want_c.valid.sum()) >= 1
    else:
        assert bool(want.valid.any())
    v = want.valid
    np.testing.assert_allclose(got.params[v, :3].numpy(), want.params[v, :3].numpy(),
                               atol=1e-3)
    np.testing.assert_allclose(got.params[v, 3].numpy(), want.params[v, 3].numpy(), atol=2.0)
    differ = (got.cell_mask[v] != want.cell_mask[v]).sum(-1).float()
    assert (differ <= 0.02 * want.cell_mask[v].sum(-1).float().clamp_min(1.0)).all(), differ
    assert int(got_c.valid.sum()) == int(want_c.valid.sum())
