"""Parity of the port's fused forward-backward LK (its plain PyTorch version, which
CPU tensors run) with the JAX package's Pallas kernel (``lk_fwd_bwd_pallas`` in
interpret mode).  The CUDA kernel is held to the plain version on the card in
test_torch_cuda.py.

Tolerance: 0.05 px on points both versions mark ok.  The two sum the window's
products in a different order, which can move one convergence test by one
Gauss-Newton iteration, and that iteration moves a point by less than
eps = 0.03 px.  ok flags must be equal except where the round trip lies within
0.05 px of the gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from rgbd_slam_tpu.ops.image import build_pyramid as jax_build_pyramid
from rgbd_slam_tpu.ops.pallas_lk import lk_fwd_bwd_pallas
from rgbd_slam_tpu_torch.ops import lk_cuda, optical_flow

torch.set_num_threads(2)

TOL_PX = 0.05
GATE_PX = 3.0
KW = dict(levels=2, win_h=25, win_w=25, iterations=10, eps=0.03,
          coarse_win=25, coarse_from_level=1)


def _scene(seed=0):
    """120x160 textured frame pair (shift (2, 1) px) with a flat patch, and 8
    points: interior, one on the flat patch (singular tensor), one near the
    border, one invalid."""
    rng = np.random.default_rng(seed)
    img = gaussian_filter(rng.uniform(0, 255, (140, 180)), 2.0)
    img[20:60, 110:160] = 128.0
    prev = img[10:130, 10:170].astype(np.float32)
    nxt = img[9:129, 8:168].astype(np.float32)
    pts = np.array([[40.0, 40.0], [80.5, 60.25], [100.0, 90.0], [60.0, 95.0],
                    [135.0, 35.0], [4.0, 60.0], [150.0, 112.0], [70.0, 30.0]],
                   np.float32)
    valid = np.array([True, True, True, True, True, True, True, False])
    return prev, nxt, pts, valid


def _pyramids(prev, nxt, levels):
    pp = [np.array(a) for a in jax_build_pyramid(jnp.asarray(prev), levels)]
    pn = [np.array(a) for a in jax_build_pyramid(jnp.asarray(nxt), levels)]
    return pp, pn


def _assert_lk_close(pts_a, ok_a, pts_b, ok_b, roundtrip_b):
    near_gate = np.abs(roundtrip_b - GATE_PX) <= TOL_PX
    assert np.array_equal(ok_a | near_gate, ok_b | near_gate), (ok_a, ok_b)
    both = ok_a & ok_b
    np.testing.assert_allclose(pts_a[both], pts_b[both], atol=TOL_PX)


@pytest.mark.parametrize("bwd_levels", [None, 0])
def test_reference_matches_pallas_interpret(bwd_levels):
    prev, nxt, pts, valid = _scene()
    pp, pn = _pyramids(prev, nxt, KW["levels"])
    j_pts, j_ok = lk_fwd_bwd_pallas(
        [jnp.asarray(a) for a in pp], [jnp.asarray(a) for a in pn],
        jnp.asarray(pts), jnp.asarray(valid), batch=4, max_roundtrip=GATE_PX,
        interpret=True, bwd_levels=bwd_levels, **KW)
    j_pts, j_ok = np.asarray(j_pts), np.asarray(j_ok)

    t_pts, t_ok = lk_cuda.lk_fwd_bwd_reference(
        [torch.from_numpy(a) for a in pp], [torch.from_numpy(a) for a in pn],
        torch.from_numpy(pts), torch.from_numpy(valid), max_roundtrip=GATE_PX,
        bwd_levels=bwd_levels, **KW)
    t_pts, t_ok = t_pts.numpy(), t_ok.numpy()

    roundtrip = lk_cuda.roundtrip_px_reference(
        [torch.from_numpy(a) for a in pp], [torch.from_numpy(a) for a in pn],
        torch.from_numpy(pts), torch.from_numpy(t_pts), bwd_levels=bwd_levels,
        **KW).numpy()
    _assert_lk_close(t_pts, t_ok, j_pts, j_ok, roundtrip)
    # the scene's own checks: true flow is (+2, +1); the flat point and the
    # invalid point fail; invalid rows keep their position
    assert t_ok[[0, 1, 2, 3]].all()
    np.testing.assert_allclose(t_pts[0] - pts[0], [2.0, 1.0], atol=0.05)
    assert not t_ok[4] and not t_ok[7]
    np.testing.assert_array_equal(t_pts[7], pts[7])


def test_window_sizes_follow_pallas_clamp():
    # coarse window from level 1, each clamped to the level size - 8
    dims = ((480, 640), (240, 320), (120, 160), (60, 80), (30, 40))
    assert lk_cuda.window_sizes(dims, 53, 53, 53, 1) == (
        (53, 53), (53, 53), (53, 53), (52, 53), (22, 32))
    assert lk_cuda.window_sizes(dims, 53, 53, 21, 2)[1:3] == ((53, 53), (21, 21))


def test_track_forward_backward_status_and_border():
    prev, nxt, pts, valid = _scene()
    pp, pn = _pyramids(prev, nxt, KW["levels"])
    tp = [torch.from_numpy(a) for a in pp]
    tn = [torch.from_numpy(a) for a in pn]
    out, status = optical_flow.track_forward_backward(
        tp, tn, torch.from_numpy(pts), torch.from_numpy(valid),
        max_roundtrip_px=GATE_PX, levels=2, win_h=25, win_w=25, bwd_levels=0,
        coarse_win=25)
    ref, ok = lk_cuda.lk_fwd_bwd_reference(tp, tn, torch.from_numpy(pts),
                                           torch.from_numpy(valid),
                                           max_roundtrip=GATE_PX, bwd_levels=0, **KW)
    h, w = prev.shape
    inb = ((ref[:, 0] >= 1) & (ref[:, 0] < w - 1) & (ref[:, 1] >= 1)
           & (ref[:, 1] < h - 1))
    np.testing.assert_array_equal(status.numpy(), (ok & inb).numpy())
    np.testing.assert_array_equal(out.numpy()[~status.numpy()], pts[~status.numpy()])
    # N % 4 != 0 goes through the forward-only LK twice (held to the JAX
    # composition in test_torch_lk_pyramid.py): the same scene's first 6 points
    out6, status6 = optical_flow.track_forward_backward(
        tp, tn, torch.from_numpy(pts[:6]), torch.from_numpy(valid[:6]),
        max_roundtrip_px=GATE_PX, levels=2, win_h=25, win_w=25, bwd_levels=0,
        coarse_win=25)
    assert status6.shape == (6,) and status6.numpy()[[0, 1, 2, 3]].all()
    assert not status6.numpy()[4]
    np.testing.assert_allclose(out6.numpy()[0] - pts[0], [2.0, 1.0], atol=0.05)


def test_cpu_tensors_never_reach_the_kernel():
    prev, nxt, pts, valid = _scene()
    pp, pn = _pyramids(prev, nxt, 1)
    before = dict(lk_cuda.LAUNCHES)
    lk_cuda.lk_fwd_bwd([torch.from_numpy(a) for a in pp],
                       [torch.from_numpy(a) for a in pn], torch.from_numpy(pts),
                       torch.from_numpy(valid), levels=1, win_h=25, win_w=25)
    assert lk_cuda.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        lk_cuda.lk_fwd_bwd_cuda([torch.from_numpy(a) for a in pp],
                                [torch.from_numpy(a) for a in pn],
                                torch.from_numpy(pts), torch.from_numpy(valid), levels=1)
