"""Parity of the port's forward-only and single-level LK (the plain PyTorch
versions, which CPU tensors run) with the JAX package's Pallas kernels
``lk_pyramid_pallas`` and ``lk_level_pallas`` in interpret mode, and of the
port's ``lk_track`` / ``track_forward_backward`` at N % 4 != 0 with the JAX
package's composition of ``lk_pyramid_pallas`` (optical_flow.py:115-126,
:194-215).  The CUDA kernels are held to the plain versions on the card in
test_torch_cuda.py.

Tolerance: 0.05 px on points both versions mark ok (a different summation order
can move one convergence test by one Gauss-Newton step, < eps = 0.03 px).  The
forward-only status is the level-0 structure-tensor test: equal flags.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_slam_tpu.ops.image import in_border as jax_in_border
from rgbd_slam_tpu.ops.pallas_lk import lk_level_pallas, lk_pyramid_pallas
from rgbd_slam_tpu_torch.ops import lk_cuda, optical_flow
from test_torch_lk import GATE_PX, TOL_PX, _pyramids, _scene

torch.set_num_threads(2)

#: window 25 at both levels (at 120x160 the Pallas min(win, l - 8) keeps 25)
KW = dict(levels=2, win_h=25, win_w=25, iterations=10, eps=0.03)


def _seven_points():
    """The LK scene's frame pair with 7 of its points (N % 4 != 0): interior,
    the flat patch, the two border points and the invalid one."""
    prev, nxt, pts, valid = _scene()
    keep = [0, 1, 2, 4, 5, 6, 7]
    return prev, nxt, pts[keep], valid[keep]


def _torch_list(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax_lk_track(pp, pn, pts, valid, levels):
    """``rgbd_slam_tpu.ops.optical_flow.lk_track``'s Pallas branch, in interpret
    mode."""
    flow, ok = lk_pyramid_pallas([jnp.asarray(a) for a in pp], [jnp.asarray(a) for a in pn],
                                 jnp.asarray(pts), jnp.asarray(valid), levels=levels,
                                 win_h=KW["win_h"], win_w=KW["win_w"],
                                 iterations=KW["iterations"], eps=KW["eps"], interpret=True)
    new_pts = jnp.asarray(pts) + flow
    h, w = pp[0].shape
    status = ok & jax_in_border(new_pts, h, w, margin=1.0) \
        & jnp.all(jnp.isfinite(new_pts), axis=-1)
    return np.asarray(jnp.where(status[:, None], new_pts, pts)), np.asarray(status)


def test_pyramid_reference_matches_pallas_interpret():
    prev, nxt, pts, valid = _seven_points()
    pp, pn = _pyramids(prev, nxt, KW["levels"])
    j_flow, j_ok = lk_pyramid_pallas([jnp.asarray(a) for a in pp],
                                     [jnp.asarray(a) for a in pn], jnp.asarray(pts),
                                     jnp.asarray(valid), interpret=True, **KW)
    j_flow, j_ok = np.asarray(j_flow), np.asarray(j_ok)
    t_flow, t_ok = lk_cuda.lk_pyramid_reference(_torch_list(pp), _torch_list(pn),
                                                torch.from_numpy(pts),
                                                torch.from_numpy(valid), **KW)
    t_flow, t_ok = t_flow.numpy(), t_ok.numpy()
    np.testing.assert_array_equal(t_ok, j_ok)
    np.testing.assert_allclose(t_flow[t_ok], j_flow[j_ok], atol=TOL_PX)
    # the scene: true flow (+2, +1); the flat patch and the invalid point fail;
    # the invalid point never moves
    assert t_ok[[0, 1, 2]].all() and not t_ok[3] and not t_ok[6]
    np.testing.assert_allclose(t_flow[0], [2.0, 1.0], atol=0.05)
    np.testing.assert_array_equal(t_flow[6], [0.0, 0.0])


def test_level_reference_matches_pallas_interpret():
    """Level 0 from the plain pyramid tracker's level-1 result doubled, a
    non-square explicit window and one zero guess."""
    prev, nxt, pts, valid = _seven_points()
    pp, pn = _pyramids(prev, nxt, 1)
    g1, _ = lk_cuda.lk_pyramid_reference(_torch_list(pp), _torch_list(pn),
                                         torch.from_numpy(pts), torch.from_numpy(valid),
                                         levels=1, win_h=25, win_w=25)
    guesses = g1.numpy()
    guesses[2] = 0.0
    win = dict(win_h=21, win_w=27, iterations=10, eps=0.03)
    j_g, j_ok = lk_level_pallas(jnp.asarray(pp[0]), jnp.asarray(pn[0]), jnp.asarray(pts),
                                jnp.asarray(guesses), jnp.asarray(valid), interpret=True,
                                **win)
    j_g, j_ok = np.asarray(j_g), np.asarray(j_ok)
    t_g, t_ok = lk_cuda.lk_level_reference(torch.from_numpy(pp[0]), torch.from_numpy(pn[0]),
                                           torch.from_numpy(pts), torch.from_numpy(guesses),
                                           torch.from_numpy(valid), **win)
    t_g, t_ok = t_g.numpy(), t_ok.numpy()
    np.testing.assert_array_equal(t_ok, j_ok)
    np.testing.assert_allclose(t_g[t_ok], j_g[j_ok], atol=TOL_PX)
    # failed rows keep their guess (no iteration runs)
    np.testing.assert_array_equal(t_g[~t_ok], guesses[~t_ok])
    np.testing.assert_allclose(t_g[[0, 2]], [[2.0, 1.0], [2.0, 1.0]], atol=0.05)
    assert not t_ok[3] and not t_ok[6]


def test_lk_track_matches_jax_composition():
    prev, nxt, pts, valid = _seven_points()
    pp, pn = _pyramids(prev, nxt, KW["levels"])
    j_pts, j_ok = _jax_lk_track(pp, pn, pts, valid, KW["levels"])
    t_pts, t_ok = optical_flow.lk_track(_torch_list(pp), _torch_list(pn),
                                        torch.from_numpy(pts), torch.from_numpy(valid), **KW)
    np.testing.assert_array_equal(t_ok.numpy(), j_ok)
    np.testing.assert_allclose(t_pts.numpy(), j_pts, atol=TOL_PX)
    # untracked rows keep their input position exactly
    np.testing.assert_array_equal(t_pts.numpy()[~j_ok], pts[~j_ok])


@pytest.mark.parametrize("bwd_levels", [None, 0])
def test_track_forward_backward_any_count_matches_jax_composition(bwd_levels):
    """N = 7: the forward-only kernel twice, as the JAX package composes it: a
    forward lk_track, a zero-seeded backward lk_track from the forward points
    with fwd_ok as valid, then the round-trip gate."""
    prev, nxt, pts, valid = _seven_points()
    pp, pn = _pyramids(prev, nxt, KW["levels"])
    fwd, fwd_ok = _jax_lk_track(pp, pn, pts, valid, KW["levels"])
    bwd, bwd_ok = _jax_lk_track(pn, pp, fwd, fwd_ok,
                                KW["levels"] if bwd_levels is None else bwd_levels)
    j_status = fwd_ok & bwd_ok & (np.linalg.norm(pts - bwd, axis=-1) <= GATE_PX)
    j_out = np.where(j_status[:, None], fwd, pts)

    before = dict(lk_cuda.LAUNCHES)
    t_out, t_status = optical_flow.track_forward_backward(
        _torch_list(pp), _torch_list(pn), torch.from_numpy(pts), torch.from_numpy(valid),
        max_roundtrip_px=GATE_PX, bwd_levels=bwd_levels, **KW)
    assert lk_cuda.LAUNCHES == before   # CPU tensors run the plain versions
    np.testing.assert_array_equal(t_status.numpy(), j_status)
    np.testing.assert_allclose(t_out.numpy(), j_out, atol=TOL_PX)
    assert t_status.numpy()[[0, 1, 2]].all()


def test_empty_and_cpu_inputs():
    prev, nxt, pts, valid = _seven_points()
    pp, pn = _pyramids(prev, nxt, 1)
    flow, ok = lk_cuda.lk_pyramid(_torch_list(pp), _torch_list(pn), torch.zeros(0, 2),
                                  torch.zeros(0, dtype=torch.bool), levels=1, win_h=25,
                                  win_w=25)
    assert flow.shape == (0, 2) and ok.shape == (0,)
    with pytest.raises(ValueError, match="CUDA tensors"):
        lk_cuda.lk_pyramid_cuda(_torch_list(pp), _torch_list(pn), torch.from_numpy(pts),
                                torch.from_numpy(valid), levels=1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        lk_cuda.lk_level_cuda(torch.from_numpy(pp[0]), torch.from_numpy(pn[0]),
                              torch.from_numpy(pts), torch.from_numpy(pts),
                              torch.from_numpy(valid), win_h=25, win_w=25)
    with pytest.raises(ValueError, match="window"):
        lk_cuda.lk_level(torch.from_numpy(pp[1]), torch.from_numpy(pn[1]),
                         torch.from_numpy(pts), torch.from_numpy(pts),
                         torch.from_numpy(valid), win_h=59, win_w=25)
