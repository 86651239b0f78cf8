"""The LM solve's packed layout and plain version (``ops/lm_cuda.py``) on the CPU.

``lm_cuda.lm_solve_reference`` over the packed inputs must equal, to the bit,
the pose optimizer's LM as it was before the kernel (``_vmap_jvp_lm_solve``
below, a copy of that body: ``vmap(jvp)`` of ``residual_vector_prepared`` over
the prepared features and ``solve6_spd``), and the JAX package's ``lm_solve``
on the edge cases to the tolerances of ``tests/test_torch_pose.py`` (1e-2 mm,
1e-5 in stereographic components, cost to 1e-3 relative).  The work counts of
``lm_cuda.lm_work`` are held to counts worked out by hand at the main path's
two shapes.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jvp, vmap

from rgbd_slam_tpu.pose import features as j_features
from rgbd_slam_tpu.pose import optimizer as j_opt
from rgbd_slam_tpu_torch.ops import lm_cuda
from rgbd_slam_tpu_torch.pose import optimizer
from rgbd_slam_tpu_torch.pose.features import MatchedFeatures
from rgbd_slam_tpu_torch.pose.linalg6 import solve6_spd
from rgbd_slam_tpu_torch.pose.residuals import prepare_features, residual_vector_prepared
from torch_lm_cases import CAM, CASE_NAMES, KERNEL_EDGE_NAMES, assert_bit_equal, case, cases

torch.set_num_threads(2)


def _vmap_jvp_lm_solve(coeffs0, feats, cam, weights=None, iterations=8, damping0=1e-3):
    """``optimizer.lm_solve`` before the LM kernel, kept as it was."""
    if weights is not None:
        feats = feats.with_masks(*(w > 0 for w in feats.split_unified(weights)))
    if coeffs0.dim() == 1:
        coeffs, cost = _vmap_jvp_lm_solve(coeffs0[None], feats, cam, iterations=iterations,
                                          damping0=damping0)
        return coeffs[0], cost[0]
    dt = coeffs0.dtype
    prep = prepare_features(feats, cam)
    eye6 = torch.eye(6, dtype=dt, device=coeffs0.device)

    def res_fn(c):
        return residual_vector_prepared(c, prep, cam)

    def res_and_jac(c):
        tangents = eye6.reshape((6,) + (1,) * (c.dim() - 1) + (6,)).expand(
            (6,) + c.shape)
        r, jac = vmap(lambda t: jvp(res_fn, (c,), (t,)), out_dims=(0, -1))(tangents)
        return r[0], jac

    def normal_eq(r, jac):
        jt = jac.transpose(-1, -2)
        return jt @ jac, (jt @ r[..., None])[..., 0]

    def trial_from(best_c, jtj, g, damping):
        diag = torch.clamp_min(torch.diagonal(jtj, dim1=-2, dim2=-1), 1e-8)
        a = jtj + damping[..., None, None] * torch.diag_embed(diag) + 1e-12 * eye6
        return best_c + solve6_spd(a, -g)

    r0, jac0 = res_and_jac(coeffs0)
    best_c = coeffs0
    best_cost = torch.sum(r0 * r0, dim=-1)
    jtj, g = normal_eq(r0, jac0)
    damping = torch.full(best_cost.shape, damping0, dtype=dt, device=coeffs0.device)
    trial = trial_from(best_c, jtj, g, damping)
    for _ in range(iterations):
        r_t, jac_t = res_and_jac(trial)
        cost_t = torch.sum(r_t * r_t, dim=-1)
        accept = (cost_t < best_cost) & torch.isfinite(trial).all(dim=-1)
        best_c = torch.where(accept[..., None], trial, best_c)
        best_cost = torch.where(accept, cost_t, best_cost)
        jtj_t, g_t = normal_eq(r_t, jac_t)
        jtj = torch.where(accept[..., None, None], jtj_t, jtj)
        g = torch.where(accept[..., None], g_t, g)
        damping = torch.clamp(torch.where(accept, damping * 0.5, damping * 4.0),
                              1e-9, 1e6)
        trial = trial_from(best_c, jtj, g, damping)
    return best_c, best_cost


@pytest.mark.parametrize("name", CASE_NAMES + KERNEL_EDGE_NAMES)
def test_reference_equals_the_vmap_jvp_lm_to_the_bit(name):
    """``optimizer.lm_solve`` (pack, then ``lm_solve_reference`` on the CPU)
    equals the LM as it was before the kernel, to the bit."""
    feats, c0, weights, iterations = case(name)
    before = lm_cuda.LAUNCHES["lm_solve"]
    got = optimizer.lm_solve(c0, feats, CAM, weights=weights, iterations=iterations)
    want = _vmap_jvp_lm_solve(c0, feats, CAM, weights=weights, iterations=iterations)
    assert_bit_equal(got, want)
    assert lm_cuda.LAUNCHES["lm_solve"] == before
    assert torch.isfinite(got[0]).all()


@pytest.mark.parametrize("name", ["hypotheses", "refit", "edges"])
def test_details_report_the_best_point_and_its_accepts(name):
    """``details=True`` changes nothing of the result; the accept bits agree
    with the cost falling, and the normal equations are the best point's."""
    feats, c0, _, iterations = cases()[name]
    inputs = lm_cuda.pack(prepare_features(feats, CAM), CAM)
    plain = lm_cuda.lm_solve(inputs, c0, iterations, 1e-3)
    det = lm_cuda.lm_solve(inputs, c0, iterations, 1e-3, details=True)
    assert_bit_equal(det[:2], plain)
    assert det.jtj.shape == c0.shape[:-1] + (6, 6) and det.jtr.shape == c0.shape
    moved = ~(det.coeffs == c0).all(dim=-1)
    assert torch.equal(moved, det.accepts != 0)
    assert int(det.accepts.max()) < (1 << iterations)
    # the best point's normal equations, from one more linearization there
    at_best = lm_cuda.lm_solve(inputs, det.coeffs, 0, 1e-3, details=True)
    assert_bit_equal(at_best[:4], (det.coeffs, det.cost, det.jtj, det.jtr))


def test_packing_views_the_masks_and_keeps_the_blocks():
    feats, c0, _, _ = cases()["refit"]
    prep = prepare_features(feats, CAM)
    inputs = lm_cuda.pack(prep, CAM)
    assert inputs.point_mask.dtype == torch.uint8
    assert inputs.point_mask.data_ptr() == prep.point_mask.data_ptr()
    assert inputs.pts_world.data_ptr() == prep.pts_world.data_ptr()
    back = lm_cuda.prepared(inputs)
    for a, b in zip(back, prep, strict=True):
        assert torch.equal(a, b)
    assert (inputs.fx, inputs.fy, inputs.cx, inputs.cy) == (CAM.fx, CAM.fy, CAM.cx, CAM.cy)
    assert inputs.capacities == feats.capacities


def test_kernel_layout_shares_the_blocks_without_a_batch_axis():
    """The refit batch perturbs the world points, planes and lines per member
    and shares the observations and masks: the kernel reads the shared blocks
    with a batch stride of 0 and the others with their member's size."""
    feats, c0, _, _ = cases()["refit"]
    inputs = lm_cuda.pack(prepare_features(feats, CAM), CAM)
    batch, coeffs, flat, strides = lm_cuda.kernel_layout(inputs, c0)
    np_, n2, nk, nl = inputs.capacities
    p = np_ + 2 * n2 + 2 * nl
    assert batch == (9,) and coeffs.shape == (9, 6)
    assert strides == [3 * p, 0, 0, 0, 0, 4 * nk, 0, 0, 0, 0, 0]
    assert flat[0].shape == (9, p, 3) and flat[1].shape == (np_, 2)
    assert all(t.is_contiguous() for t in flat)
    # a leading axis of one is shared; poses broadcast against batched blocks
    one = inputs._replace(point_obs_uv=inputs.point_obs_uv[None])
    _, coeffs, flat, strides = lm_cuda.kernel_layout(one, c0[0])
    assert strides[1] == 0 and flat[1].shape == (np_, 2) and coeffs.shape == (9, 6)
    assert torch.equal(coeffs, c0[:1].expand(9, 6))


@pytest.mark.parametrize("capacities, shape", [
    ((6, 6, 3, 6), (32, 84)),             # the hypotheses: the one-warp kernel
    ((256, 128, 32, 16), (128, 1728)),    # the refit + Monte-Carlo members
    ((0, 0, 0, 0), (32, 0)),
    ((24, 8, 0, 0), (32, 128)),
    ((24, 8, 4, 6), (64, 168)),
    ((24, 8, 4, 9), (64, 180)),
    ((300, 40, 7, 9), (128, 1424)),       # threads take several features
    ((8192, 0, 0, 0), (128, 32768)),
])
def test_launch_shape_at_the_main_path_and_the_edges(capacities, shape):
    """Threads a CTA (the slots in whole warps, 32 to 128) and the live list's
    shared-memory bytes (4 a slot) that ``lm_solve_cuda`` launches with."""
    assert lm_cuda.launch_shape(capacities) == shape


def test_launch_shape_refuses_a_list_past_its_shared_memory():
    with pytest.raises(ValueError, match="at most 8192 features"):
        lm_cuda.launch_shape((8000, 100, 64, 29))


def test_kernel_edge_cases_reach_the_edges():
    """The kernel's edge cases are what their names say: the slots and live
    features of a member, a member with no live feature, the iterations."""
    counts = {}
    for name in KERNEL_EDGE_NAMES:
        inputs, c0, iterations = _flat_case(name)
        live = lm_cuda.lm_work(inputs, c0, 1)["live"]
        masks = [m.expand(c0.shape[:1] + m.shape[-1:]).sum(-1)
                 for m in (inputs.point_mask, inputs.point2d_mask, inputs.plane_mask,
                           inputs.line_mask)]
        counts[name] = (sum(inputs.capacities), sum(live) // c0.shape[0],
                        int(sum(masks).min()), iterations)
    assert counts["features_356"][:2] == (356, 334)
    assert counts["features_45"][0] == 45
    assert counts["no_live_member_one_warp"][0] <= 32
    assert counts["no_live_member_one_warp"][2] == 0 and counts["no_live_member"][2] == 0
    assert counts["no_live_member"][0] > 32
    assert counts["iterations_0"][3] == 0 and counts["iterations_64"][3] == 64


def test_the_cpu_never_reaches_the_kernel():
    feats, c0, _, iterations = cases()["hypotheses"]
    inputs = lm_cuda.pack(prepare_features(feats, CAM), CAM)
    with pytest.raises(ValueError, match="CUDA tensors"):
        lm_cuda.lm_solve_cuda(inputs, c0, iterations, 1e-3)
    with pytest.raises(ValueError, match="unsupported device"):
        lm_cuda.lm_solve(inputs, c0.to("meta"), iterations, 1e-3)


@pytest.mark.parametrize("name", ["edges", "planes_and_lines_empty"])
def test_reference_matches_the_jax_lm_solve(name):
    """The packed plain version against ``rgbd_slam_tpu.pose.optimizer.lm_solve``
    over each pose of the batch: a point behind the camera, a zero-length
    inverse-depth segment and a degenerate line; empty plane and line blocks."""
    feats, c0, _, iterations = cases()[name]
    inputs = lm_cuda.pack(prepare_features(feats, CAM), CAM)
    got_c, got_cost = lm_cuda.lm_solve(inputs, c0, iterations, 1e-3)
    j_feats = j_features.MatchedFeatures(*[jnp.asarray(t.numpy()) for t in feats])
    solve = jax.jit(jax.vmap(lambda c: j_opt.lm_solve(c, j_feats, CAM, iterations=iterations)))
    want_c, want_cost = solve(jnp.asarray(c0.reshape(-1, 6).numpy()))
    got_c = got_c.reshape(-1, 6).numpy()
    np.testing.assert_allclose(got_c[:, :3], np.asarray(want_c)[:, :3], atol=1e-2)
    np.testing.assert_allclose(got_c[:, 3:], np.asarray(want_c)[:, 3:], atol=1e-5)
    np.testing.assert_allclose(got_cost.reshape(-1).numpy(), np.asarray(want_cost),
                               rtol=1e-3, atol=1e-4)


def _full_inputs(b, caps, batched):
    """Packed inputs of ``caps`` with every feature live; the blocks named in
    ``batched`` carry the batch axis."""
    np_, n2, nk, nl = caps
    shapes = {"pts_world": (np_ + 2 * n2 + 2 * nl, 3), "point_obs_uv": (np_, 2),
              "point_mask": (np_,), "point2d_obs_uv": (n2, 2), "point2d_mask": (n2,),
              "plane_world": (nk, 4), "plane_cam": (nk, 4), "plane_mask": (nk,),
              "line_obs_p0": (nl, 2), "line_obs_p1": (nl, 2), "line_mask": (nl,)}
    blocks = {}
    for name, shape in shapes.items():
        lead = (b,) if name in batched else ()
        blocks[name] = (torch.ones(lead + shape, dtype=torch.uint8) if name.endswith("mask")
                        else torch.zeros(lead + shape))
    return lm_cuda.LMInputs(**blocks, fx=CAM.fx, fy=CAM.fy, cx=CAM.cx, cy=CAM.cy)


def test_lm_work_at_the_main_path_shapes():
    """By hand.  A member's linearization: 208 FLOPs a point, 640 an
    inverse-depth point, 243 a plane, 609 a line, 56 a residual row, 1037 the
    pose; 199 a solve between two linearizations.

    Hypotheses: 32 members, (6, 6, 3, 6) features, 45 rows, 11 linearizations:
    6*208 + 6*640 + 3*243 + 6*609 + 45*56 + 1037 = 13,028 a member and
    linearization, x 32 x 11 = 4,585,856, + 32 x 10 x 199 = 63,680.  Bytes,
    every block batched: points 32*30*3*4 = 11,520, six blocks of 32*6*2*4 or
    32*3*4*4 = 1,536, masks 32*(6+6+3+6) = 672, coefficients and costs
    32*13*4 = 1,664: 23,072.

    Refit + Monte-Carlo: 101 members, (256, 128, 32, 16), 896 rows, 7
    linearizations: 53,248 + 81,920 + 7,776 + 9,744 + 50,176 + 1,037 =
    203,901, x 101 x 7 = 144,158,007, + 101 x 6 x 199 = 120,594.  Bytes: the
    perturbed points 101*544*3*4 = 659,328 and planes 101*32*4*4 = 51,712, the
    shared rest 2,048 + 1,024 + 512 + 128 + 128 and masks 432, coefficients and
    costs 101*13*4 = 5,252: 720,564."""
    hyp = _full_inputs(32, (6, 6, 3, 6), batched=set(lm_cuda.LMInputs._fields))
    work = lm_cuda.lm_work(hyp, torch.zeros(32, 6), linearizations=11)
    assert work == {"batch": 32, "live": [192, 192, 96, 192], "rows": 32 * 45,
                    "flops": 4_585_856 + 63_680, "bytes": 23_072}
    refit = _full_inputs(101, (256, 128, 32, 16), batched={"pts_world", "plane_world"})
    work = lm_cuda.lm_work(refit, torch.zeros(101, 6), linearizations=7)
    assert work == {"batch": 101, "live": [25_856, 12_928, 3_232, 1_616],
                    "rows": 101 * 896, "flops": 144_158_007 + 120_594, "bytes": 720_564}


def test_lm_work_counts_the_live_features_only():
    """Masked features cost nothing: half the points and no plane of a member
    of 4 give (3 x 208 + 6 x 56) fewer FLOPs a linearization for the points and
    (2 x 243 + 6 x 56) for the planes, in each of 4 members."""
    full = _full_inputs(4, (6, 2, 2, 0), batched={"point_mask"})
    point_mask = full.point_mask.clone()
    point_mask[:, :3] = 0
    some = full._replace(point_mask=point_mask, plane_mask=torch.zeros(2, dtype=torch.uint8))
    a = lm_cuda.lm_work(full, torch.zeros(6), linearizations=3)
    b = lm_cuda.lm_work(some, torch.zeros(6), linearizations=3)
    assert a["live"] == [24, 8, 8, 0] and b["live"] == [12, 8, 0, 0]
    assert a["flops"] - b["flops"] == 3 * 4 * (3 * 208 + 6 * 56 + 2 * 243 + 6 * 56)
    assert a["bytes"] == b["bytes"]


def test_jax_features_convert_field_for_field():
    """The JAX and port ``MatchedFeatures`` share their field order, which the
    JAX comparisons above rely on."""
    assert j_features.MatchedFeatures._fields == MatchedFeatures._fields


@pytest.mark.parametrize("name", ["hypotheses", "refit", "single_pose", "edges"])
def test_details_trace_every_linearization(name):
    """The trace of ``details=True``: the start, then each trial, with the
    cost and normal equations of a linearization there; the best point's are
    those of the last trial accepted (or of the start)."""
    feats, c0, _, iterations = cases()[name]
    inputs = lm_cuda.pack(prepare_features(feats, CAM), CAM)
    det = lm_cuda.lm_solve(inputs, c0, iterations, 1e-3, details=True)
    lead = c0.shape[:-1]
    assert det.points.shape == lead + (iterations + 1, 6)
    assert det.jtjs.shape == lead + (iterations + 1, 6, 6)
    assert_bit_equal([det.points[..., 0, :].contiguous()], [c0])
    for j in (0, iterations):
        at = lm_cuda.lm_solve(inputs, det.points[..., j, :].contiguous(), 0, 1e-3,
                              details=True)
        assert_bit_equal(at[1:4], [t.contiguous() for t in (
            det.costs[..., j], det.jtjs[..., j, :, :], det.jtrs[..., j, :])])
    bits = (det.accepts[..., None] >> torch.arange(iterations)) & 1
    last = torch.where(bits.bool(), torch.arange(1, iterations + 1), 0).amax(-1)
    pick = last[..., None, None]
    assert_bit_equal([det.coeffs, det.jtr],
                     [det.points.gather(-2, pick.expand(lead + (1, 6)))[..., 0, :],
                      det.jtrs.gather(-2, pick.expand(lead + (1, 6)))[..., 0, :]])


def _flat_case(name):
    """A case of ``torch_lm_cases`` as ``chip_smoke.lm_replay`` takes it:
    packed inputs and a batch of starts [B, 6]."""
    feats, c0, weights, iterations = case(name)
    if weights is not None:
        feats = feats.with_masks(*(w > 0 for w in feats.split_unified(weights)))
    inputs = lm_cuda.pack(prepare_features(feats, CAM), CAM)
    return inputs, (c0 if c0.dim() > 1 else c0[None]), iterations


@pytest.mark.parametrize("name", CASE_NAMES + KERNEL_EDGE_NAMES)
def test_replay_passes_the_plain_run(name):
    """The card's step-by-step check (``chip_smoke.lm_replay``) passes the
    plain version's own run: its trials are the plain steps to the bit, its
    decisions follow its costs, its result is its best point, and its
    normal equations are within tolerance of the float64 ones."""
    import chip_smoke

    inputs, c0, iterations = _flat_case(name)
    run = lm_cuda.lm_solve_reference(inputs, c0, iterations, 1e-3, details=True)
    replay = chip_smoke.lm_replay(inputs, 1e-3, run)
    assert not chip_smoke.lm_failures(replay).any(), replay
    assert float(replay["step_abs"].max()) == 0.0
    assert int(replay["decisions"].sum()) == 0 and not replay["result"].any()


def _best_follows_trials(inputs, c0, iterations, damping0):
    """An LM with the fault the first card version of the kernel had: the best
    point moves to every trial, accepted or not (its cost and normal equations
    only on accept)."""
    def at(c):
        return lm_cuda.lm_solve_reference(inputs, c, 0, damping0, details=True)

    start = at(c0)
    best, best_cost, jtj, jtr = c0, start.cost, start.jtj, start.jtr
    damping = torch.full(best_cost.shape, damping0)
    accepts = torch.zeros(best_cost.shape, dtype=torch.int64)
    trace = [start]
    for it in range(iterations):
        trial = lm_cuda.damped_step(best, jtj, jtr, damping)
        lin = at(trial)
        take = (lin.cost < best_cost) & torch.isfinite(trial).all(-1)
        accepts |= take.to(torch.int64) << it
        best = trial
        best_cost = torch.where(take, lin.cost, best_cost)
        jtj = torch.where(take[:, None, None], lin.jtj, jtj)
        jtr = torch.where(take[:, None], lin.jtr, jtr)
        damping = lm_cuda.next_damping(damping, take)
        trace.append(lin)
    return lm_cuda.LMResult(best, best_cost, jtj, jtr, accepts,
                            *(torch.cat([getattr(t, k) for t in trace], 1)
                              for k in ("points", "costs", "jtjs", "jtrs")))


@pytest.mark.parametrize("fault", ["best_follows_rejected_trials", "a_decision_flipped",
                                   "a_tangent_off", "the_result_off_its_best"])
def test_replay_fails_a_faulty_run(fault):
    """The card's check fails runs with the faults an LM kernel could have:
    the best point following rejected trials, a decision against the costs,
    a Jacobian entry off by 1e-3 of the largest, a result that is not the best
    point's."""
    import chip_smoke

    inputs, c0, iterations = _flat_case("refit")
    run = lm_cuda.lm_solve_reference(inputs, c0, iterations, 1e-3, details=True)
    if fault == "best_follows_rejected_trials":
        assert int(run.accepts.min()) < (1 << iterations) - 1     # a member rejects
        run = _best_follows_trials(inputs, c0, iterations, 1e-3)
    elif fault == "a_decision_flipped":
        run = run._replace(accepts=run.accepts ^ (1 << (iterations - 1)))
    elif fault == "a_tangent_off":
        jtjs = run.jtjs.clone()
        jtjs[0, 2, 1, 1] += 1e-3 * jtjs[0, 2].abs().max()
        run = run._replace(jtjs=jtjs)
    else:
        run = run._replace(coeffs=run.points[:, -1])
    failing = chip_smoke.lm_failures(chip_smoke.lm_replay(inputs, 1e-3, run))
    assert failing.any()
