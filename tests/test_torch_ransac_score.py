"""The RANSAC scoring's wrapper (``ops/ransac_score_cuda.py``) on the CPU.

* Its plain version is the composition it replaced in
  ``compute_optimized_pose``, to the bit: the hypotheses scored on the
  features compacted by ``optimizer.compact_features`` and prepared anew, the
  rank's ``argmax``, the best pose's masks over every row; one pose scored and
  masked over every row (a copy of that code is below).
* Its edges: rows of a type past its cap, which never score; every hypothesis
  not ok; equal ranks, where the first index wins.
* The tested values it returns with ``details`` give the masks, the launch
  shape and the work count at the main path's shapes, and the wrapper
  raising for a CUDA tensor instead of falling back to the plain version.
* ``chip_smoke.score_agreement``, the card's check of the kernel, refuses
  planted faults.

Card tests (``test_torch_cuda.py``) hold the kernel to this plain version.
"""

import numpy as np
import pytest
import torch

import torch_score_cases as sc
from rgbd_slam_tpu_torch.config import RansacConfig
from rgbd_slam_tpu_torch.geometry import se3
from rgbd_slam_tpu_torch.ops import nvcc, ransac_score_cuda as rs
from rgbd_slam_tpu_torch.pose import optimizer
from rgbd_slam_tpu_torch.pose.features import (LINE_SCORE, PLANE_SCORE, POINT2D_SCORE,
                                               POINT_SCORE)
from rgbd_slam_tpu_torch.pose.residuals import inlier_masks_prepared, prepare_features
from torch_lm_cases import assert_bit_equal

RANSAC = RansacConfig()
CAM = sc.CAM


def _old_score_pose(coeffs, prep, cam, ransac_cfg):
    """``optimizer._score_pose`` as it was before the kernel."""
    quat, position = se3.coefficients_to_pose(coeffs)
    p_in, q_in, k_in, l_in = inlier_masks_prepared(quat, position, prep, cam, ransac_cfg)
    dt = coeffs.dtype
    score = (POINT_SCORE * p_in.sum(-1).to(dt) + POINT2D_SCORE * q_in.sum(-1).to(dt)
             + PLANE_SCORE * k_in.sum(-1).to(dt) + LINE_SCORE * l_in.sum(-1).to(dt))
    count = p_in.sum(-1) + q_in.sum(-1) + k_in.sum(-1) + l_in.sum(-1)
    return score, count, (p_in, q_in, k_in, l_in)


def _old_scoring(hyp_coeffs, hyp_ok, feats, cam, ransac_cfg):
    """The scoring of ``compute_optimized_pose`` as it was before the kernel:
    (best [1], best coeffs, best score, masks, hypothesis scores, counts)."""
    dt = hyp_coeffs.dtype
    prep_all = prepare_features(feats, cam)
    prep_sc = prepare_features(optimizer.compact_features(feats), cam)
    hyp_scores, hyp_counts, _ = _old_score_pose(hyp_coeffs, prep_sc, cam, ransac_cfg)
    hyp_scores = torch.where(hyp_ok, hyp_scores, -1.0)
    rank = hyp_scores + 1e-6 * hyp_counts.to(dt)
    best = torch.argmax(rank, dim=0, keepdim=True)
    best_coeffs = hyp_coeffs[best][0]
    best_score = hyp_scores[best][0]
    _, _, masks = _old_score_pose(best_coeffs, prep_all, cam, ransac_cfg)
    return best, best_coeffs, best_score, masks, hyp_scores, hyp_counts


def _inputs(seed, kind):
    feats, c_true = sc.features(seed, kind)
    coeffs, ok = sc.hypotheses(seed, c_true)
    return feats, coeffs, ok


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", list(sc.KINDS))
def test_plain_scoring_is_the_composition_it_replaced(kind, seed):
    feats, coeffs, ok = _inputs(seed, kind)
    want = _old_scoring(coeffs, ok, feats, CAM, RANSAC)
    got = rs.score(coeffs, prepare_features(feats, CAM), CAM, RANSAC, ok=ok,
                   caps=optimizer._REFIT_CAPS)
    best, best_coeffs, best_score, masks, scores, counts = want
    assert_bit_equal([got.best, got.coeffs, got.score, *got.masks, got.scores, got.counts],
                     [best, best_coeffs, best_score, *masks, scores, counts])
    assert int(got.best) != 7   # the NaN hypothesis, not ok, never wins


@pytest.mark.parametrize("kind", ["main", "lines_off", "planes_off", "empty", "odd", "wide"])
def test_one_pose_is_scored_and_masked_over_every_row(kind):
    """The refit's scoring: ``_score_pose(final_coeffs, prep_all)`` as it was."""
    feats, coeffs, _ = _inputs(2, kind)
    prep = prepare_features(feats, CAM)
    score, count, masks = _old_score_pose(coeffs[0], prep, CAM, RANSAC)
    got = rs.score(coeffs[0], prep, CAM, RANSAC)
    assert_bit_equal([got.score, *got.masks, got.scores, got.counts],
                     [score, *masks, score[None], count[None]])
    assert got.best.tolist() == [0] and torch.equal(got.coeffs, coeffs[0])


def _ranked_inliers(prep, coeffs, caps):
    """Each hypothesis' inliers among the first ``caps`` live rows of each type,
    counted from its masks over every row (an independent count)."""
    quat, position = se3.coefficients_to_pose(coeffs)
    masks = inlier_masks_prepared(quat, position, prep, CAM, RANSAC)
    lives = (prep.point_mask, prep.point2d_mask, prep.plane_mask, prep.line_mask)
    return [(m & (torch.cumsum(live.long(), -1) <= cap)).sum(-1)
            for m, live, cap in zip(masks, lives, caps)]


@pytest.mark.parametrize("kind", ["main", "wide"])
def test_rows_past_a_types_cap_never_score(kind):
    """More live points and 2D points than their caps (256, 128): a
    hypothesis' count is its inliers among the first cap live rows of each
    type, and its best pose's masks still cover every row."""
    feats, coeffs, ok = _inputs(3, kind)
    prep = prepare_features(feats, CAM)
    assert int(prep.point_mask.sum()) > sc.CAPS[0] and int(prep.point2d_mask.sum()) > sc.CAPS[1]
    got = rs.score(coeffs, prep, CAM, RANSAC, ok=ok, caps=sc.CAPS)
    n = _ranked_inliers(prep, coeffs, sc.CAPS)
    assert torch.equal(got.counts, n[0] + n[1] + n[2] + n[3])
    uncapped = rs.score(coeffs, prep, CAM, RANSAC, ok=ok)
    assert bool((uncapped.counts > got.counts).any())
    assert int(got.point_inliers.sum()) > sc.CAPS[0]


def test_every_hypothesis_not_ok():
    """Every score is -1, so the rank is -1 + 1e-6 count: the first hypothesis
    with the most counted inliers wins, its score -1, and its masks are
    taken."""
    feats, coeffs, _ = _inputs(4, "main")
    ok = torch.zeros(coeffs.shape[0], dtype=torch.bool)
    prep = prepare_features(feats, CAM)
    got = rs.score(coeffs, prep, CAM, RANSAC, ok=ok, caps=sc.CAPS)
    assert torch.equal(got.scores, torch.full_like(got.scores, -1.0))
    assert int(got.best) == int(torch.argmax(got.counts)) and float(got.score) == -1.0
    _, _, masks = _old_score_pose(coeffs[int(got.best)], prep, CAM, RANSAC)
    assert_bit_equal(got.masks, masks)
    want = _old_scoring(coeffs, ok, feats, CAM, RANSAC)
    assert int(got.best) == int(want[0])


def test_equal_ranks_take_the_first_index():
    """Copies of one hypothesis rank alike: the first copy wins, as
    ``torch.argmax`` takes the first maximum."""
    feats, coeffs, ok = _inputs(5, "main")
    prep = prepare_features(feats, CAM)
    best = int(rs.score(coeffs, prep, CAM, RANSAC, ok=ok, caps=sc.CAPS).best)
    copies = coeffs.clone()
    copies[:] = coeffs[best]
    assert int(rs.score(copies, prep, CAM, RANSAC, caps=sc.CAPS).best) == 0
    late = coeffs.clone()
    late[[10, 40, 90]] = coeffs[best]
    late[best] = coeffs[best] + 500.0   # far off: it loses its rank
    got = rs.score(late, prep, CAM, RANSAC, caps=sc.CAPS)
    assert int(got.best) == 10 and torch.equal(got.coeffs, coeffs[best])


@pytest.mark.parametrize("kind", ["main", "odd"])
def test_tested_values_give_the_masks(kind):
    """``details``' values, held to the limits, are ``inlier_masks_prepared``'s
    masks (every row of every hypothesis, before the features' masks)."""
    feats, coeffs, ok = _inputs(6, kind)
    prep = prepare_features(feats, CAM)
    _, values = rs.score(coeffs, prep, CAM, RANSAC, ok=ok, caps=sc.CAPS, details=True)
    tests = rs.value_tests(values, feats.capacities, RANSAC)
    got = [t & m for t, m in zip(tests, (prep.point_mask, prep.point2d_mask, prep.plane_mask,
                                         prep.line_mask))]
    quat, position = se3.coefficients_to_pose(coeffs)
    assert_bit_equal(got, inlier_masks_prepared(quat, position, prep, CAM, RANSAC))


def test_launch_threads():
    assert [rs.launch_threads(n) for n in (0, 1, 32, 33, 816, 1024, 1025, 1328)] \
        == [32, 32, 32, 64, 832, 1024, 1024, 1024]


def test_score_work_at_the_main_paths_shapes():
    """Hand counts at 96 hypotheses over (512, 256, 32, 16) rows, the winner's
    rows tested once more: 40,683 FLOPs a pass (512 x 29 + 256 x 70 + 32 x 212
    + 16 x 66 + 75); 20,912 bytes of features (the 1,056 projected points, the
    observations, the planes' two 4-vectors and the 816 masks), 24 of
    coefficients and 8 of score and count a hypothesis, 852 of the winner's
    outputs.  One pose: one pass."""
    work = rs.score_work(sc.MAIN, sc.HYPOTHESES)
    assert work == {"rows": 97 * 816, "flops": 97 * 40_683,
                    "bytes": 20_912 + 96 * 24 + 96 * 8 + 852}
    assert work["flops"] == 3_946_251 and work["bytes"] == 24_836
    assert rs.score_work(sc.MAIN, 1, batched=False) == {
        "rows": 816, "flops": 40_683, "bytes": 20_912 + 24 + 8 + 852}


class _CudaLooking(torch.Tensor):
    """A CPU tensor that says it lies on the card: the wrapper takes its CUDA
    path for it."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_the_wrapper_raises_and_never_falls_back(monkeypatch):
    """For CUDA tensors the wrapper launches its kernel or raises: when the
    library does not build, the error reaches the caller and the plain
    version is never called; what the kernel does not take raises before any
    build."""
    def refuse(*args, **kw):
        raise AssertionError("the plain version ran for a CUDA tensor")

    def no_nvcc(*args, **kw):
        raise RuntimeError("nvcc failed on ransac_score.cu")

    monkeypatch.setattr(rs, "score_reference", refuse)
    monkeypatch.setattr(rs.LIBRARY, "lib", None)
    monkeypatch.setattr(nvcc, "load_library", no_nvcc)
    coeffs, ok, prep, caps = sc.case(0, "tiny", h=8)
    cuda = [t.as_subclass(_CudaLooking) for t in (coeffs, ok, *prep)]
    prep_c = type(prep)(*cuda[2:])
    assert cuda[0].device.type == "cuda"
    with pytest.raises(RuntimeError, match="nvcc failed on ransac_score.cu"):
        rs.score(cuda[0], prep_c, CAM, RANSAC, ok=cuda[1], caps=caps)
    with pytest.raises(RuntimeError, match="nvcc failed on ransac_score.cu"):
        rs.score(cuda[0][0], prep_c, CAM, RANSAC)
    with pytest.raises(ValueError, match="float32"):
        rs.score(cuda[0].double().as_subclass(_CudaLooking), prep_c, CAM, RANSAC)
    with pytest.raises(ValueError, match="ok must be bool"):
        rs.score(cuda[0], prep_c, CAM, RANSAC, ok=cuda[1][:4], caps=caps)
    with pytest.raises(ValueError, match="feature block"):
        rs.score(cuda[0], prep, CAM, RANSAC, caps=caps)
    with pytest.raises(ValueError, match="unsupported device"):
        rs.score(torch.zeros(8, 6, device="meta"), prep, CAM, RANSAC)


def test_kernel_source_mirrors_the_wrapper():
    """The constants the kernel and its wrapper share, read from the source."""
    import os
    import re

    with open(os.path.join(nvcc.CSRC, "ransac_score.cu")) as f:
        text = f.read()
    assert int(re.search(r"#define RS_MAX_THREADS (\d+)", text).group(1)) == rs.MAX_THREADS
    fields = re.search(r"struct ScoreArgs \{(.*?)\};", text, re.S).group(1)
    fields = re.sub(r"//[^\n]*", "", fields)
    names = [name for decl in fields.split(";")[:-1]
             for name in re.findall(r"(\w+)(?:\[\d\])?\s*(?:,|$)", decl.strip())]
    assert names == [name for name, _ in rs._Args._fields_]
    assert float(re.search(r"#define RS_BIG ([\d.e]+)f", text).group(1)) == 1.0e4
    assert np.isclose(rs.WEIGHTS, (0.2, 0.2, 1 / 3, 0.2)).all()


@pytest.mark.parametrize("fault", ["none", "mask", "best", "far_value", "near_value"])
def test_score_agreement_refuses_planted_faults(fault):
    """``chip_smoke.score_agreement``, which holds the kernel to its plain
    version on the card, passes the plain version against itself and a value
    moved across its limit from within ``SCORE_FLIP_ULPS``, and refuses a mask
    bit, a best index or a decision off a value far from its limit."""
    import chip_smoke

    feats, coeffs, ok = _inputs(7, "main")
    prep = prepare_features(feats, CAM)
    want, want_values = rs.score(coeffs, prep, CAM, RANSAC, ok=ok, caps=sc.CAPS, details=True)
    got, got_values = want, want_values.clone()
    if fault == "mask":
        masks = list(got.masks)
        masks[0] = masks[0].clone()
        masks[0][0] = ~masks[0][0]
        got = got._replace(point_inliers=masks[0])
    elif fault == "best":
        got = got._replace(best=got.best + 1)
    elif fault in ("far_value", "near_value"):
        limit = rs.limits(RANSAC)[0]
        got_values[0, 0] = limit + (1.0 if fault == "far_value" else 2e-7)
        want_values = want_values.clone()
        want_values[0, 0] = limit - (1.0 if fault == "far_value" else 0.0)
    if fault in ("none", "near_value"):
        fields = chip_smoke.score_agreement(got, got_values, want, want_values,
                                            feats.capacities, fault)
        assert fields["unexplained_flips"] == 0
        assert fields["decision_flips"] == (1 if fault == "near_value" else 0)
    else:
        with pytest.raises(RuntimeError, match="disagrees with its plain version"):
            chip_smoke.score_agreement(got, got_values, want, want_values, feats.capacities,
                                       fault)
