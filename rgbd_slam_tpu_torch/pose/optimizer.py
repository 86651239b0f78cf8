"""6-DoF pose optimization: batched RANSAC + fixed-iteration Levenberg-Marquardt +
Monte-Carlo pose covariance (port of ``rgbd_slam_tpu/pose/optimizer.py``).

The JAX package vmaps one LM over hypotheses and Monte-Carlo members; here the
batch is a leading axis of every tensor.  The LM itself is ``ops/lm_cuda``: a
CUDA kernel on the card that carries the six tangents of the stacked residual
in registers, the counterpart of ``jax.linearize``, and on the CPU its plain
version, forward-mode AD (``torch.func.jvp`` vmapped over the 6 unit tangents).

Randomness: :class:`PoseDraws` holds every draw of one call.  Given, nothing is
drawn (the tests pass the JAX package's draws); absent, the draws come from the
``torch.Generator`` passed in.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import CameraIntrinsics, EngineConfig, RansacConfig
from ..geometry import pinhole, se3
from ..ops import lm_cuda, ransac_score_cuda
from ..ops.fast import top_k
from ..ops.p3p import p3p
from .features import MatchedFeatures
from .residuals import VariationNoise, prepare_features, random_variation


class PoseOptimizationResult(NamedTuple):
    success: torch.Tensor         # [] bool
    quat: torch.Tensor            # [4]
    position: torch.Tensor        # [3]
    covariance: torch.Tensor      # [6, 6] pose covariance (position + euler xyz)
    point_inliers: torch.Tensor   # [NP] bool
    point2d_inliers: torch.Tensor # [N2] bool
    plane_inliers: torch.Tensor   # [NK] bool
    line_inliers: torch.Tensor    # [NL] bool
    inlier_score: torch.Tensor    # [] total inlier score


class PoseDraws(NamedTuple):
    """Every random draw of :func:`compute_optimized_pose` (optimizer.py:132, :268
    and the Monte-Carlo variations of :370 in the JAX package)."""
    subset_priority: torch.Tensor  # [B, F] uniform [0, 1): RANSAC subset order
    p3p_priority: torch.Tensor     # [B3, NP] uniform [0, 1): P3P triplets
    noise: VariationNoise          # [1 + mc, ...] standard normal; member 0 unused


#: compact per-hypothesis subset capacities (points, 2D points, planes, lines)
_SUBSET_CAPS = (6, 6, 3, 6)
#: unified-subset draw size: any score-1.0 prefix fits in 8 draws
_SUBSET_DRAW = 8
#: compact capacities of the final refit + Monte-Carlo covariance
_REFIT_CAPS = (256, 128, 32, 16)


def draw_pose_draws(feats: MatchedFeatures, engine_cfg: EngineConfig,
                    generator: torch.Generator) -> PoseDraws:
    """Draw a :class:`PoseDraws` for ``feats`` from ``generator``."""
    return draw_pose_draws_for(feats.capacities, engine_cfg, generator,
                               device=feats.point_world.device,
                               dtype=feats.point_world.dtype)


def draw_pose_draws_for(capacities, engine_cfg: EngineConfig, generator: torch.Generator,
                        device=None, dtype=torch.float32) -> PoseDraws:
    """Draw a :class:`PoseDraws` for features of ``capacities`` (points, 2D
    points, planes, lines) from ``generator``."""
    f = sum(capacities)
    m = engine_cfg.pose_covariance_mc_iterations + 1
    cp, c2, ck, cl = _REFIT_CAPS

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device, dtype=dtype)

    return PoseDraws(
        subset_priority=torch.rand((engine_cfg.ransac_hypothesis_batch, f),
                                   generator=generator, device=device, dtype=dtype),
        p3p_priority=torch.rand((engine_cfg.p3p_hypothesis_batch, capacities[0]),
                                generator=generator, device=device, dtype=dtype),
        noise=VariationNoise(point=normal(m, cp, 3), theta=normal(m, c2),
                             phi=normal(m, c2), plane=normal(m, ck, 4),
                             line=normal(m, cl, 6)))


# ---------------------------------------------------------------------------
# Levenberg-Marquardt core
# ---------------------------------------------------------------------------

def lm_solve(coeffs0, feats: MatchedFeatures, cam: CameraIntrinsics, weights=None,
             iterations: int = 8, damping0: float = 1e-3):
    """Fixed-iteration damped least squares on the 6-dof pose coefficients, batched
    over the leading axes of ``coeffs0`` [..., 6] (and of ``feats``).  ``weights``
    (unified index space) keeps only the features with a positive weight.

    The features are prepared and packed once (``lm_cuda.pack``); CUDA tensors
    run the LM kernel (``csrc/lm.cu``), CPU tensors its plain version,
    ``lm_cuda.lm_solve_reference`` (forward-mode Jacobians by ``vmap(jvp)``).
    Returns (coeffs, final_cost)."""
    if weights is not None:
        feats = feats.with_masks(*(w > 0 for w in feats.split_unified(weights)))
    inputs = lm_cuda.pack(prepare_features(feats, cam), cam)
    return lm_cuda.lm_solve(inputs, coeffs0, iterations, damping0)


# ---------------------------------------------------------------------------
# RANSAC
# ---------------------------------------------------------------------------

def _draw_subsets(priorities, scores, valid):
    """Random subsets over the unified feature index space, each taken in random
    order until the cumulative score reaches 1.0.  ``priorities`` [B, F] uniform.
    Returns (indices [B, S], selected [B, S])."""
    priorities = torch.where(valid[None, :], priorities, -1.0)  # invalid drawn last
    _, idx = top_k(priorities, _SUBSET_DRAW)
    sub_scores = scores[idx] * valid[idx]
    csum = torch.cumsum(sub_scores, dim=-1)
    selected = ((csum - sub_scores) < 1.0) & (sub_scores > 0)
    return idx, selected


def compact_rows(mask, cap: int):
    """Indices of the first ``cap`` True entries of ``mask`` along its last axis
    (0 past the count) and the [.., cap] mask of filled rows."""
    rank = torch.cumsum(mask.to(torch.int64), dim=-1) - 1
    n = mask.shape[-1]
    src = torch.arange(n, device=mask.device).expand(mask.shape)
    dest = torch.where(mask & (rank < cap), rank, cap)
    out = torch.zeros(mask.shape[:-1] + (cap + 1,), dtype=torch.int64,
                      device=mask.device)
    out = out.scatter(-1, dest, src)[..., :cap]
    cnt = torch.clamp_max(mask.to(torch.int64).sum(dim=-1, keepdim=True), cap)
    return out, torch.arange(cap, device=mask.device) < cnt


def _gather_features(feats: MatchedFeatures, ip, mp_, i2, m2_, ik, mk_, il, ml_
                     ) -> MatchedFeatures:
    return MatchedFeatures(
        point_obs_uv=feats.point_obs_uv[ip], point_world=feats.point_world[ip],
        point_world_std=feats.point_world_std[ip], point_mask=mp_,
        point2d_obs_uv=feats.point2d_obs_uv[i2], point2d_state=feats.point2d_state[i2],
        point2d_state_std=feats.point2d_state_std[i2], point2d_mask=m2_,
        plane_cam=feats.plane_cam[ik], plane_world=feats.plane_world[ik],
        plane_world_std=feats.plane_world_std[ik], plane_mask=mk_,
        line_obs_p0=feats.line_obs_p0[il], line_obs_p1=feats.line_obs_p1[il],
        line_world=feats.line_world[il], line_world_std=feats.line_world_std[il],
        line_mask=ml_)


def _compact_subset(feats: MatchedFeatures, idx, sel) -> MatchedFeatures:
    """Gather each hypothesis' drawn features (unified indices ``idx`` [B, S],
    selection ``sel`` [B, S]) into small fixed-capacity blocks [B, cap, ...]."""
    np_, n2, nk, _ = feats.capacities
    cp, c2, ck, cl = _SUBSET_CAPS

    def compact_idx(type_mask, local_idx, cap):
        pos, keep = compact_rows(sel & type_mask, cap)
        return torch.gather(local_idx, -1, pos), keep

    ip, mp_ = compact_idx(idx < np_, idx, cp)
    i2, m2_ = compact_idx((idx >= np_) & (idx < np_ + n2), idx - np_, c2)
    ik, mk_ = compact_idx((idx >= np_ + n2) & (idx < np_ + n2 + nk), idx - np_ - n2, ck)
    il, ml_ = compact_idx(idx >= np_ + n2 + nk, idx - np_ - n2 - nk, cl)
    # a filled row's index is in range; an empty row gathers row 0 (masked out)
    return _gather_features(feats, ip * mp_, mp_, i2 * m2_, m2_, ik * mk_, mk_,
                            il * ml_, ml_)


def compact_features(feats: MatchedFeatures, caps: tuple = _REFIT_CAPS
                     ) -> MatchedFeatures:
    """Gather the masked rows of each feature block into fixed-capacity blocks."""
    cp, c2, ck, cl = caps
    ip, mp_ = compact_rows(feats.point_mask, cp)
    i2, m2_ = compact_rows(feats.point2d_mask, c2)
    ik, mk_ = compact_rows(feats.plane_mask, ck)
    il, ml_ = compact_rows(feats.line_mask, cl)
    return _gather_features(feats, ip, mp_, i2, m2_, ik, mk_, il, ml_)


def compute_optimized_pose(quat0, position0, feats: MatchedFeatures,
                           cam: CameraIntrinsics,
                           ransac_cfg: RansacConfig = RansacConfig(),
                           engine_cfg: EngineConfig = EngineConfig(),
                           generator: torch.Generator | None = None,
                           draws: PoseDraws | None = None,
                           compute_covariance: bool = True) -> PoseOptimizationResult:
    """RANSAC over feature subsets, LM refit on the best inlier set, Monte-Carlo
    covariance (``compute_covariance=False``: the refit alone and a covariance of
    1e-3 I).  Failure is reported through ``success``.  Either ``draws`` or a
    ``generator`` to draw them from must be given."""
    if draws is None:
        if generator is None:
            raise ValueError("compute_optimized_pose needs draws or a generator")
        draws = draw_pose_draws(feats, engine_cfg, generator)
    dt = position0.dtype
    coeffs0 = se3.pose_to_coefficients(quat0.to(dt), position0)
    scores = feats.scores()
    valid = feats.valid_mask()
    enough = torch.sum(scores) >= 1.0

    b = engine_cfg.ransac_hypothesis_batch
    dev = feats.point_world.device
    sub_idx, sub_sel = _draw_subsets(draws.subset_priority, scores, valid)
    hyp_coeffs, _ = lm_solve(coeffs0.expand(b, 6).contiguous(),
                             _compact_subset(feats, sub_idx, sub_sel), cam,
                             iterations=engine_cfg.lm_iterations)

    b3 = engine_cfg.p3p_hypothesis_batch
    if b3 > 0:
        pri = torch.where(feats.point_mask[None, :], draws.p3p_priority, 2.0)
        _, tri_idx = top_k(-pri, 3)                              # [b3, 3]
        tri_world = feats.point_world[tri_idx]
        tri_uv = feats.point_obs_uv[tri_idx]
        uv1 = torch.cat([tri_uv, torch.ones_like(tri_uv[..., :1])], dim=-1)
        dirs = pinhole.screen_to_camera(uv1, cam)
        bearings = dirs / torch.clamp_min(
            torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), 1e-9)
        enough_pts = torch.sum(feats.point_mask) >= 3
        q3, p3, ok3 = p3p(tri_world, bearings)                  # [b3, 4, ...]
        p3p_coeffs = se3.pose_to_coefficients(q3.reshape(-1, 4), p3.reshape(-1, 3))
        hyp_coeffs = torch.cat([hyp_coeffs, p3p_coeffs], dim=0)
        hyp_ok = torch.cat([torch.ones((b,), dtype=torch.bool, device=dev),
                            ok3.reshape(-1) & enough_pts])
    else:
        hyp_ok = torch.ones((b,), dtype=torch.bool, device=dev)

    # the hypotheses scored on the first _REFIT_CAPS live rows of each type,
    # the best one picked and its inlier masks taken over every row: one
    # launch of the scoring kernel on the card
    prep_all = prepare_features(feats, cam)
    hyp = ransac_score_cuda.score(hyp_coeffs, prep_all, cam, ransac_cfg, ok=hyp_ok,
                                  caps=_REFIT_CAPS)
    best_coeffs, best_score = hyp.coeffs, hyp.score
    inlier_feats = compact_features(feats.with_masks(*hyp.masks))
    if compute_covariance:
        final_coeffs, covariance = refit_with_variance(
            best_coeffs, inlier_feats, cam, draws.noise,
            mc_iterations=engine_cfg.pose_covariance_mc_iterations,
            lm_iterations=engine_cfg.refit_lm_iterations)
    else:
        final_coeffs, _ = lm_solve(best_coeffs, inlier_feats, cam,
                                   iterations=engine_cfg.refit_lm_iterations)
        covariance = torch.eye(6, dtype=dt, device=dev) * 1e-3

    final = ransac_score_cuda.score(final_coeffs, prep_all, cam, ransac_cfg)
    final_score = final.score
    success = enough & (best_score >= 1.0) & (final_score >= 1.0) \
        & torch.isfinite(final_coeffs).all()

    quat, position = se3.coefficients_to_pose(final_coeffs)
    quat = se3.quat_normalize(quat)
    return PoseOptimizationResult(
        success=success, quat=quat, position=position, covariance=covariance,
        point_inliers=final.point_inliers, point2d_inliers=final.point2d_inliers,
        plane_inliers=final.plane_inliers, line_inliers=final.line_inliers,
        inlier_score=final_score)


# ---------------------------------------------------------------------------
# Monte-Carlo pose covariance
# ---------------------------------------------------------------------------

def _pose_vector(coeffs):
    """Pose 6-vector [position, euler xyz] for covariance statistics (R = Rx(a)
    Ry(b) Rz(c))."""
    quat, position = se3.coefficients_to_pose(coeffs)
    m = se3.quat_to_matrix(quat)
    b = torch.arcsin(torch.clamp(m[..., 0, 2], -1.0, 1.0))
    a = torch.arctan2(-m[..., 1, 2], m[..., 2, 2])
    c = torch.arctan2(-m[..., 0, 1], m[..., 0, 0])
    return torch.cat([position, torch.stack([a, b, c], dim=-1)], dim=-1)


def refit_with_variance(coeffs0, inlier_feats: MatchedFeatures, cam: CameraIntrinsics,
                        noise: VariationNoise, mc_iterations: int = 100,
                        lm_iterations: int = 6):
    """Final inlier refit fused with the Monte-Carlo pose covariance: one LM batch
    of ``1 + mc_iterations`` members from the best hypothesis.  Member 0 is
    unperturbed and is the refit; members 1.. perturb every inlier feature by its
    std dev, and the sample covariance of their solutions (+1e-3 diagonal floor)
    is the pose covariance."""
    m = mc_iterations + 1
    scales = (torch.arange(m, device=coeffs0.device) > 0).to(coeffs0.dtype)
    var_feats = random_variation(inlier_feats, noise, scale=scales)
    cs, _ = lm_solve(coeffs0.expand(m, 6).contiguous(), var_feats, cam, iterations=lm_iterations)
    return cs[0], _sample_covariance(_pose_vector(cs[1:]))


def _sample_covariance(vecs):
    """Sample covariance of the pose vectors [n, 6] + 1e-3 on the diagonal."""
    centered = vecs - torch.mean(vecs, dim=0, keepdim=True)
    cov = (centered.T @ centered) / (vecs.shape[0] - 1)
    return cov + 1e-3 * torch.eye(6, dtype=cov.dtype, device=cov.device)


def compute_pose_variance(coeffs_opt, inlier_feats: MatchedFeatures, cam: CameraIntrinsics,
                          noise: VariationNoise, iterations: int = 100,
                          lm_iterations: int = 16):
    """Sample covariance of re-optimized poses under feature noise: ``noise``
    holds one perturbation per member on its leading axis ([iterations, ...]),
    each member re-runs LM from ``coeffs_opt``, +1e-3 on the diagonal."""
    var_feats = random_variation(inlier_feats, noise)
    cs, _ = lm_solve(coeffs_opt.expand(iterations, 6).contiguous(), var_feats, cam,
                     iterations=lm_iterations)
    return _sample_covariance(_pose_vector(cs))
