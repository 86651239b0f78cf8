"""Windowed bundle adjustment by Schur-complement landmark elimination (port of
the single-device part of ``rgbd_slam_tpu/parallel/ba.py``).

Data layout (landmark-major):

* poses      [K, 6]    pose coefficients (position + stereographic quaternion)
* landmarks  [L, 3]    world points (mm)
* obs_kf     [L, C]    keyframe index of each observation (int)
* obs_uv     [L, C, 2] pixel observations
* obs_z      [L, C]    measured depths (mm, 0 = none)
* obs_mask   [L, C]    validity

One Gauss-Newton iteration: the 3x3 landmark blocks and the 6x3 coupling blocks
per observation, the reduced camera system ``S = Hpp - W Hll^-1 W^T`` summed
over keyframe pairs, the gauge fixed on keyframe 0, a dense Cholesky solve of
the [6K, 6K] system, and the landmarks' back-substitution.

The sums over keyframes stay contractions with a one-hot (einsums and one
matmul) as in the JAX package: their order is fixed, so a solve gives the same
bits from run to run on the card, which ``index_add_`` (atomics) would not.

The sharded solve (``make_sharded_ba``, the PCG reduced solve and
``init_distributed`` of the JAX module) is not ported yet: asking for a mesh
raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.func import jvp, vmap

from ..config import CameraIntrinsics, DepthNoiseModel
from ..geometry import pinhole, se3
from ..pose.linalg6 import inv3

DAMPING = 1e-4
HUBER_PX = 3.0   # robust-kernel scale = the engine's point inlier gate

# Prior (anchor) weights, 1 / sigma^2 in residual space: landmark anchor sigma
# 30 mm, odometry position sigma 20 mm, stereographic coefficient sigma 0.006
# (~0.7 deg).  Loose anchors suit the solve once it carries the depth row.
LM_PRIOR_W = 1.0 / (30.0 ** 2)
POSE_PRIOR_POS_W = 1.0 / (20.0 ** 2)
POSE_PRIOR_ROT_W = 1.0 / (0.006 ** 2)

_SHARDED = ("the sharded BA solve (a device mesh, the PCG reduced solve) is not ported "
            "yet: ROADMAP queue 1 #11, the sharded slice")


def _depth_sigma_mm(z):
    """Kinect depth-quantization sigma, the model the front-end filters use."""
    m = DepthNoiseModel()
    return torch.clamp_min(m.quadratic * z * z + m.linear * z + m.constant, m.floor_mm)


def _project_residual(pose6, landmark, uv, z_obs, cam: CameraIntrinsics, z_weight):
    """RGB-D observation residual [..., 3] of a landmark in a keyframe:
    (du, dv, w_z * dz).  The depth row carries the metric depth that the
    front-end filters fuse every frame into the window solve; it is zero where
    no depth was measured."""
    quat, pos = se3.coefficients_to_pose(pose6)
    w2c = se3.world_to_camera(quat, pos)
    proj, valid = pinhole.world_to_screen(landmark, w2c, cam)
    r_uv = torch.where(valid[..., None], uv - proj[..., :2], torch.zeros_like(uv))
    dz = torch.where(valid & (z_obs > 0.0), (z_obs - proj[..., 2]) * z_weight,
                     torch.zeros_like(z_obs))
    return torch.cat([r_uv, dz[..., None]], dim=-1)


def _ba_blocks(poses, landmarks, obs_kf, obs_uv, obs_mask, cam: CameraIntrinsics,
               obs_z=None):
    """Per-observation residuals and Jacobian blocks over [L, C]: r [L, C, 3],
    jp [L, C, 3, 6] (pose), jl [L, C, 3, 3] (landmark).

    Each carries a Huber IRLS weight sqrt(HUBER_PX / |r|) beyond the kernel
    scale, taken over all three rows (the depth row is in px-equivalent sigma
    units), so one wrong association does not drag the window.  The Jacobians
    come from forward-mode AD: one ``jvp`` of the batched residual, vmapped
    over the 9 unit tangents of (pose, landmark)."""
    dt = poses.dtype
    dev = poses.device
    if obs_z is None:
        obs_z = torch.zeros(obs_mask.shape, dtype=obs_uv.dtype, device=dev)
    n_l, n_c = obs_mask.shape
    pose6 = poses[obs_kf.to(torch.int64)]                        # [L, C, 6]
    lm = landmarks[:, None, :].expand(n_l, n_c, 3).contiguous()
    # px-equivalent information weight of the depth row: ~1 px of screen sigma
    # against sigma_z(z) mm of depth sigma
    zw = torch.where(obs_z > 0.0, 1.0 / _depth_sigma_mm(torch.clamp_min(obs_z, 1.0)),
                     torch.zeros_like(obs_z))

    def rf(p6, l3):
        return _project_residual(p6, l3, obs_uv, obs_z, cam, zw)

    eye9 = torch.eye(9, dtype=dt, device=dev)
    tan_p = eye9[:, None, None, :6].expand(9, n_l, n_c, 6)
    tan_l = eye9[:, None, None, 6:].expand(9, n_l, n_c, 3)
    r, jac = vmap(lambda tp, tl: jvp(rf, (pose6, lm), (tp, tl)),
                  out_dims=(0, -1))(tan_p, tan_l)
    r = r[0]                                                     # [L, C, 3]
    rn = torch.linalg.vector_norm(r, dim=-1)
    hub = torch.sqrt(HUBER_PX / torch.clamp_min(rn, HUBER_PX))
    m = (obs_mask.to(dt) * hub)[..., None]
    return r * m, jac[..., :6] * m[..., None], jac[..., 6:] * m[..., None]


def _gn_iteration(poses, landmarks, obs_kf, obs_uv, obs_mask, cam: CameraIntrinsics,
                  n_keyframes: int, axis_name=None, pose_anchor=None, lm_anchor=None,
                  reduced_solver: str = "dense", cg_iterations: int = 0,
                  anchor_weights: tuple | None = None, obs_z=None):
    """One Schur-complement Gauss-Newton step.  ``pose_anchor`` / ``lm_anchor``
    add prior residuals pulling toward the odometry poses and the filtered
    landmark positions.  Returns (poses, landmarks, cost before the step).

    A reduced system that is not positive definite gives NaN poses instead of
    an error, and the cost of NaN poses is NaN, so that the caller's
    finite-cost test refuses the window.  (The residual of a NaN pose is masked
    to zero like any invalid projection, so the plain sum would be 0 there,
    which is what the JAX package reports.)  ``axis_name`` (a mesh axis),
    ``reduced_solver="pcg"`` and ``cg_iterations`` belong to the sharded solve."""
    if axis_name is not None or reduced_solver != "dense" or cg_iterations:
        raise NotImplementedError(_SHARDED)
    k = n_keyframes
    dt = poses.dtype
    dev = poses.device
    r, jp, jl = _ba_blocks(poses, landmarks, obs_kf, obs_uv, obs_mask, cam, obs_z=obs_z)

    lm_w, pos_w, rot_w = (anchor_weights if anchor_weights is not None
                          else (LM_PRIOR_W, POSE_PRIOR_POS_W, POSE_PRIOR_ROT_W))
    lm_prior_w = lm_w if lm_anchor is not None else 0.0
    eye3 = torch.eye(3, dtype=dt, device=dev)
    hll = torch.einsum("lcri,lcrj->lij", jl, jl) + (DAMPING + lm_prior_w) * eye3
    bl = torch.einsum("lcri,lcr->li", jl, r)
    if lm_anchor is not None:
        bl = bl + lm_prior_w * (landmarks - lm_anchor)
    hll_inv = inv3(hll)

    # per-observation pose blocks
    w = torch.einsum("lcri,lcrj->lcij", jp, jl)          # [L, C, 6, 3]
    hpp_obs = torch.einsum("lcri,lcrj->lcij", jp, jp)    # [L, C, 6, 6]
    bp_obs = torch.einsum("lcri,lcr->lci", jp, r)        # [L, C, 6]

    # keyframe assignment as a one-hot: every sum over keyframes is a
    # contraction.  Masked observations have zeroed blocks already.
    e = F.one_hot(obs_kf.to(torch.int64), k).to(dt)      # [L, C, K]
    hpp = torch.einsum("lck,lcij->kij", e, hpp_obs)
    bp = torch.einsum("lck,lci->ki", e, bp_obs)

    # Schur correction S[k1, k2] -= sum_l (e w Hll^-1)(e w)^T as one
    # [6K, 3L] x [3L, 6K] product
    y = torch.einsum("lcij,ljk->lcik", w, hll_inv)       # [L, C, 6, 3]
    u = torch.einsum("lck,lcia->lkia", e, y)             # [L, K, 6, 3]
    v = torch.einsum("lck,lcja->lkja", e, w)             # [L, K, 6, 3]
    n_l = u.shape[0]
    n = k * 6

    def rows(x):
        return x.reshape(n_l, n, 3).permute(1, 0, 2).reshape(n, n_l * 3)

    s_corr = rows(u) @ rows(v).T                         # [6K, 6K]
    bp_corr = torch.einsum("lkia,la->ki", u, bl)         # [K, 6]

    if pose_anchor is not None:
        wdiag = torch.cat([torch.full((3,), pos_w, dtype=dt, device=dev),
                           torch.full((3,), rot_w, dtype=dt, device=dev)])
        hpp = hpp + torch.diag(wdiag)[None, :, :]
        bp = bp + wdiag[None, :] * (poses - pose_anchor)

    eye_n = torch.eye(n, dtype=dt, device=dev)
    fix = torch.arange(n, device=dev) < 6                # gauge: freeze keyframe 0
    rhs = torch.where(fix, torch.zeros((), dtype=dt, device=dev), (bp - bp_corr).reshape(n))
    s_mat = torch.block_diag(*hpp) - s_corr
    s_mat = torch.where(fix[:, None] | fix[None, :], eye_n, s_mat) + DAMPING * eye_n
    chol, info = torch.linalg.cholesky_ex(s_mat)
    chol = torch.where(info == 0, chol, torch.full_like(chol, float("nan")))
    delta_p = torch.cholesky_solve(-rhs[:, None], chol)[:, 0].reshape(k, 6)

    # landmark back-substitution: dl = -Hll^-1 (bl + W^T dp)
    dp_per_obs = delta_p[obs_kf.to(torch.int64)]         # [L, C, 6]
    wt_dp = torch.einsum("lcij,lci->lj", w, dp_per_obs)
    delta_l = -torch.einsum("lij,lj->li", hll_inv, bl + wt_dp)
    cost = torch.where(torch.isfinite(poses).all(), torch.sum(r * r),
                       torch.full((), float("nan"), dtype=dt, device=dev))
    return poses + delta_p, landmarks + delta_l, cost


def ba_solve(poses, landmarks, obs_kf, obs_uv, obs_mask, cam: CameraIntrinsics,
             iterations: int = 8, anchored: bool = False,
             anchor_weights: tuple | None = None, obs_z=None):
    """Single-device windowed BA.  ``anchored=True`` adds the odometry and map
    priors (the live-pipeline mode); ``anchor_weights`` = (landmark, position,
    rotation) information weights, the module constants by default; ``obs_z``
    [L, C] measured depths (mm) add the depth residual row.  Returns (poses,
    landmarks, costs [iterations]: the cost before each step)."""
    k = poses.shape[0]
    pose_anchor = poses if anchored else None
    lm_anchor = landmarks if anchored else None
    p, lm = poses, landmarks
    costs = []
    for _ in range(iterations):
        p, lm, cost = _gn_iteration(p, lm, obs_kf, obs_uv, obs_mask, cam, k,
                                    pose_anchor=pose_anchor, lm_anchor=lm_anchor,
                                    anchor_weights=anchor_weights, obs_z=obs_z)
        costs.append(cost)
    return p, lm, torch.stack(costs)
