"""Windowed bundle adjustment by Schur-complement landmark elimination, on one
device or sharded by landmarks over a ``torch.distributed`` process group (port
of ``rgbd_slam_tpu/parallel/ba.py``).

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

The sharded solve (``make_sharded_ba``) takes the place of the JAX package's
``shard_map`` over a device mesh: one process per shard, each holding ``L / W``
landmarks and their observations and the replicated poses.  Landmark
elimination and back-substitution are local; the pose blocks, the right-hand
sides, the Schur correction and the cost are summed over the ranks in one
``all_reduce`` per iteration.  With ``reduced_solver="pcg"`` the Schur
correction is summed by ``reduce_scatter`` instead, so that each rank receives
only its block of rows of the [6K, 6K] reduced system, and the system is solved
by Jacobi-preconditioned conjugate gradients whose matrix-vector product ends
in an ``all_gather``.  Sums over ranks run in another order than the
single-device sums, so the two agree to rounding, not to the bit; two sharded
runs over the same number of ranks agree to the bit.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
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


def init_distributed(init_method: str | None = None, world_size: int | None = None,
                     rank: int | None = None, backend: str | None = None) -> bool:
    """Join this process to the others of a multi-process run, after which
    :func:`make_sharded_ba` over ``dist.group.WORLD`` spans them.  Arguments
    left None come from the environment: ``MASTER_ADDR`` and ``MASTER_PORT``
    (for ``init_method``), ``WORLD_SIZE`` and ``RANK``.  Returns False, having
    done nothing, for a single process or without an address, and True once the
    process group stands.

    ``backend`` None picks ``nccl`` where every rank of this host has a card of
    its own and ``gloo`` otherwise (no card, or ranks that share one: NCCL
    refuses two ranks on one device)."""
    if init_method is None and os.environ.get("MASTER_ADDR"):
        init_method = (f"tcp://{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    if not init_method or world_size <= 1:
        return False
    if backend is None:
        own_card = torch.cuda.is_available() and torch.cuda.device_count() >= world_size
        backend = "nccl" if own_card else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    return True


# newer PyTorch renames the two single-tensor collectives and deprecates the old names
_all_gather_tensor = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_tensor = (getattr(dist, "reduce_scatter_single", None)
                          or dist.reduce_scatter_tensor)


def _emulated(group, tensor, collective: str) -> bool:
    """Whether ``collective`` must be expressed by ``all_reduce`` on this
    group: gloo has no ``reduce_scatter_tensor`` and, on CUDA tensors, only
    ``broadcast`` and ``all_reduce``."""
    if dist.get_backend(group) != "gloo":
        return False
    return collective == "reduce_scatter" or tensor.is_cuda


def all_gather_rows(local, group):
    """[R, ...] per rank -> [W * R, ...] on every rank, in rank order.  Where
    the backend has no ``all_gather`` for this tensor it is an ``all_reduce`` of
    a buffer that is zero outside this rank's rows."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    local = local.contiguous()
    out = local.new_zeros((world * local.shape[0], *local.shape[1:]))
    if _emulated(group, local, "all_gather"):
        out[rank * local.shape[0]:(rank + 1) * local.shape[0]] = local
        dist.all_reduce(out, group=group)
    else:
        _all_gather_tensor(out, local, group=group)
    return out


def reduce_scatter_rows(full, group):
    """[W * R, ...] per rank -> the sum over ranks of this rank's [R, ...] block
    of rows.  Where the backend has no ``reduce_scatter`` it is an
    ``all_reduce`` and a slice: the rank then holds the whole sum for a moment,
    which is a property of that backend, not of the solve."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    rows = full.shape[0] // world
    full = full.contiguous()
    if _emulated(group, full, "reduce_scatter"):
        summed = full.clone()
        dist.all_reduce(summed, group=group)
        return summed[rank * rows:(rank + 1) * rows].clone()
    out = full.new_empty((rows, *full.shape[1:]))
    _reduce_scatter_tensor(out, full, group=group)
    return out


def _reduced_solve_pcg(s_rows, rhs, group, cg_iterations: int):
    """Distributed solve of the reduced camera system ``S x = rhs`` by
    Jacobi-preconditioned conjugate gradients.  The [6K, 6K] matrix lives as
    blocks of rows, one per rank (``s_rows`` [6K / W, 6K]); the iterate is
    replicated; each matrix-vector product is a local [R, N] x [N] product
    followed by an ``all_gather``.  A fixed ``cg_iterations`` steps, no early
    exit: every rank makes the same collectives.  Returns x [N], the same bits
    on every rank."""
    r_loc = s_rows.shape[0]
    row0 = dist.get_rank(group) * r_loc
    local = torch.arange(r_loc, device=s_rows.device)
    diag = all_gather_rows(s_rows[local, row0 + local], group)
    minv = 1.0 / torch.clamp_min(diag, 1e-12)

    x = torch.zeros_like(rhs)
    r = rhs
    z = minv * r
    p = z
    rz = torch.dot(r, z)
    for _ in range(cg_iterations):
        q = all_gather_rows(s_rows @ p, group)
        alpha = rz / torch.clamp_min(torch.dot(p, q), 1e-30)
        x = x + alpha * p
        r = r - alpha * q
        z = minv * r
        rz_new = torch.dot(r, z)
        beta = rz_new / torch.clamp_min(rz, 1e-30)
        p = z + beta * p
        rz = rz_new
    return x


def _gn_iteration(poses, landmarks, obs_kf, obs_uv, obs_mask, cam: CameraIntrinsics,
                  n_keyframes: int, group=None, pose_anchor=None, lm_anchor=None,
                  reduced_solver: str = "dense", cg_iterations: int = 0,
                  anchor_weights: tuple | None = None, obs_z=None):
    """One Schur-complement Gauss-Newton step.  ``pose_anchor`` / ``lm_anchor``
    add prior residuals pulling toward the odometry poses and the filtered
    landmark positions.  Returns (poses, landmarks, cost before the step).

    With ``group`` (a process group) the landmark arguments are this rank's
    shard, and the sums over landmarks are completed over the ranks: the pose
    blocks, both right-hand sides, the Schur correction and the cost in one
    ``all_reduce``.  ``reduced_solver`` picks how the [6K, 6K] reduced system is
    then solved: "dense" repeats a Cholesky on every rank (best for live
    windows, K <= 16); "pcg" sums the Schur correction by ``reduce_scatter``
    into blocks of rows and solves by distributed conjugate gradients
    (:func:`_reduced_solve_pcg`; ``cg_iterations`` 0 means 6K steps), so the
    system is partitioned by landmarks for the elimination and by keyframe rows
    for the solve.  Without a group "pcg" is the dense solve.

    A reduced system that is not positive definite gives NaN poses instead of
    an error, and the cost of NaN poses is NaN, so that the caller's
    finite-cost test refuses the window.  (The residual of a NaN pose is masked
    to zero like any invalid projection, so the plain sum would be 0 there,
    which is what the JAX package reports.)  The poses are replicated, so every
    rank sees the same NaN and takes the same branch."""
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
    cost = torch.where(torch.isfinite(poses).all(), torch.sum(r * r),
                       torch.full((), float("nan"), dtype=dt, device=dev))

    use_pcg = group is not None and reduced_solver == "pcg"
    if group is not None:
        # one collective an iteration for everything that is summed whole
        parts = [hpp, bp, bp_corr, cost] + ([] if use_pcg else [s_corr])
        packed = torch.cat([x.reshape(-1) for x in parts])
        dist.all_reduce(packed, group=group)
        summed = torch.split(packed, [x.numel() for x in parts])
        hpp, bp, bp_corr, cost = (y.reshape(x.shape) for x, y in zip(parts[:4], summed))
        if use_pcg:
            s_rows = reduce_scatter_rows(s_corr, group)
        else:
            s_corr = summed[4].reshape(n, n)

    # the odometry prior is added once, after the sum over ranks
    if pose_anchor is not None:
        wdiag = torch.cat([torch.full((3,), pos_w, dtype=dt, device=dev),
                           torch.full((3,), rot_w, dtype=dt, device=dev)])
        hpp = hpp + torch.diag(wdiag)[None, :, :]
        bp = bp + wdiag[None, :] * (poses - pose_anchor)

    eye_n = torch.eye(n, dtype=dt, device=dev)
    fix = torch.arange(n, device=dev) < 6                # gauge: freeze keyframe 0
    rhs = torch.where(fix, torch.zeros((), dtype=dt, device=dev), (bp - bp_corr).reshape(n))
    if use_pcg:
        r_loc = s_rows.shape[0]
        rr = dist.get_rank(group) * r_loc + torch.arange(r_loc, device=dev)  # global rows
        s_rows = torch.block_diag(*hpp)[rr] - s_rows
        # gauge fix and damping on this rank's block of rows
        s_rows = torch.where((rr < 6)[:, None] | fix[None, :], eye_n[rr], s_rows)
        s_rows = s_rows + DAMPING * eye_n[rr]
        delta_p = _reduced_solve_pcg(s_rows, -rhs, group,
                                     cg_iterations if cg_iterations > 0 else n).reshape(k, 6)
    else:
        s_mat = torch.block_diag(*hpp) - s_corr
        s_mat = torch.where(fix[:, None] | fix[None, :], eye_n, s_mat) + DAMPING * eye_n
        chol, info = torch.linalg.cholesky_ex(s_mat)
        chol = torch.where(info == 0, chol, torch.full_like(chol, float("nan")))
        delta_p = torch.cholesky_solve(-rhs[:, None], chol)[:, 0].reshape(k, 6)

    # landmark back-substitution: dl = -Hll^-1 (bl + W^T dp)
    dp_per_obs = delta_p[obs_kf.to(torch.int64)]         # [L, C, 6]
    wt_dp = torch.einsum("lcij,lci->lj", w, dp_per_obs)
    delta_l = -torch.einsum("lij,lj->li", hll_inv, bl + wt_dp)
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


def make_sharded_ba(group, cam: CameraIntrinsics, n_keyframes: int, iterations: int = 8,
                    anchored: bool = False, reduced_solver: str = "dense",
                    cg_iterations: int = 0, anchor_weights: tuple | None = None,
                    with_depth: bool = False):
    """Build the distributed BA solve over the process group ``group``:
    landmarks and observations sharded by rank, the poses replicated, the
    reduced camera system summed over the ranks.

    ``reduced_solver="pcg"`` also shards the [6K, 6K] reduced system into
    blocks of rows and solves it by distributed conjugate gradients; 6K must be
    divisible by the group's size.  ``cg_iterations`` 0 means 6K steps (exact
    in exact arithmetic).

    Returns ``fn(poses, landmarks_shard, obs_kf_shard, obs_uv_shard,
    obs_mask_shard[, obs_z_shard]) -> (poses, landmarks_shard, costs)``, which
    every rank of the group calls; ``obs_z_shard`` belongs to ``with_depth``."""
    if reduced_solver == "pcg":
        world = dist.get_world_size(group)
        assert (6 * n_keyframes) % world == 0, \
            f"pcg reduced solve needs 6*K ({6 * n_keyframes}) divisible by " \
            f"the group size ({world})"

    def solve(poses, landmarks, obs_kf, obs_uv, obs_mask, obs_z=None):
        if (obs_z is not None) != with_depth:
            raise TypeError(f"with_depth={with_depth}: obs_z_shard "
                            f"{'missing' if with_depth else 'not expected'}")
        pose_anchor = poses if anchored else None
        lm_anchor = landmarks if anchored else None
        p, lm = poses, landmarks
        costs = []
        for _ in range(iterations):
            p, lm, cost = _gn_iteration(
                p, lm, obs_kf, obs_uv, obs_mask, cam, n_keyframes, group=group,
                pose_anchor=pose_anchor, lm_anchor=lm_anchor, reduced_solver=reduced_solver,
                cg_iterations=cg_iterations, anchor_weights=anchor_weights, obs_z=obs_z)
            costs.append(cost)
        return p, lm, torch.stack(costs)

    return solve
