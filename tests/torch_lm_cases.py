"""Pose-optimization inputs for the LM solve's tests (``test_torch_lm_cuda.py`` on
the CPU, ``test_torch_cuda.py`` on the card): seeded scenes with all four
feature types, the RANSAC hypothesis batch and the refit + Monte-Carlo batch
built from them as the pose optimizer builds them, the edge cases, and the
LM kernel's own edges (:func:`kernel_edge_cases`).  Imports torch and the port
only."""

import functools

import numpy as np
import torch

from rgbd_slam_tpu_torch import config
from rgbd_slam_tpu_torch.geometry import se3
from rgbd_slam_tpu_torch.pose import optimizer
from rgbd_slam_tpu_torch.pose.features import make_matched_features
from rgbd_slam_tpu_torch.pose.residuals import VariationNoise, random_variation

CAM = config.TUM_FR1


def scene(seed, counts=(20, 6, 3, 5), caps=(24, 8, 4, 6)):
    """Matched features of a posed camera, all four types: 3D points with 0.3 px
    noise, inverse-depth points on their rays, planes and lines seen from the
    pose with small noise.  Returns (features, the true pose's coefficients,
    a start 15 mm and ~1 degree off)."""
    rng = np.random.default_rng(seed)
    q = se3.quat_normalize(torch.tensor([1.0, 0.02 * (seed % 5), -0.03, 0.01]))
    p = torch.tensor([120.0, -40.0, 30.0])
    c2w = se3.camera_to_world(q, p).double().numpy()
    rot, t = c2w[:3, :3], c2w[:3, 3]
    n_pts, n_2d, n_pl, n_ln = counts

    def unproject(uv, z):
        return np.concatenate([(uv - [CAM.cx, CAM.cy]) / [CAM.fx, CAM.fy] * z, z], -1)

    def to_world(x_cam):
        return x_cam @ rot.T + t

    uv = rng.uniform([20, 20], [620, 460], (n_pts, 2))
    world = to_world(unproject(uv, rng.uniform(800, 4000, (n_pts, 1))))
    obs = uv + rng.normal(0, 0.3, uv.shape)
    uv2 = rng.uniform([20, 20], [620, 460], (n_2d, 2))
    rays = unproject(uv2, np.ones((n_2d, 1))) @ rot.T
    theta = np.arctan2(np.hypot(rays[:, 0], rays[:, 1]), rays[:, 2])
    phi = np.arctan2(rays[:, 1], rays[:, 0])
    state2d = np.concatenate([np.tile(t, (n_2d, 1)), np.full((n_2d, 1), 5e-4),
                              theta[:, None], phi[:, None]], -1)
    normals = rng.normal(0, 1, (n_pl, 3)) + [0.0, 0.0, -2.0]
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    plane_cam = np.concatenate([normals, rng.uniform(1000, 3000, (n_pl, 1))], -1)
    to_world_plane = se3.plane_camera_to_world_matrix(torch.as_tensor(c2w)).numpy()
    plane_world = plane_cam @ to_world_plane.T
    plane_obs = plane_cam + rng.normal(0, [0.002, 0.002, 0.002, 2.0], plane_cam.shape)
    plane_obs[:, :3] /= np.linalg.norm(plane_obs[:, :3], axis=-1, keepdims=True)
    e_uv = rng.uniform([40, 40], [600, 440], (n_ln, 2, 2))
    e_world = to_world(unproject(e_uv.reshape(-1, 2), rng.uniform(1000, 3000, (2 * n_ln, 1))))
    line_obs = e_uv + rng.normal(0, 0.3, e_uv.shape)
    f32 = np.float32
    feats = make_matched_features(
        point_obs_uv=obs.astype(f32), point_world=world.astype(f32),
        point_world_std=np.full((n_pts, 3), 5.0, f32), point2d_obs_uv=uv2.astype(f32),
        point2d_state=state2d.astype(f32),
        point2d_state_std=np.tile([1.0, 1.0, 1.0, 2.5e-4, 0.01, 0.01], (n_2d, 1)).astype(f32),
        plane_cam=plane_obs.astype(f32), plane_world=plane_world.astype(f32),
        plane_world_std=np.tile([0.01, 0.01, 0.01, 5.0], (n_pl, 1)).astype(f32),
        line_obs_p0=line_obs[:, 0].astype(f32), line_obs_p1=line_obs[:, 1].astype(f32),
        line_world=e_world.reshape(n_ln, 6).astype(f32),
        line_world_std=np.full((n_ln, 6), 5.0, f32), capacities=caps, device="cpu")
    q0 = se3.quat_normalize(q + torch.tensor([0.0, 0.01, 0.0, -0.01]))
    return (feats, se3.pose_to_coefficients(q, p),
            se3.pose_to_coefficients(q0, p + torch.tensor([15.0, -10.0, 8.0])))


def edge_scene(seed):
    """The scene with a point behind the camera, an inverse-depth point whose
    far and near estimates coincide (rho std 0: a zero-length segment) and a
    line whose two endpoints coincide (degenerate)."""
    feats, c_true, c0 = scene(seed)
    quat, position = se3.coefficients_to_pose(c_true)
    behind = (se3.camera_to_world(quat, position)
              @ torch.tensor([50.0, -20.0, -1500.0, 1.0]))[:3]
    point_world = feats.point_world.clone()
    point_world[0] = behind
    state_std = feats.point2d_state_std.clone()
    state_std[0, 3] = 0.0
    line_world = feats.line_world.clone()
    line_world[0, 3:] = line_world[0, :3]
    return feats._replace(point_world=point_world, point2d_state_std=state_std,
                          line_world=line_world), c_true, c0


def assert_bit_equal(got, want):
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g.reshape(-1).view(torch.uint8), w.reshape(-1).view(torch.uint8)), \
            (g, w)


def hypothesis_batch(seed, b=16, counts=(20, 6, 3, 5), caps=(24, 8, 4, 6)):
    """The RANSAC hypotheses' LM inputs: ``b`` random subsets of a scene,
    compacted to ``optimizer._SUBSET_CAPS`` as ``compute_optimized_pose`` does."""
    feats, _, c0 = scene(seed, counts, caps)
    rng = np.random.default_rng(seed + 100)
    priorities = torch.as_tensor(rng.uniform(size=(b, sum(feats.capacities))),
                                 dtype=torch.float32)
    idx, sel = optimizer._draw_subsets(priorities, feats.scores(), feats.valid_mask())
    return optimizer._compact_subset(feats, idx, sel), c0.expand(b, 6).contiguous()


def refit_batch(seed, members=9, counts=(20, 6, 3, 5), caps=(24, 8, 4, 6),
                refit_caps=(32, 8, 4, 8)):
    """The refit + Monte-Carlo LM inputs: a scene's features compacted to
    ``refit_caps`` and perturbed by seeded noise, member 0 unperturbed, as
    ``refit_with_variance`` builds them."""
    feats, _, c0 = scene(seed, counts, caps)
    inliers = optimizer.compact_features(feats, refit_caps)
    rng = np.random.default_rng(seed + 200)

    def normal(*shape):
        return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)

    cp, c2, ck, cl = inliers.capacities
    noise = VariationNoise(point=normal(members, cp, 3), theta=normal(members, c2),
                           phi=normal(members, c2), plane=normal(members, ck, 4),
                           line=normal(members, cl, 6))
    scales = (torch.arange(members) > 0).to(torch.float32)
    return random_variation(inliers, noise, scale=scales), c0.expand(members, 6).contiguous()


def main_path_batches(seed):
    """Both LM calls of a step at the main path's shapes (default
    ``EngineConfig``): 32 hypotheses over subsets of (6, 6, 3, 6), 10
    iterations; the refit and 100 Monte-Carlo members over (256, 128, 32, 16),
    6 iterations; from a scene with every block partly filled.  {name:
    (features, coeffs0, iterations)}."""
    counts, caps = (200, 60, 12, 12), (256, 128, 32, 16)
    eng = config.EngineConfig()
    hyp, c0_hyp = hypothesis_batch(seed, eng.ransac_hypothesis_batch, counts, caps)
    refit, c0_refit = refit_batch(seed, eng.pose_covariance_mc_iterations + 1, counts, caps,
                                  optimizer._REFIT_CAPS)
    return {"hypotheses": (hyp, c0_hyp, eng.lm_iterations),
            "refit_mc": (refit, c0_refit, eng.refit_lm_iterations)}


#: the cases of :func:`cases`
CASE_NAMES = ("hypotheses", "refit", "unbatched_features", "single_pose", "weights",
              "batched_weights", "edges", "planes_and_lines_empty")


@functools.lru_cache(maxsize=None)
def cases():
    """(features, coeffs0, weights, iterations) of each case, by name: the
    hypothesis and refit batches, unbatched features against 5 poses, a single
    pose, ``weights=`` unbatched and batched, the edge scene against 4 poses,
    and empty plane and line blocks."""
    feats, _, c0 = scene(3)
    rng = np.random.default_rng(7)
    batch = (c0 + torch.as_tensor(rng.normal(0, [5, 5, 5, 0.005, 0.005, 0.005], (5, 6)),
                                  dtype=torch.float32)).contiguous()
    weights = torch.as_tensor(rng.uniform(-0.5, 1.0, sum(feats.capacities)),
                              dtype=torch.float32)
    empty, _, c0_empty = scene(4, counts=(20, 6, 0, 0), caps=(24, 8, 0, 0))
    edge, _, c0_edge = edge_scene(5)
    hyp, c0_hyp = hypothesis_batch(1)
    refit, c0_refit = refit_batch(2)
    found = {
        "hypotheses": (hyp, c0_hyp, None, 10),
        "refit": (refit, c0_refit, None, 6),
        "unbatched_features": (feats, batch, None, 8),
        "single_pose": (feats, c0, None, 8),
        "weights": (feats, c0, weights, 5),
        "batched_weights": (feats, batch, weights.expand(5, -1).flip(-1).contiguous(), 5),
        "edges": (edge, c0_edge.expand(4, 6).contiguous(), None, 8),
        "planes_and_lines_empty": (empty, c0_empty, None, 8),
    }
    assert tuple(found) == CASE_NAMES
    return found


#: the cases of :func:`kernel_edge_cases`
KERNEL_EDGE_NAMES = ("features_356", "features_45", "no_live_member_one_warp",
                     "no_live_member", "iterations_0", "iterations_64")


@functools.lru_cache(maxsize=None)
def kernel_edge_cases():
    """The LM kernel's edges, as :func:`cases` gives them: 356 feature slots
    (past 256, not a multiple of 32; 334 live, so each of 128 threads takes two
    or three) and 45 (two warps) over a few poses; the hypotheses (one warp) and a scene (two
    warps) with one member whose weights leave no live feature, the shared
    feature blocks read beside per-member masks; the hypotheses with 0
    iterations and with 64 (past the 63 accept bits)."""
    rng = np.random.default_rng(12)

    def starts(c0, n):
        return (c0 + torch.as_tensor(rng.normal(0, [5, 5, 5, 0.005, 0.005, 0.005], (n, 6)),
                                     dtype=torch.float32)).contiguous()

    big, _, c0_big = scene(6, counts=(280, 40, 6, 8), caps=(300, 40, 7, 9))
    mid, _, c0_mid = scene(7, counts=(20, 6, 3, 5), caps=(24, 8, 4, 9))
    hyp, c0_hyp = hypothesis_batch(8)
    feats, _, c0 = scene(3)
    hyp_weights = torch.ones(hyp.point_mask.shape[0], sum(hyp.capacities))
    hyp_weights[3] = -1.0
    weights = torch.as_tensor(rng.uniform(-0.5, 1.0, (4, sum(feats.capacities))),
                              dtype=torch.float32)
    weights[1] = -1.0
    found = {
        "features_356": (big, starts(c0_big, 3), None, 6),
        "features_45": (mid, starts(c0_mid, 5), None, 8),
        "no_live_member_one_warp": (hyp, c0_hyp, hyp_weights, 10),
        "no_live_member": (feats, starts(c0, 4), weights, 8),
        "iterations_0": (hyp, c0_hyp, None, 0),
        "iterations_64": (hyp, c0_hyp, None, 64),
    }
    assert tuple(found) == KERNEL_EDGE_NAMES
    return found


def case(name):
    """A case of :func:`cases` or of :func:`kernel_edge_cases`, by name."""
    return (kernel_edge_cases() if name in KERNEL_EDGE_NAMES else cases())[name]
