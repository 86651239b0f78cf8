"""Rank functions of ``test_torch_sharded_ba.py``: what each spawned process
runs.  They import torch and the port only (a spawned rank imports this module
anew), read their problems from an ``.npz`` the test wrote and write their
results to another."""

import numpy as np
import torch
import torch.distributed as dist

from rgbd_slam_tpu_torch import dryrun, runner
from rgbd_slam_tpu_torch.config import (CameraIntrinsics, EngineConfig, MappingConfig,
                                        SlamConfig)
from rgbd_slam_tpu_torch.parallel import ba
from rgbd_slam_tpu_torch.parallel.keyframes import KeyframeWindow, serve_refines, stop_serving
from rgbd_slam_tpu_torch.synthetic import WallScene, lateral_trajectory

BA_CAM = CameraIntrinsics(width=640, height=480, fx=520.0, fy=520.0, cx=320.0, cy=240.0)
SMALL_CAM = CameraIntrinsics(width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0)
SMALL_CFG = SlamConfig(
    mapping=MappingConfig(max_points_3d=128, max_points_2d=32, max_planes=8,
                          max_tracked_points=64),
    engine=EngineConfig(pose_covariance_mc_iterations=8, lm_iterations=8,
                        ransac_hypothesis_batch=16))
#: (case, problem in the npz, reduced solver, anchored, with the depth row)
SOLVE_CASES = [("mp_dense", "mp", "dense", False, False),
               ("mp_pcg", "mp", "pcg", False, False),
               ("mp_anchored_depth_dense", "mp", "dense", True, True),
               ("mp_anchored_depth_pcg", "mp", "pcg", True, True),
               ("k8_pcg", "k8", "pcg", False, False),
               ("k8_dense", "k8", "dense", False, False)]
ITERATIONS = 6


def solve_cases_rank(rank, world_size, init_method, problems_path, out_path):
    """Every case of ``SOLVE_CASES`` over the group, each twice; rank 0 writes
    poses, gathered landmarks, costs and whether the second run gave the same
    bits; every rank writes whether ``pcg`` refused 6K = 18 rows over 4 ranks."""
    dryrun.join_group(rank, world_size, init_method)
    try:
        group = dist.group.WORLD
        results = {}
        with np.load(problems_path) as data:
            problems = {k: data[k] for k in data.files}
        for case, name, solver, anchored, with_depth in SOLVE_CASES:
            poses = torch.from_numpy(problems[f"{name}_poses"])
            fields = ["lm", "obs_kf", "uv", "mask"] + (["z"] if with_depth else [])
            shard = dryrun.shard_of([problems[f"{name}_{f}"] for f in fields], rank,
                                    world_size, "cpu")
            fn = ba.make_sharded_ba(group, BA_CAM, n_keyframes=poses.shape[0],
                                    iterations=ITERATIONS, anchored=anchored,
                                    reduced_solver=solver, with_depth=with_depth)
            first = fn(poses, *shard)
            second = fn(poses, *shard)
            results[f"{case}_poses"] = first[0].numpy()
            results[f"{case}_lm"] = ba.all_gather_rows(first[1], group).numpy()
            results[f"{case}_costs"] = first[2].numpy()
            results[f"{case}_repeat_equal"] = np.array(
                all(torch.equal(a, b) for a, b in zip(first, second)))
        try:
            ba.make_sharded_ba(group, BA_CAM, n_keyframes=3, reduced_solver="pcg")
            refused = False
        except AssertionError as e:
            refused = "divisible" in str(e)
        flags = torch.tensor([float(refused)])
        dist.all_reduce(flags, group=group)
        results["pcg_refused_on_ranks"] = flags.numpy()
        # the two collectives the solve builds on, against what they must give
        local = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
        results["gathered"] = ba.all_gather_rows(local, group).numpy()
        full = torch.arange(4 * world_size, dtype=torch.float32).reshape(-1, 2) * (rank + 1)
        mine = ba.reduce_scatter_rows(full, group)
        results["scattered"] = ba.all_gather_rows(mine, group).numpy()
        if rank == 0:
            np.savez(out_path, **results)
    finally:
        dist.destroy_process_group()


def keyframe_records(n_keyframes=6, n_slots=48, seed=5, cam=BA_CAM):
    """Seeded keyframes on a lateral run over landmarks on a slab, as the
    runner's packed observation records: per keyframe (quat, position, fobs
    [n_slots, 7], fids [n_slots])."""
    rng = np.random.default_rng(seed)
    lm = np.concatenate([rng.uniform(2500, 3500, (n_slots, 1)),
                         rng.uniform(-600, 600, (n_slots, 2))], axis=1).astype(np.float32)
    from rgbd_slam_tpu_torch.geometry import pinhole, se3
    out = []
    for i in range(n_keyframes):
        quat = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
        pos = np.array([0.0, 25.0 * i, 3.0 * i], np.float32)
        w2c = se3.world_to_camera(torch.from_numpy(quat), torch.from_numpy(pos))
        scr, ok = pinhole.world_to_screen(torch.from_numpy(lm), w2c, cam)
        scr, ok = scr.numpy(), ok.numpy()
        uv = scr[:, :2] + rng.normal(0, 0.3, (n_slots, 2)).astype(np.float32)
        matched = ok & (rng.uniform(size=n_slots) < 0.9)
        map_pos = lm + rng.normal(0, 15.0, lm.shape).astype(np.float32)
        fobs = np.concatenate([matched[:, None].astype(np.float32), uv, scr[:, 2:3],
                               map_pos], axis=1).astype(np.float32)
        noisy_pos = pos + (rng.normal(0, 8.0, 3).astype(np.float32) if i else 0.0)
        out.append((quat, noisy_pos.astype(np.float32), fobs,
                    np.arange(n_slots, dtype=np.int32)))
    return out


def make_window(records, nan_pose=False, max_landmarks=64):
    window = KeyframeWindow(max_keyframes=8, max_landmarks=max_landmarks, device="cpu")
    for i, (quat, pos, fobs, fids) in enumerate(records):
        window.add_keyframe_packed(quat, pos, fobs, fids, timestamp=float(i), frame_id=i)
    if nan_pose:
        window.poses[2] = np.full(6, np.nan, np.float32)
    return window


def short_frames(n):
    scene = WallScene(SMALL_CAM)
    return [scene.render(q, p) for q, p in lateral_trajectory(n)]


#: the sharded runner test: frames, BA period and a keyframe gate loose enough
#: for refines to happen within them
RUN_FRAMES, RUN_BA_EVERY, RUN_KF_MM = 10, 3, 4.0


class _Stop(Exception):
    pass


def window_cases_rank(rank, world_size, init_method, out_path):
    """Rank 0 refines a window, then one with a NaN pose, then the first
    again, over the group; runs a short sequence with the refines sharded; and
    at last a runner whose ``on_frame`` raises.  The other ranks serve all of
    it, each through the call a user would make."""
    dryrun.join_group(rank, world_size, init_method)
    try:
        group = dist.group.WORLD
        results = {}
        if rank == 0:
            records = keyframe_records()
            for name, nan_pose in (("good", False), ("nan", True), ("good_again", False)):
                refined, device_lm, costs = make_window(records, nan_pose).refine(
                    BA_CAM, iterations=4, mesh=group)
                results[f"{name}_quats"] = np.stack([q for q, _ in refined])
                results[f"{name}_positions"] = np.stack([p for _, p in refined])
                results[f"{name}_lm"] = device_lm[2].numpy()
                results[f"{name}_costs"] = costs
            stop_serving(group, "cpu")
        else:
            results["served"] = np.array(serve_refines(group, BA_CAM, device="cpu"))

        frames = short_frames(RUN_FRAMES) if rank == 0 else []
        _, traj, stats = runner.run_frames(
            frames, SMALL_CAM, SMALL_CFG, with_planes=False, ba_every=RUN_BA_EVERY,
            ba_iterations=4, kf_min_trans_mm=RUN_KF_MM, ba_mesh=group, device="cpu")
        if rank == 0:
            results["run_positions"] = traj.positions_array()
            results["run_counts"] = np.array([stats.keyframe_count, stats.ba_runs,
                                              stats.ba_accepted, stats.frame_count])
        else:
            results["run_served"] = np.array(stats.ba_runs)

        def on_frame(i, state, out, dt):
            raise _Stop(f"frame {i}")

        try:
            _, _, stats = runner.run_frames(
                short_frames(1) if rank == 0 else [], SMALL_CAM, SMALL_CFG,
                with_planes=False, ba_every=RUN_BA_EVERY, ba_mesh=group, device="cpu",
                on_frame=on_frame)
            results["raise_outcome"] = np.array("returned")
        except _Stop:
            results["raise_outcome"] = np.array("raised")
        np.savez(f"{out_path}.rank{rank}.npz", **results)
    finally:
        dist.destroy_process_group()


def sleeping_rank(rank, world_size, init_method):
    """A rank that never ends by itself."""
    import time

    time.sleep(600)
