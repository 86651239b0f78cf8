"""Dry run of the sharded bundle adjustment over several processes (the port's
counterpart of the JAX package's ``dryrun_multichip``).

    python -m rgbd_slam_tpu_torch.dryrun [-n RANKS] [--device cpu] [--scaling]

``dryrun_multichip(n)`` starts ``n`` processes joined by ``gloo``, each of which
builds the same perturbed, noisy window from a numpy seed, solves its shard of
the landmarks with ``parallel.ba.make_sharded_ba`` (``dense`` and ``pcg``), and
holds the result to the single-device ``ba_solve`` of the whole problem.  On a
machine with one card all ranks share it, which ``gloo`` allows and NCCL does
not; ``nccl_single_rank`` launches the NCCL collectives themselves, with one
rank.  ``scaling(n)`` times the sharded solve over 1, 2, 4, ... ranks on a window
of realistic size and prints the table; it asserts nothing.
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .config import CameraIntrinsics
from .device import resolve_device
from .geometry import pinhole, se3
from .parallel import ba

CAM = CameraIntrinsics(width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0)
#: what the sharded solve is held to against the single-device one: sums over
#: ranks run in another order
COST_RTOL = 2e-3
POSE_ATOL = 2e-2


def make_ba_problem(l: int, k: int = 4, c: int = 3, seed: int = 0, cam=CAM):
    """A perturbed, noisy windowed-BA problem as numpy arrays: keyframes on a
    track with rotation, landmarks on a slab, pixel observations projected from
    the true poses with 0.3 px of noise, then poses (all but the gauge anchor)
    and landmarks perturbed away from the optimum, so that the residuals are
    not zero and the solver has to bring them down.  Returns (poses [K, 6],
    landmarks [L, 3], obs_kf [L, C], obs_uv [L, C, 2], obs_mask [L, C])."""
    rng = np.random.default_rng(seed)
    idx = torch.arange(k, dtype=torch.float32)
    half = 0.005 * idx                       # 0.01 rad more about z per keyframe
    zero = torch.zeros_like(half)
    quats = torch.stack([torch.cos(half), zero, zero, torch.sin(half)], dim=1)
    positions = torch.stack([15.0 * idx, 25.0 * idx, 4.0 * idx], dim=1)
    gt_poses = se3.pose_to_coefficients(quats, positions).numpy()

    landmarks = np.concatenate(
        [rng.uniform(2000, 3000, (l, 1)), rng.uniform(-500, 500, (l, 2))],
        axis=1).astype(np.float32)
    obs_kf = rng.integers(0, k, (l, c)).astype(np.int32)
    w2c = se3.world_to_camera(quats, positions)[torch.from_numpy(obs_kf).long()]  # [L, C, 4, 4]
    lm = torch.from_numpy(landmarks)[:, None, :].expand(l, c, 3)
    scr, ok = pinhole.world_to_screen(lm, w2c, cam)
    uv = scr[..., :2].numpy() + rng.normal(0, 0.3, (l, c, 2)).astype(np.float32)

    dp = rng.normal(0, 1, gt_poses.shape).astype(np.float32)
    dp[:, :3] *= 20.0
    dp[:, 3:] *= 0.005
    dp[0] = 0.0
    dl = rng.normal(0, 30.0, landmarks.shape).astype(np.float32)
    return gt_poses + dp, landmarks + dl, obs_kf, uv.astype(np.float32), ok.numpy()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(fn, nprocs: int, args=(), timeout: float = 300.0):
    """Start ``fn(rank, nprocs, init_method, *args)`` in ``nprocs`` processes
    (``spawn``) and wait for all of them; a rank that raises, or ``timeout``
    seconds gone, ends them all and raises here.  ``fn`` must be a module-level
    function of an importable module; it joins the group itself
    (:func:`join_group`)."""
    init_method = f"tcp://localhost:{free_port()}"
    context = mp.spawn(fn, args=(nprocs, init_method, *args), nprocs=nprocs, join=False)
    deadline = time.monotonic() + timeout
    try:
        while not context.join(timeout=1.0):     # raises when a rank has failed
            if time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks of {fn.__name__} did not end within "
                                   f"{timeout:.0f} s")
    finally:
        for process in context.processes:
            if process.is_alive():
                process.kill()
            process.join(10)


def join_group(rank: int, world_size: int, init_method: str, backend: str = "gloo"):
    """A rank's first call: one thread for its CPU work (the ranks share the
    host's cores), then the process group."""
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)


def shard_of(arrays, rank: int, world_size: int, device):
    """This rank's block of rows of each array, as tensors on ``device``."""
    n = arrays[0].shape[0]
    mine = slice(rank * n // world_size, (rank + 1) * n // world_size)
    return [torch.from_numpy(np.ascontiguousarray(a[mine])).to(device) for a in arrays]


def _timed(device, fn):
    """(result, seconds) of ``fn()``, the card's queue drained around it."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def _check_against_single(name, got, ref):
    poses, costs = got[0].cpu().numpy(), got[2].cpu().numpy()
    ref_poses, ref_costs = ref[0].cpu().numpy(), ref[2].cpu().numpy()
    assert np.isfinite(poses).all(), f"{name}: a pose is not finite"
    assert (costs > 0).all() and (np.diff(costs) < 0).all(), \
        f"{name}: sharded BA costs must be positive and strictly falling, got {costs}"
    np.testing.assert_allclose(costs, ref_costs, rtol=COST_RTOL,
                               err_msg=f"{name}: sharded != single-device costs")
    np.testing.assert_allclose(poses, ref_poses, atol=POSE_ATOL,
                               err_msg=f"{name}: sharded != single-device poses")


def _dryrun_rank(rank, world_size, init_method, device, backend, out_dir):
    device = resolve_device(device)
    join_group(rank, world_size, init_method, backend)
    try:
        k, iterations = 4, 4
        problem = make_ba_problem(16 * world_size, k=k, c=3)
        poses = torch.from_numpy(problem[0]).to(device)
        whole = [torch.from_numpy(a).to(device) for a in problem[1:]]
        ba.ba_solve(poses, *whole, CAM, iterations=1)           # warm-up
        ref, ref_s = _timed(device, lambda: ba.ba_solve(poses, *whole, CAM,
                                                        iterations=iterations))
        ref_costs = ref[2].cpu().numpy()
        assert (ref_costs > 0).all() and (np.diff(ref_costs) < 0).all(), \
            f"BA costs must be positive and strictly falling, got {ref_costs}"
        shard = shard_of(problem[1:], rank, world_size, device)
        report = {"ranks": world_size, "backend": backend, "device": str(device),
                  "single_device_ms": 1e3 * ref_s}
        for solver in ("dense", "pcg"):
            fn = ba.make_sharded_ba(dist.group.WORLD, CAM, n_keyframes=k,
                                    iterations=iterations, reduced_solver=solver)
            fn(poses, *shard)                                   # warm-up
            got, seconds = _timed(device, lambda: fn(poses, *shard))
            again = fn(poses, *shard)
            _check_against_single(solver, got, ref)
            assert all(torch.equal(a, b) for a, b in zip(got, again)), \
                f"{solver}: two sharded runs differ"
            report[f"{solver}_ms"] = 1e3 * seconds
            report[f"{solver}_costs"] = [float(x) for x in got[2].cpu()]
        if rank == 0:
            np.save(os.path.join(out_dir, "report.npy"), report, allow_pickle=True)
    finally:
        dist.destroy_process_group()


def _run_and_report(n, device, backend, timeout):
    with tempfile.TemporaryDirectory() as out_dir:
        run_ranks(_dryrun_rank, n, args=(device, backend, out_dir), timeout=timeout)
        report = np.load(os.path.join(out_dir, "report.npy"), allow_pickle=True).item()
    print(f"dryrun_multichip: {report['ranks']} ranks, {report['backend']} on "
          f"{report['device']}: dense costs {report['dense_costs']}, pcg costs "
          f"{report['pcg_costs']} (== single-device, rtol {COST_RTOL}, poses atol "
          f"{POSE_ATOL}; repeats bit-equal); a solve: single-device "
          f"{report['single_device_ms']:.1f} ms, dense {report['dense_ms']:.1f} ms, pcg "
          f"{report['pcg_ms']:.1f} ms", flush=True)
    return report


def dryrun_multichip(n: int, device=None, timeout: float = 300.0) -> dict:
    """Run the sharded BA over ``n`` ``gloo`` processes on ``device`` (``None``:
    the card, which all ranks then share) on a perturbed, noisy window of
    ``16 n`` landmarks, and assert: costs positive and strictly falling, the
    sharded solve equal to the single-device one (costs rtol 2e-3, poses atol
    2e-2) for ``dense`` and for ``pcg``, and a second sharded run equal to the
    first to the bit.  Prints, and returns, the costs and the time of a solve
    beside the single-device time.  Ranks that share a card, or a host's
    cores, take turns: their times show what the collectives cost, not what
    sharding gains."""
    resolve_device(device)          # fail here, not in n children, without a card
    return _run_and_report(n, device, "gloo", timeout)


def nccl_single_rank(timeout: float = 300.0) -> dict:
    """The same checks with one rank under NCCL on the card: the solve's
    ``all_reduce``, ``reduce_scatter_tensor`` and ``all_gather_into_tensor``
    are NCCL launches, though over a group of one."""
    return _run_and_report(1, "cuda", "nccl", timeout)


def _scaling_rank(rank, world_size, init_method, device, out_dir, l, k, c, iterations):
    device = resolve_device(device)
    join_group(rank, world_size, init_method)
    try:
        problem = make_ba_problem(l, k=k, c=c, seed=1)
        poses = torch.from_numpy(problem[0]).to(device)
        shard = shard_of(problem[1:], rank, world_size, device)
        fn = ba.make_sharded_ba(dist.group.WORLD, CAM, n_keyframes=k, iterations=iterations)
        fn(poses, *shard)
        best = min(_timed(device, lambda: fn(poses, *shard))[1] for _ in range(3))
        if rank == 0:
            np.save(os.path.join(out_dir, "best.npy"), best)
    finally:
        dist.destroy_process_group()


def scaling(n: int, device=None, l: int = 16384, k: int = 16, c: int = 8,
            iterations: int = 4, timeout: float = 600.0) -> dict:
    """Strong-scaling sweep: the fixed window of ``l`` landmarks, ``k``
    keyframes and ``c`` observations each, solved over 1, 2, 4, ..., ``n``
    ``gloo`` ranks on ``device``; prints the best of 3 solves, the speed-up and
    the efficiency per rank count, and asserts nothing.  Each rank computes
    with one thread; ranks that share one card or fewer cores than ranks take
    turns, so the table is a measure of sharding only where every rank has a
    device or a core of its own."""
    resolve_device(device)
    times = {}
    ranks = 1
    while ranks <= n:
        with tempfile.TemporaryDirectory() as out_dir:
            run_ranks(_scaling_rank, ranks, args=(device, out_dir, l, k, c, iterations),
                      timeout=timeout)
            times[ranks] = float(np.load(os.path.join(out_dir, "best.npy")))
        ranks *= 2
    print(f"ba_scaling_note: problem L={l} K={k} C={c}, {iterations} iterations, gloo on "
          f"{resolve_device(device)}, {os.cpu_count()} host cores", flush=True)
    for ranks, t in times.items():
        print(f"ba_scaling: ranks={ranks} time_s={t:.4f} speedup={times[1] / t:.2f} "
              f"efficiency={times[1] / (t * ranks):.2f}", flush=True)
    return times


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-n", "--ranks", type=int, default=4)
    ap.add_argument("--device", default=None, help="default: the card; 'cpu' to run without")
    ap.add_argument("--scaling", action="store_true", help="also print the scaling sweep")
    args = ap.parse_args()
    dryrun_multichip(args.ranks, device=args.device)
    if args.scaling:
        scaling(args.ranks, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
