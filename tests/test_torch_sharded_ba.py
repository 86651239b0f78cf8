"""The sharded bundle adjustment over ``torch.distributed``: ``gloo`` processes on
the CPU (``torch.multiprocessing.spawn``, one thread each) against the port's
single-device ``ba_solve`` and the JAX package's.

Two groups of processes are started once per module, 4 ranks for the solves and 2
for the keyframe window and the runner; the tests read what they wrote.  Sums over
ranks run in another order than the single-device sums, so the sharded solve is
held to costs rtol 2e-3 and poses atol 2e-2 (the JAX package's own bounds for its
sharded solve); a second sharded run must repeat the first to the bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_sharded_helpers as helpers
from rgbd_slam_tpu.parallel import ba as j_ba
from rgbd_slam_tpu_torch import dryrun, runner
from rgbd_slam_tpu_torch.geometry import pinhole, se3
from rgbd_slam_tpu_torch.parallel import ba
from test_ba import CAM as J_CAM
from test_ba import make_window, perturb

COST_RTOL, POSE_ATOL = 2e-3, 2e-2
#: seconds a group of spawned ranks may take before it is killed
SPAWN_LIMIT_S = 120.0


def _problem(seed, k, l, c):
    """A perturbed window of ``tests/test_ba.py``'s family, with measured depths
    (30% missing), as numpy arrays."""
    rng = np.random.default_rng(seed)
    gt_poses, gt_lm, obs_kf, uv, mask = make_window(rng, noise_px=0.3, K=k, L=l, C=c)
    poses0, lm0 = perturb(rng, gt_poses, gt_lm, pose_mm=20.0, lm_mm=30.0)
    quat, pos = se3.coefficients_to_pose(torch.tensor(np.asarray(gt_poses)))
    w2c = se3.world_to_camera(quat, pos)[torch.tensor(np.asarray(obs_kf)).long()]
    scr, _ = pinhole.world_to_screen(
        torch.tensor(np.asarray(gt_lm))[:, None, :].expand(l, c, 3), w2c, helpers.BA_CAM)
    z = scr[..., 2].numpy().astype(np.float32)
    z[rng.uniform(size=z.shape) < 0.3] = 0.0
    return dict(poses=np.asarray(poses0), lm=np.asarray(lm0), obs_kf=np.asarray(obs_kf),
                uv=np.asarray(uv), mask=np.asarray(mask), z=z)


@pytest.fixture(scope="module")
def problems():
    # the window of tests/test_multiprocess.py (K = 4, L = 64, C = 4) and a K = 8
    # window, whose 48 reduced rows go over 4 ranks
    return {"mp": _problem(7, 4, 64, 4), "k8": _problem(1000, 8, 128, 4)}


@pytest.fixture(scope="module")
def four_ranks(problems, tmp_path_factory):
    work = tmp_path_factory.mktemp("four_ranks")
    flat = {f"{name}_{k}": v for name, p in problems.items() for k, v in p.items()}
    np.savez(work / "problems.npz", **flat)
    out = str(work / "results.npz")
    dryrun.run_ranks(helpers.solve_cases_rank, 4, args=(str(work / "problems.npz"), out),
                     timeout=SPAWN_LIMIT_S)
    with np.load(out) as data:
        return {k: data[k] for k in data.files}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("two_ranks")
    out = str(work / "results")
    dryrun.run_ranks(helpers.window_cases_rank, 2, args=(out,), timeout=SPAWN_LIMIT_S)
    results = []
    for rank in range(2):
        with np.load(f"{out}.rank{rank}.npz") as data:
            results.append({k: data[k] for k in data.files})
    return results


def _single(module, to, p, anchored, with_depth, cam):
    kw = dict(iterations=helpers.ITERATIONS, anchored=anchored)
    if with_depth:
        kw["obs_z"] = to(p["z"])
    out = module.ba_solve(to(p["poses"]), to(p["lm"]), to(p["obs_kf"]), to(p["uv"]),
                          to(p["mask"]), cam, **kw)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("case, name, solver, anchored, with_depth", helpers.SOLVE_CASES,
                         ids=[c[0] for c in helpers.SOLVE_CASES])
@pytest.mark.parametrize("reference", ["port", "jax"])
def test_sharded_solve_matches_single_device(four_ranks, problems, reference, case, name,
                                             solver, anchored, with_depth):
    p = problems[name]
    if reference == "port":
        ref = _single(ba, torch.from_numpy, p, anchored, with_depth, helpers.BA_CAM)
    else:
        ref = _single(j_ba, jnp.asarray, p, anchored, with_depth, J_CAM)
    poses, lm, costs = (four_ranks[f"{case}_{x}"] for x in ("poses", "lm", "costs"))
    assert np.isfinite(poses).all() and (costs > 0).all()
    assert costs[-1] < 0.05 * costs[0]          # the solve did its work
    np.testing.assert_allclose(costs, ref[2], rtol=COST_RTOL)
    np.testing.assert_allclose(poses, ref[0], atol=POSE_ATOL)
    # landmarks in mm: the pose tolerance scaled by the scene's depth over the focal
    # length would be ~0.15 mm; 0.5 mm holds with room for pcg's truncated solve
    np.testing.assert_allclose(lm, ref[1], atol=0.5)


@pytest.mark.parametrize("case", [c[0] for c in helpers.SOLVE_CASES])
def test_sharded_solve_repeats_to_the_bit(four_ranks, case):
    assert bool(four_ranks[f"{case}_repeat_equal"])


def test_pcg_needs_rows_divisible_by_ranks(four_ranks):
    assert four_ranks["pcg_refused_on_ranks"][0] == 4.0      # 6 * 3 rows over 4 ranks


def test_collective_helpers(four_ranks):
    """``all_gather_rows`` in rank order; ``reduce_scatter_rows`` the sum of the
    ranks' buffers, (1 + 2 + 3 + 4) x the base, a block of rows a rank."""
    want = np.concatenate([np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r
                           for r in range(4)])
    np.testing.assert_array_equal(four_ranks["gathered"], want)
    base = np.arange(16, dtype=np.float32).reshape(-1, 2)
    np.testing.assert_array_equal(four_ranks["scattered"], 10.0 * base)


def test_init_distributed_is_a_no_op_for_one_process(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert ba.init_distributed() is False
    assert ba.init_distributed("tcp://localhost:1", world_size=1, rank=0) is False
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    assert ba.init_distributed() is False                    # an address, one process
    assert not torch.distributed.is_initialized()


def test_sharded_refine_matches_single_device(two_ranks):
    records = helpers.keyframe_records()
    refined, device_lm, costs = helpers.make_window(records).refine(helpers.BA_CAM,
                                                                    iterations=4)
    got = two_ranks[0]
    assert costs[-1] < costs[0]
    np.testing.assert_allclose(got["good_costs"], costs, rtol=COST_RTOL)
    np.testing.assert_allclose(got["good_positions"], np.stack([p for _, p in refined]),
                               atol=POSE_ATOL)
    np.testing.assert_allclose(got["good_quats"], np.stack([q for q, _ in refined]),
                               atol=1e-4)
    np.testing.assert_allclose(got["good_lm"], device_lm[2].numpy(), atol=0.5)


def test_nan_window_is_refused_on_every_rank_without_a_hang(two_ranks):
    """A NaN pose gives a NaN cost, the same on both ranks, so the runner's
    finite-cost test refuses the window; the refine after it finds the ranks in
    step (it repeats the first one to the bit), and rank 1 served all three."""
    got = two_ranks[0]
    assert np.isnan(got["nan_costs"]).all()
    assert not (np.isfinite(got["nan_costs"]).all() and got["nan_costs"][-1]
                < got["nan_costs"][0])
    for key in ("costs", "positions", "quats", "lm"):
        np.testing.assert_array_equal(got[f"good_again_{key}"], got[f"good_{key}"])
    assert int(two_ranks[1]["served"]) == 3


def test_sharded_runner_matches_single_device(two_ranks):
    frames = helpers.short_frames(helpers.RUN_FRAMES)
    _, traj, stats = runner.run_frames(
        frames, helpers.SMALL_CAM, helpers.SMALL_CFG, with_planes=False,
        ba_every=helpers.RUN_BA_EVERY, ba_iterations=4, kf_min_trans_mm=helpers.RUN_KF_MM,
        device="cpu")
    got = two_ranks[0]
    assert stats.ba_runs >= 1
    np.testing.assert_array_equal(got["run_counts"], [stats.keyframe_count, stats.ba_runs,
                                                      stats.ba_accepted, stats.frame_count])
    assert int(two_ranks[1]["run_served"]) == stats.ba_runs
    # the refined poses and landmarks agree to the solve's tolerance, and what
    # the front end makes of them stays within a few hundredths of a millimetre
    np.testing.assert_allclose(got["run_positions"], traj.positions_array(), atol=0.1)


def test_serve_refines_ends_when_the_runner_raises(two_ranks):
    assert str(two_ranks[0]["raise_outcome"]) == "raised"
    assert str(two_ranks[1]["raise_outcome"]) == "returned"


def test_dryrun_multichip_on_the_cpu(capsys):
    report = dryrun.dryrun_multichip(2, device="cpu", timeout=SPAWN_LIMIT_S)
    assert report["ranks"] == 2 and report["backend"] == "gloo"
    assert "2 ranks, gloo on cpu" in capsys.readouterr().out
    for solver in ("dense", "pcg"):
        assert np.all(np.diff(report[f"{solver}_costs"]) < 0)


def test_dryrun_problem_is_the_jax_package_s():
    """``dryrun.make_ba_problem`` against ``__graft_entry__._make_ba_problem`` on
    the same seed: equal but for the projection's last float32 bit."""
    import __graft_entry__ as entry

    theirs = entry._make_ba_problem(32, k=4, c=3, seed=3)
    ours = dryrun.make_ba_problem(32, k=4, c=3, seed=3)
    for a, b in zip(theirs, ours):
        np.testing.assert_allclose(np.asarray(a).astype(np.float64), b, atol=1e-4, rtol=0)


def test_run_ranks_kills_what_outlives_its_limit():
    with pytest.raises(TimeoutError):
        dryrun.run_ranks(helpers.sleeping_rank, 2, timeout=3.0)
