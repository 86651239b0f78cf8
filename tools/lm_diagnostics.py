"""Diagnostics of the LM kernel (``csrc/lm.cu``) on the card.

``python tools/lm_diagnostics.py ate [--paths forward_only planes] [--seeds 0 1 2]``
runs ``chip_smoke.py``'s forward-only and plane paths with the LM kernel (the
runner's CUDA graph, as ``chip_smoke.py`` runs them; ``--runs kernel_eager``
adds the step eager) and with the plain LM (``lm_cuda.lm_solve`` replaced by
``lm_solve_reference``, the step eager), for each seed of the engine's draws,
and prints one JSON line a run: the ATE, the failed and lost frames, the
seconds.  It shows whether the kernel moves a path's ATE further than the seed
does.

``python tools/lm_diagnostics.py launch`` launches the kernel once at each of
the main path's two shapes (the 32 hypotheses, the refit + 100 Monte-Carlo
members, from ``tests/torch_lm_cases.py``) and checks the result finite: a
short program to run under ``compute-sanitizer``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from rgbd_slam_tpu_torch import config, runner, step_graph  # noqa: E402
from rgbd_slam_tpu_torch.ops import lm_cuda  # noqa: E402


def _patched(lm: str):
    """Set up a run: ``kernel`` as the runner runs it (a CUDA graph),
    ``kernel_eager`` the step eager, ``plain`` the step eager with
    ``lm_cuda.lm_solve`` replaced by ``lm_solve_reference``.  Returns the
    undo."""
    solve, stepper = lm_cuda.lm_solve, step_graph.stepper

    def plain(inputs, coeffs0, iterations, damping0, details=False):
        return lm_cuda.lm_solve_reference(inputs, coeffs0, iterations, damping0, details)

    def eager(state, cam, cfg, with_planes=True, with_lines=False):
        return step_graph.EagerStep(state, cam, cfg, with_planes=with_planes,
                                    with_lines=with_lines)

    if lm != "kernel":
        step_graph.stepper = eager
    if lm == "plain":
        lm_cuda.lm_solve = plain

    def undo():
        lm_cuda.lm_solve, step_graph.stepper = solve, stepper
    return undo


def run_ate(paths, seeds, runs):
    import chip_smoke

    cam, cfg = config.TUM_FR1, config.SlamConfig()
    cfg_fwd = dataclasses.replace(cfg, mapping=dataclasses.replace(
        cfg.mapping, max_tracked_points=chip_smoke.FORWARD_ONLY_TRACKED))
    frames, gt = chip_smoke.room_frames(cam, chip_smoke.JAX_REFERENCE["planes"]["frames"])
    device = torch.device("cuda", 0)
    for path in paths:
        n = chip_smoke.JAX_REFERENCE[path]["frames"]
        path_cfg = cfg_fwd if path == "forward_only" else cfg
        for seed in seeds:
            for lm in runs:
                undo = _patched(lm)
                try:
                    t0 = time.perf_counter()
                    _, traj, stats = runner.run_frames(frames[:n], cam, path_cfg, seed=seed,
                                                       device=device)
                    torch.cuda.synchronize()
                    seconds = time.perf_counter() - t0
                finally:
                    undo()
                ate = runner.evaluate_against_ground_truth(traj, gt[:n])["ate_rmse_mm"]
                print(json.dumps(dict(
                    path=path, seed=seed, lm=lm, frames=n, ate_rmse_mm=ate,
                    failed=stats.frame_count - stats.success_count, lost=stats.lost_count,
                    seconds=seconds)), flush=True)


def run_launch():
    import torch_lm_cases
    from rgbd_slam_tpu_torch.pose.residuals import prepare_features

    device = torch.device("cuda", 0)
    cam = torch_lm_cases.CAM
    for name, (feats, c0, iterations) in torch_lm_cases.main_path_batches(11).items():
        feats = type(feats)(*(t.to(device) for t in feats))
        inputs = lm_cuda.pack(prepare_features(feats, cam), cam)
        got = lm_cuda.lm_solve(inputs, c0.to(device), iterations, 1e-3, details=True)
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(got.coeffs).all() and torch.isfinite(got.cost).all())
        print(json.dumps(dict(shape=name, batch=c0.shape[0], iterations=iterations,
                              finite=finite)), flush=True)
        if not finite:
            raise SystemExit(1)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="what", required=True)
    ate = sub.add_parser("ate", help="ATE with the kernel and with the plain LM, by seed")
    ate.add_argument("--paths", nargs="+", default=["forward_only", "planes"],
                     choices=["forward_only", "planes"])
    ate.add_argument("--seeds", nargs="+", type=int, default=[0, 1, 2])
    ate.add_argument("--runs", nargs="+", default=["kernel", "plain"],
                     choices=["kernel", "kernel_eager", "plain"])
    sub.add_parser("launch", help="one kernel launch at each main-path shape")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("lm_diagnostics: no CUDA device", file=sys.stderr)
        return 1
    if args.what == "ate":
        run_ate(args.paths, args.seeds, args.runs)
    else:
        run_launch()
    return 0


if __name__ == "__main__":
    sys.exit(main())
