"""Diagnostics of the LM kernel (``csrc/lm.cu``) on the card.

``python tools/lm_diagnostics.py ate [--paths forward_only planes] [--seeds 0 1 2]``
runs ``chip_smoke.py``'s forward-only and plane paths with the LM kernel (the
runner's CUDA graph, as ``chip_smoke.py`` runs them; ``--runs kernel_eager``
adds the step eager) and with the plain LM (``lm_cuda.lm_solve`` replaced by
``lm_solve_reference``, the step eager), for each seed of the engine's draws,
and prints one JSON line a run: the ATE, the failed and lost frames, the
seconds.  It shows whether the kernel moves a path's ATE further than the seed
does.

With ``--first-parting``, for each seed where the two ATEs part by more than
``PART_MM``, the kernel runs again eagerly and both eager runs record every LM
call (the hypotheses, then the refit + Monte-Carlo members); the tool finds
the first frame whose two positions differ by more than ``PARTING_MM`` and
prints what differs in that frame's pose optimization: the hypotheses' accept
bits, the best hypothesis (the refit's start: an LM hypothesis by index, or a
P3P one), the inlier set (the refit's masks) and the refit's accept bits.

``python tools/lm_diagnostics.py time`` times the kernel at the main path's two
shapes: on the LM calls of the plane step's second frame and on the synthetic
batches of ``tests/torch_lm_cases.py`` (``main_path_batches``): device µs a
launch replayed from a CUDA graph of 50, ms a call, the bound of
``lm_cuda.lm_work``; and ptxas' registers and spills of each LM kernel.  Run
from another tree (a copy of this file in it), it times that tree's kernel.

``python tools/lm_diagnostics.py breakdown`` times variants of ``csrc/lm.cu``,
each built from the source by the text edits of ``VARIANTS`` (into the
git-ignored build directory), on the plane step's second frame's LM calls
(recorded with the kernel as it is) and the synthetic main-path batches:
ablations that skip the features or the solve (what the rest of a
linearization costs; their results are wrong, only their times are read) and
the design's alternatives (the solve row-parallel on six lanes, each tangent
of a quotient divided, other thread counts).

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

import numpy as np
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


#: ATEs further apart than this (mm) make a seed's runs part
PART_MM = 0.5
#: positions further apart than this (mm) mark the first parting frame
PARTING_MM = 1e-3


def _recorded(lm: str, calls: list):
    """``lm_cuda.lm_solve`` replaced by the kernel (``kernel``) or the plain
    version (``plain``) run with ``details=True``, each call appended to
    ``calls`` (on the host): its start, masks, result and accept bits.
    Returns the undo."""
    solve = lm_cuda.lm_solve
    run = solve if lm == "kernel" else lm_cuda.lm_solve_reference

    def record(inputs, coeffs0, iterations, damping0, details=False):
        got = run(inputs, coeffs0, iterations, damping0, details=True)
        calls.append(dict(
            start=coeffs0.cpu(), coeffs=got.coeffs.cpu(), accepts=got.accepts.cpu(),
            masks=[m.cpu() for m in (inputs.point_mask, inputs.point2d_mask,
                                     inputs.plane_mask, inputs.line_mask)]))
        return got if details else (got.coeffs, got.cost)

    lm_cuda.lm_solve = record

    def undo():
        lm_cuda.lm_solve = solve
    return undo


def _eager_recorded(lm, frames, cam, cfg, seed, device):
    """An eager run with every LM call recorded: (trajectory, stats, the calls
    by frame: [{"hypotheses": call, "refit_mc": call}])."""
    calls = []
    undo_step = _patched("kernel_eager")
    undo_lm = _recorded(lm, calls)
    try:
        _, traj, stats = runner.run_frames(frames, cam, cfg, seed=seed, device=device)
        torch.cuda.synchronize()
    finally:
        undo_lm()
        undo_step()
    if len(calls) != 2 * len(frames):
        raise RuntimeError(f"{len(frames)} steps called lm_solve {len(calls)} times")
    return traj, stats, [dict(hypotheses=calls[i], refit_mc=calls[i + 1])
                         for i in range(0, len(calls), 2)]


def _best_hypothesis(frame):
    """The hypothesis the refit started from: its index among the LM
    hypotheses, or -1 (a P3P hypothesis)."""
    start = frame["refit_mc"]["start"][0]
    same = (frame["hypotheses"]["coeffs"] == start).all(-1).nonzero().flatten()
    return int(same[0]) if same.numel() else -1


def first_parting(kernel, plain):
    """The first frame where two recorded runs' positions part by more than
    ``PARTING_MM``, and what differs in its pose optimization: {frame,
    d_position_mm (there and the frame before), hypotheses_accepts_differ (the
    members whose accept bits differ), best_hypothesis [kernel, plain],
    best_hypothesis_accepts [kernel, plain] (each run's own best), inliers
    [kernel, plain] (live features of the refit's first member),
    inlier_set_equal, refit_accepts_differ (members), refit_member0_accepts
    [kernel, plain]}; None if the runs never part."""
    (traj_k, calls_k), (traj_p, calls_p) = kernel, plain
    d = np.abs(traj_k.positions_array() - traj_p.positions_array()).max(-1)
    far = np.nonzero(d > PARTING_MM)[0]
    if far.size == 0:
        return None
    f = int(far[0])
    fk, fp = calls_k[f], calls_p[f]
    best = [_best_hypothesis(fk), _best_hypothesis(fp)]

    def bits(call, m):
        return int(call["accepts"][m]) if m >= 0 else None

    mk, mp = ([m[0] if m.dim() > 1 else m for m in c["refit_mc"]["masks"]] for c in (fk, fp))
    return dict(
        frame=f, d_position_mm=float(d[f]),
        d_position_before_mm=float(d[f - 1]) if f > 0 else None,
        hypotheses_accepts_differ=int((fk["hypotheses"]["accepts"]
                                       != fp["hypotheses"]["accepts"]).sum()),
        best_hypothesis=best,
        best_hypothesis_accepts=[bits(fk["hypotheses"], best[0]),
                                 bits(fp["hypotheses"], best[1])],
        inliers=[int(sum(m.sum() for m in mk)), int(sum(m.sum() for m in mp))],
        inlier_set_equal=all(torch.equal(a, b) for a, b in zip(mk, mp)),
        refit_accepts_differ=int((fk["refit_mc"]["accepts"] != fp["refit_mc"]["accepts"]).sum()),
        refit_member0_accepts=[bits(fk["refit_mc"], 0), bits(fp["refit_mc"], 0)])


def run_ate(paths, seeds, runs, parting=False):
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
            ates, recorded = {}, {}
            for lm in runs:
                t0 = time.perf_counter()
                if parting and lm == "plain":
                    traj, stats, calls = _eager_recorded("plain", frames[:n], cam, path_cfg,
                                                         seed, device)
                    recorded["plain"] = (traj, calls)
                else:
                    undo = _patched(lm)
                    try:
                        _, traj, stats = runner.run_frames(frames[:n], cam, path_cfg,
                                                           seed=seed, device=device)
                        torch.cuda.synchronize()
                    finally:
                        undo()
                seconds = time.perf_counter() - t0
                ate = runner.evaluate_against_ground_truth(traj, gt[:n])["ate_rmse_mm"]
                ates[lm] = ate
                print(json.dumps(dict(
                    path=path, seed=seed, lm=lm, frames=n, ate_rmse_mm=ate,
                    failed=stats.frame_count - stats.success_count, lost=stats.lost_count,
                    seconds=seconds)), flush=True)
            if parting and abs(ates["kernel"] - ates["plain"]) > PART_MM:
                traj, _, calls = _eager_recorded("kernel", frames[:n], cam, path_cfg, seed,
                                                 device)
                eager_ate = runner.evaluate_against_ground_truth(traj, gt[:n])["ate_rmse_mm"]
                print(json.dumps(dict(
                    path=path, seed=seed, kernel_eager_ate_rmse_mm=eager_ate,
                    first_parting=first_parting((traj, calls), recorded["plain"]))),
                    flush=True)


def _synthetic_calls(device):
    """{shape: (inputs, coeffs0, iterations, damping0)}: the synthetic
    main-path batches of ``tests/torch_lm_cases.py`` on ``device``."""
    import torch_lm_cases
    from rgbd_slam_tpu_torch.pose.residuals import prepare_features

    cam, calls = torch_lm_cases.CAM, {}
    for name, (feats, c0, iterations) in torch_lm_cases.main_path_batches(11).items():
        feats = type(feats)(*(t.to(device) for t in feats))
        calls[name] = (lm_cuda.pack(prepare_features(feats, cam), cam), c0.to(device),
                       iterations, 1e-3)
    return calls


def _timed_calls(device):
    """{source: {shape: call}}: the LM calls of the plane step's second frame
    (recorded with the kernel as it is) and the synthetic batches."""
    import chip_smoke

    cam, cfg = config.TUM_FR1, config.SlamConfig()
    frames, _ = chip_smoke.room_frames(cam, 2)
    return {"plane_frame": chip_smoke.lm_call_sites(cam, cfg, device, frames)[0],
            "synthetic": _synthetic_calls(device)}


def run_time():
    """Time the kernel at the main path's two shapes (see the module's note)."""
    import chip_smoke

    device = torch.device("cuda", 0)
    print(json.dumps(dict(card=chip_smoke._card_line(), torch=torch.__version__,
                          build_s=lm_cuda.LIBRARY.build(),
                          ptxas=chip_smoke.ptxas_usage(lm_cuda.LIBRARY.log))), flush=True)
    for source, calls in _timed_calls(device).items():
        for name, (inputs, coeffs0, iterations, damping0) in calls.items():
            def launch():
                return lm_cuda.lm_solve(inputs, coeffs0, iterations, damping0)

            work = lm_cuda.lm_work(inputs, coeffs0, iterations + 1)
            bound_ms, bound_by = chip_smoke.bound_of(work)
            print(json.dumps(dict(
                source=source, shape=name, batch=work["batch"], iterations=iterations,
                capacities=list(inputs.capacities), live=work["live"],
                device_us=chip_smoke.graph_launch_us(launch), ms=chip_smoke._median_ms(launch),
                bound_us=bound_ms * 1e3, bound_by=bound_by)), flush=True)


#: the row-parallel solve of the ``solve_on_six_lanes`` variant: lane i < 6
#: computes row i of L (column j's entry at step j, row j's entries by
#: shuffle), gathers column i of L, then the substitutions broadcast y[k] and
#: x[k] as they are found; every element takes solve6's operations in order
_SOLVE_ON_SIX_LANES = """
__device__ __forceinline__ float solve6_lanes(const float* row, float diag, float rhs,
                                              int lane) {
  float l_row[6], l_col[6], inv_d[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) l_row[k] = l_col[k] = 0.f;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = lane == j ? diag : row[j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = msub(s, l_row[k], __shfl_sync(LM_FULL, l_row[k], j));
    const float d = sqrtf(clamp_min(__shfl_sync(LM_FULL, s, j), 1e-20f));
    inv_d[j] = 1.f / d;
    l_row[j] = lane == j ? d : s * inv_d[j];
#pragma unroll
    for (int r = j + 1; r < 6; ++r) {
      const float v = __shfl_sync(LM_FULL, l_row[j], r);
      if (lane == j) l_col[r] = v;
    }
  }
  float s = rhs, y_own = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float yk = __shfl_sync(LM_FULL, s * inv_d[k], k);
    if (lane == k) y_own = yk;
    if (lane > k) s = msub(s, l_row[k], yk);
  }
  float x[6], x_own = 0.f;
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float t = y_own;
#pragma unroll
    for (int k = i + 1; k < 6; ++k) t = msub(t, l_col[k], x[k]);
    x[i] = __shfl_sync(LM_FULL, t * inv_d[i], i);
    if (lane == i) x_own = x[i];
  }
  return x_own;
}

// shared memory of a CTA"""

_STEP = "at = best + step_of_lane(jtj, diag, -jtr, row_of, lane);"
_FEATURES = "for (int e = threadIdx.x; e < n_live; e += blockDim.x)"
#: {name: ([(text of csrc/lm.cu, its replacement)], most threads a CTA)}
VARIANTS = {
    "kernel": ([], None),
    "no_features": ([(_FEATURES, "for (int e = threadIdx.x; e < 0; e += blockDim.x)")], None),
    "no_solve": ([(_STEP, "at = best - jtr * 1e-9f + diag * 1e-12f;")], None),
    "pose_and_sums_only": ([(_FEATURES, "for (int e = threadIdx.x; e < 0; e += blockDim.x)"),
                            (_STEP, "at = best - jtr * 1e-9f + diag * 1e-12f;")], None),
    "solve_on_six_lanes": ([("\n// shared memory of a CTA", _SOLVE_ON_SIX_LANES),
                            (_STEP, "at = best + solve6_lanes(jtj, diag, -jtr, lane);")], None),
    "each_tangent_divided": ([
        ("r.d[k] = (a.d[k] - r.v * b.d[k]) * inv;", "r.d[k] = (a.d[k] - r.v * b.d[k]) / b.v;"),
        ("r.d[k] = a.d[k] * inv;", "r.d[k] = a.d[k] / (2.f * r.v);")], None),
    "threads_256": ([("#define LM_MAX_THREADS 128", "#define LM_MAX_THREADS 256")], 256),
    "threads_64": ([], 64),
}


def run_breakdown(names):
    """Time the ``VARIANTS`` named (see the module's note), twice each in turn."""
    import tempfile

    import chip_smoke
    from rgbd_slam_tpu_torch.ops import nvcc

    device = torch.device("cuda", 0)
    calls = {f"{source}_{name}": call for source, by_name in _timed_calls(device).items()
             for name, call in by_name.items()}
    with open(os.path.join(nvcc.CSRC, "lm.cu")) as f:
        source = f.read()
    os.makedirs(nvcc.BUILD_DIR, exist_ok=True)
    max_threads, csrc = lm_cuda.MAX_THREADS, nvcc.CSRC
    print(json.dumps(dict(card=chip_smoke._card_line(), empty_kernel_graph_us=(
        chip_smoke.graph_launch_us(lambda: torch.cuda._sleep(0))))), flush=True)
    with tempfile.TemporaryDirectory(dir=nvcc.BUILD_DIR) as tmp:
        try:
            for rep in range(2):
                for name in names:
                    edits, threads = VARIANTS[name]
                    text = source
                    for old, new in edits:
                        if old not in text:
                            raise RuntimeError(f"variant {name}: {old!r} is not in lm.cu")
                        text = text.replace(old, new)
                    with open(os.path.join(tmp, "lm.cu"), "w") as f:
                        f.write(text)
                    nvcc.CSRC, lm_cuda.LIBRARY.lib = tmp, None
                    lm_cuda.MAX_THREADS = threads or max_threads
                    lm_cuda.LIBRARY.build()
                    out = dict(variant=name, rep=rep)
                    if rep == 0:
                        out["ptxas"] = chip_smoke.ptxas_usage(lm_cuda.LIBRARY.log)
                    for call, (inputs, coeffs0, iterations, damping0) in calls.items():
                        out[f"{call}_us"] = chip_smoke.graph_launch_us(
                            lambda: lm_cuda.lm_solve(inputs, coeffs0, iterations, damping0))
                    print(json.dumps(out), flush=True)
        finally:
            nvcc.CSRC, lm_cuda.MAX_THREADS, lm_cuda.LIBRARY.lib = csrc, max_threads, None


def run_launch():
    device = torch.device("cuda", 0)
    for name, (inputs, c0, iterations, damping0) in _synthetic_calls(device).items():
        got = lm_cuda.lm_solve(inputs, c0, iterations, damping0, details=True)
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
    ate.add_argument("--first-parting", action="store_true",
                     help="where the ATEs part, the first frame whose poses part and why")
    sub.add_parser("time", help="device time a launch at the main path's two shapes")
    breakdown = sub.add_parser("breakdown", help="time ablations and alternatives of lm.cu")
    breakdown.add_argument("variants", nargs="*", metavar="VARIANT",
                           help=f"of {', '.join(VARIANTS)} (default: all)")
    sub.add_parser("launch", help="one kernel launch at each main-path shape")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("lm_diagnostics: no CUDA device", file=sys.stderr)
        return 1
    if args.what == "ate":
        if args.first_parting and not {"kernel", "plain"} <= set(args.runs):
            parser.error("--first-parting needs the kernel and plain runs")
        run_ate(args.paths, args.seeds, args.runs, args.first_parting)
    elif args.what == "time":
        run_time()
    elif args.what == "breakdown":
        unknown = set(args.variants) - set(VARIANTS)
        if unknown:
            parser.error(f"unknown variants {sorted(unknown)}")
        run_breakdown(args.variants or list(VARIANTS))
    else:
        run_launch()
    return 0


if __name__ == "__main__":
    sys.exit(main())
