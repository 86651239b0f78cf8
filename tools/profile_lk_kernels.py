"""Device time and phase profile of the LK kernels on one card.

    python tools/profile_lk_kernels.py [--profile] [--out FILE]

At ``chip_smoke.py``'s kernel shapes (640x480 RoomScene pair, 5 levels, 53x53
windows, 128 / 99 / 99 FAST points) it builds
``rgbd_slam_tpu_torch/csrc/lk.cu`` and, for the three kernels:

* holds the kernel to its plain version (0.05 px, equal flags);
* times a launch on the device: 50 launches replayed from one CUDA graph
  (``device_us``), and the kernel's own time under ``torch.profiler`` over 20
  plain launches (``profiler_us``), the pyramids warm in L2;
* reports the build seconds and ptxas' registers and spills.

``--profile`` then loads the ``-DLK_PHASE_PROFILE`` build and launches the fused
and the forward-only kernel once each: thread 0 of the first 8 CTAs stamps
``clock64()`` at the phase borders of the sweep.  The report gives microseconds
per pass, level and phase, averaged over those CTAs (cycles scaled by each
CTA's global-timer span), and the iterations each level ran.

Prints one JSON object; ``--out`` also writes it to a file.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as smoke  # noqa: E402
from rgbd_slam_tpu_torch import config  # noqa: E402
from rgbd_slam_tpu_torch.ops import lk_cuda  # noqa: E402

PHASES = {1: "staged", 2: "tensor", 4: "step", 5: "restage", 9: "pass_end"}
PROFILED_CTAS = 8
PROFILE_CAPACITY = 256


def _profiler_us(fn, launches: int = 20):
    """Mean device time of the LK kernel over ``launches`` plain calls."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    us = [evt.time_range.elapsed_us() for evt in prof.events()
          if evt.device_type == DeviceType.CUDA and evt.name.startswith("lk_")]
    return float(np.mean(us)) if us else None


def time_kernels(cases):
    out = {"build_s": lk_cuda.LIBRARY.build(), "ptxas": smoke.ptxas_usage(lk_cuda.LIBRARY.log),
           "kernels": {}}
    for case in cases:
        err, n_both, flag_diffs, _ = smoke.check_case(case)
        timed = {"max_abs_err_px": err, "both_ok": n_both, "flag_diffs": flag_diffs}
        if case.guesses is None:   # the restage case is checked, not timed
            timed["device_us"] = smoke.graph_launch_us(case.kernel)
            timed["profiler_us"] = _profiler_us(case.kernel)
        out["kernels"][case.name] = timed
    return out


def phase_profile(cases):
    """Microseconds by (pass, level, phase) of one launch of the fused and the
    forward-only kernel, from the LK_PHASE_PROFILE build."""
    lk_cuda.LIBRARY.build(lk_cuda.PROFILE_FLAGS)
    device = torch.device("cuda")
    out = {}
    for case in cases:
        if case.name not in ("lk_fwd_bwd", "lk_pyramid"):
            continue
        buf = torch.zeros((PROFILED_CTAS, PROFILE_CAPACITY, 3), dtype=torch.int64,
                          device=device)
        lk_cuda.profile_attach(buf, PROFILED_CTAS, PROFILE_CAPACITY)
        case.kernel()            # warm-up: the marks restart with every launch
        torch.cuda.synchronize()
        buf.zero_()
        case.kernel()
        torch.cuda.synchronize()
        marks = buf.cpu().numpy()
        by_phase = defaultdict(float)
        iterations = defaultdict(float)
        totals, ghz = [], []
        for cta in marks:
            cta = cta[cta[:, 1] != 0]
            span_cycles = cta[-1, 1] - cta[0, 1]
            span_ns = cta[-1, 2] - cta[0, 2]
            us_per_cycle = span_ns / 1e3 / span_cycles
            ghz.append(span_cycles / span_ns)
            totals.append(span_ns / 1e3)
            for (tag, clk, _), (_, before, _) in zip(cta[1:], cta[:-1]):
                pas, lvl, phase = tag // 10000, tag % 10000 // 1000, tag % 1000 // 100
                key = f"{'bwd' if pas else 'fwd'} L{lvl} {PHASES.get(phase, phase)}"
                by_phase[key] += (clk - before) * us_per_cycle / len(marks)
                if phase == 4:
                    iterations[f"{'bwd' if pas else 'fwd'} L{lvl}"] += 1 / len(marks)
        out[case.name] = {
            "ctas": len(marks), "marked_us_mean": float(np.mean(totals)),
            "marked_us_max": float(np.max(totals)), "sm_ghz": float(np.mean(ghz)),
            "us_by_phase": dict(by_phase), "iterations_by_level": dict(iterations)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_lk_kernels: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    cases = smoke.kernel_cases(config.TUM_FR1, config.SlamConfig(), device)
    report = {"card": smoke._card_line(), "torch": torch.__version__,
              "work": {c.name: {k: v for k, v in c.work().items() if k != "levels"}
                       for c in cases},
              "timed": time_kernels(cases),
              "phase_profile": phase_profile(cases) if args.profile else None}
    text = json.dumps(report)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
