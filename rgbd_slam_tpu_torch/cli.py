"""TUM RGB-D sequence runner: from a sequence on disk to a trajectory and a map
(the port's counterpart of ``examples/run_tum.py``).

Usage:
    python -m rgbd_slam_tpu_torch.cli -d /path/to/rgbd_dataset_freiburg1_xyz \\
        [-c tum_fr1] [--camera-yaml FILE] [-n MAX_FRAMES] [-o trajectory.txt] \\
        [-m map.obj] [--no-planes] [--lines] [--ba N] [--stream-map] \\
        [--native-loader] [--device cpu]

Prints the frame count, a status line every 20 frames, the run's summary, the
ATE-RMSE against the ground truth (when the sequence has one) and where the
trajectory and the map went.  Runs on the card unless ``--device`` says
otherwise, and raises without one.

With ``RGBD_SLAM_RUN_REPORT=FILE`` in the environment the run's ``RunStats`` and
the LK kernels' launch counts are also written to FILE as one JSON object, for
a caller that starts this as a subprocess.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

from . import runner
from .config import TUM_FR1, CameraIntrinsics, SlamConfig, load_camera_yaml
from .io import datasets
from .io.map_writer import export_slam_map
from .io.trajectory import ate_rmse
from .ops import lk_cuda

CAMERAS = {
    "tum_fr1": TUM_FR1,
    "tum_fr2": CameraIntrinsics(640, 480, 520.9, 521.0, 325.1, 249.7),
    "tum_fr3": CameraIntrinsics(640, 480, 535.4, 539.2, 320.1, 247.6),
    "default": CameraIntrinsics(),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-d", "--dataset", required=True, help="TUM sequence directory")
    ap.add_argument("-c", "--camera", default="tum_fr1", choices=sorted(CAMERAS))
    ap.add_argument("--camera-yaml", default="",
                    help="camera YAML (reference configuration_example.yaml "
                         "format); overrides -c")
    ap.add_argument("-n", "--max-frames", type=int, default=0)
    ap.add_argument("-o", "--trajectory-out", default="")
    ap.add_argument("-m", "--map-out", default="")
    ap.add_argument("--no-planes", action="store_true")
    ap.add_argument("--lines", action="store_true",
                    help="enable the line feature map + line pose residuals")
    ap.add_argument("--ba", dest="ba_every", type=int, default=0, metavar="N",
                    help="run windowed Schur BA every N frames (0 = off), with "
                         "keyframe selection and pose-graph stitching")
    ap.add_argument("--stream-map", action="store_true",
                    help="stream the map file during the run (features append "
                         "at death) instead of a shutdown snapshot; requires -m")
    ap.add_argument("--native-loader", action="store_true",
                    help="use the C++ prefetching PNG loader")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card (no CPU fallback)")
    return ap.parse_args(argv)


def open_frames(index, cam: CameraIntrinsics, native: bool):
    """(gray, depth_mm, timestamp) frames of an indexed TUM sequence, decoded
    as they are asked for: by the C++ prefetching loader or by PIL."""
    if native:
        from .io.native_loader import NativeFrameLoader

        loader = NativeFrameLoader([i.rgb_path for i in index],
                                   [i.depth_path for i in index],
                                   cam.height, cam.width, depth_scale=0.2)
        return ((g, d, index[i].timestamp) for i, (g, d) in enumerate(loader))
    return ((f.gray, f.depth_mm, f.timestamp)
            for f in map(datasets.load_tum_frame, index))


def main(argv=None) -> int:
    args = parse_args(argv)
    setup = None
    if args.camera_yaml:
        setup = load_camera_yaml(args.camera_yaml)
        cam = setup.rgb
    else:
        cam = CAMERAS[args.camera]
    cfg = SlamConfig()
    index = datasets.index_tum(args.dataset)
    if args.max_frames:
        index = index[: args.max_frames]
    if not index:
        print("no frames found", file=sys.stderr)
        return 1
    print(f"{len(index)} frames in {args.dataset}")

    def on_frame(i, state, out, dt):
        if i % 20 == 0:
            print(f"frame {i}: success={bool(out.success)} "
                  f"lost={bool(out.is_lost)} "
                  f"pts={int(out.n_points_alive)} "
                  f"planes={int(out.n_planes_alive)} ({dt * 1000:.0f} ms)")

    state, traj, stats = runner.run_frames(
        open_frames(index, cam, args.native_loader), cam, cfg,
        with_planes=not args.no_planes, with_lines=args.lines, on_frame=on_frame,
        ba_every=args.ba_every or None,
        export_map=(args.map_out if args.stream_map and args.map_out else None),
        camera_setup=setup, device=args.device)
    print(stats.summary())
    if args.ba_every:
        print(f"BA: runs={stats.ba_runs} accepted={stats.ba_accepted} "
              f"iters/s={stats.ba_iters_per_s:.1f} "
              f"keyframes={stats.keyframe_count}")

    gt = [i.gt_position for i in index if i.gt_position is not None]
    if len(gt) == len(index):
        gt_mm = np.stack(gt) * 1000.0  # TUM groundtruth is meters
        est = traj.positions_array()
        n = min(len(est), len(gt_mm))
        print(f"ATE-RMSE: {ate_rmse(est[:n], gt_mm[:n]):.1f} mm over {n} frames")

    if args.trajectory_out:
        traj.save_tum_format(args.trajectory_out)
        print(f"trajectory -> {args.trajectory_out}")
    if args.map_out and not args.stream_map:
        export_slam_map(state, args.map_out)
    if args.map_out:
        print(f"map -> {args.map_out}")
    report = os.environ.get("RGBD_SLAM_RUN_REPORT")
    if report:
        with open(report, "w") as f:
            json.dump({"stats": dataclasses.asdict(stats),
                       "lk_launches": dict(lk_cuda.LAUNCHES)}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
