"""Dataset loaders: TUM RGB-D and CAPE sequences.

Parity with the reference example apps (examples/TUM_parser.hpp:46-120,
examples/main_TUM.cpp:230-260, examples/main_CAPE.cpp:48-65):

* TUM: ``rgb.txt``/``depth.txt`` timestamp lists greedily associated (or a prebuilt
  ``associations.txt``), ``groundtruth.txt`` poses matched by nearest timestamp;
  16-bit depth PNGs scaled by 1/5 to millimeters (main_TUM.cpp:242 — TUM stores
  depth*5000 per meter);
* CAPE: ``rgb_<i>.png`` / ``depth_<i>.png`` numbered pairs, depth already in mm.

Decoding uses PIL (host-side, feeding the device pipeline).  A copy of
``rgbd_slam_tpu/io/datasets.py`` (numpy only): the JAX package cannot be imported
without jax.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Frame:
    timestamp: float
    gray: np.ndarray       # [H, W] float32
    depth_mm: np.ndarray   # [H, W] float32 millimeters
    gt_position: np.ndarray | None = None   # [3] (TUM convention, meters)
    gt_quaternion: np.ndarray | None = None # [4] wxyz


@dataclass
class FrameIndex:
    """Lazily-loadable frame reference."""
    timestamp: float
    rgb_path: str
    depth_path: str
    gt_position: np.ndarray | None = None
    gt_quaternion: np.ndarray | None = None


def _load_gray(path: str) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("L")
    return np.asarray(img, dtype=np.float32)


def _load_depth_tum(path: str) -> np.ndarray:
    from PIL import Image

    img = Image.open(path)
    arr = np.asarray(img, dtype=np.float32)
    return arr / 5.0  # 16-bit TUM depth -> millimeters (main_TUM.cpp:242)


def _load_depth_mm(path: str) -> np.ndarray:
    from PIL import Image

    img = Image.open(path)
    return np.asarray(img, dtype=np.float32)


def _parse_list_file(path: str) -> list[tuple[float, str]]:
    """TUM list file: '# comment' lines then 'timestamp path'
    (TUM_parser.hpp parse_file)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1]))
    return out


def _parse_ground_truth(path: str) -> list[tuple[float, np.ndarray, np.ndarray]]:
    """groundtruth.txt: 'timestamp tx ty tz qx qy qz qw'
    (TUM_parser.hpp parse_ground_truth)."""
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = line.split()
            if len(v) < 8:
                continue
            pos = np.array([float(v[1]), float(v[2]), float(v[3])])
            # file order qx qy qz qw -> store wxyz
            quat = np.array([float(v[7]), float(v[4]), float(v[5]), float(v[6])])
            out.append((float(v[0]), pos, quat))
    return out


def _associate(rgb_list, depth_list, max_dt: float = 0.02):
    """Greedy nearest-timestamp association (TUM_parser.hpp associate_data)."""
    pairs = []
    di = 0
    for ts, rgb in rgb_list:
        while di + 1 < len(depth_list) and \
                abs(depth_list[di + 1][0] - ts) <= abs(depth_list[di][0] - ts):
            di += 1
        if di < len(depth_list) and abs(depth_list[di][0] - ts) <= max_dt:
            pairs.append((ts, rgb, depth_list[di][1]))
    return pairs


def _attach_ground_truth(pairs, gt, max_dt: float = 0.05):
    out = []
    gi = 0
    for ts, rgb, depth in pairs:
        pos = quat = None
        if gt:
            while gi + 1 < len(gt) and abs(gt[gi + 1][0] - ts) <= abs(gt[gi][0] - ts):
                gi += 1
            if abs(gt[gi][0] - ts) <= max_dt:
                pos, quat = gt[gi][1], gt[gi][2]
        out.append(FrameIndex(ts, rgb, depth, pos, quat))
    return out


def index_tum(dataset_dir: str) -> list[FrameIndex]:
    """Index a TUM sequence directory (prefers associations.txt,
    TUM_parser.hpp:63-105)."""
    gt = _parse_ground_truth(os.path.join(dataset_dir, "groundtruth.txt"))
    assoc_path = os.path.join(dataset_dir, "associations.txt")
    pairs = []
    if os.path.exists(assoc_path):
        with open(assoc_path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                v = line.split()
                # 'depth_ts depth_path rgb_ts rgb_path'
                pairs.append((float(v[2]), v[3], v[1]))
    else:
        rgb_list = _parse_list_file(os.path.join(dataset_dir, "rgb.txt"))
        depth_list = _parse_list_file(os.path.join(dataset_dir, "depth.txt"))
        pairs = _associate(rgb_list, depth_list)
    pairs = [(ts, os.path.join(dataset_dir, r), os.path.join(dataset_dir, d))
             for ts, r, d in pairs]
    return _attach_ground_truth(pairs, gt)


def load_tum_frame(idx: FrameIndex) -> Frame:
    return Frame(idx.timestamp, _load_gray(idx.rgb_path),
                 _load_depth_tum(idx.depth_path), idx.gt_position,
                 idx.gt_quaternion)


def index_cape(dataset_dir: str) -> list[FrameIndex]:
    """Index a CAPE sequence: numbered rgb_<i>.png / depth_<i>.png pairs
    (main_CAPE.cpp:48-65)."""
    out = []
    i = 0
    while True:
        rgb = os.path.join(dataset_dir, f"rgb_{i}.png")
        depth = os.path.join(dataset_dir, f"depth_{i}.png")
        if not (os.path.exists(rgb) and os.path.exists(depth)):
            break
        out.append(FrameIndex(float(i), rgb, depth))
        i += 1
    return out


def load_cape_frame(idx: FrameIndex) -> Frame:
    return Frame(idx.timestamp, _load_gray(idx.rgb_path),
                 _load_depth_mm(idx.depth_path), idx.gt_position,
                 idx.gt_quaternion)
