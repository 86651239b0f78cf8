"""A sequence on disk in the TUM RGB-D format, as the ``tum_files`` traffic
writes it: a frozen copy of ``chip_smoke.write_png`` and of
``chip_smoke.write_tum_directory`` (commit 01a0d89), without the stereo rig
(the depth is registered to the RGB camera, identity extrinsic, and rendered
with it), and split so that the render workers write the frames and the
set-up the lists."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

#: the first frame's time stamp (s) and the frame period of a 30 Hz sensor
FIRST_STAMP_S = 1300000000.0
PERIOD_S = 1.0 / 30.0
#: the depth image's stamp after its RGB image's (TUM pairs them by nearest stamp)
DEPTH_LAG_S = 0.002


def write_png(path: str, pixels: np.ndarray):
    """A PNG with no filter and one IDAT chunk: 8-bit RGB ([H, W, 3] uint8) or
    16-bit gray ([H, W] uint16)."""
    h, w = pixels.shape[:2]
    if pixels.dtype == np.uint8 and pixels.ndim == 3 and pixels.shape[2] == 3:
        bit_depth, color_type, rows = 8, 2, pixels.reshape(h, w * 3)
    elif pixels.dtype == np.uint16 and pixels.ndim == 2:
        bit_depth, color_type = 16, 0
        rows = pixels.astype(">u2").view(np.uint8).reshape(h, w * 2)   # big-endian samples
    else:
        raise ValueError(f"no PNG form for {pixels.dtype} {pixels.shape}")
    scanlines = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    header = struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(scanlines, 1)) + chunk(b"IEND", b""))


def gray8(gray) -> np.ndarray:
    """The rendered gray image as the 8-bit samples of the file."""
    return np.clip(gray, 0, 255).astype(np.uint8)


def depth16(depth_mm, units_per_mm: float) -> np.ndarray:
    """The rendered depth (mm) as the 16-bit samples of the file."""
    return np.clip(depth_mm * units_per_mm, 0, 65535).astype(np.uint16)


def dataset_dir(root: str) -> str:
    return os.path.join(root, "rgbd_dataset_slambench")


def _stamp(i: int) -> float:
    return FIRST_STAMP_S + PERIOD_S * i


def write_frame(root: str, i: int, gray, depth_mm, units_per_mm: float):
    """Frame ``i``'s two PNGs in the dataset under ``root``: 8-bit RGB and
    16-bit depth at ``units_per_mm``."""
    dataset = dataset_dir(root)
    ts = _stamp(i)
    g8 = gray8(gray)
    write_png(os.path.join(dataset, "rgb", f"{ts:.4f}.png"), np.stack([g8] * 3, -1))
    write_png(os.path.join(dataset, "depth", f"{ts + DEPTH_LAG_S:.4f}.png"),
              depth16(depth_mm, units_per_mm))


def make_dataset(root: str) -> str:
    """The dataset's directories under ``root``, empty.  Returns the dataset."""
    dataset = dataset_dir(root)
    os.makedirs(os.path.join(dataset, "rgb"))
    os.makedirs(os.path.join(dataset, "depth"))
    return dataset


def write_lists(root: str, poses) -> str:
    """The dataset's ``rgb.txt``, ``depth.txt`` and ``groundtruth.txt`` for
    ``poses`` [(quat wxyz, position mm)] (metres, quaternions as qx qy qz qw).
    Returns the dataset directory."""
    dataset = dataset_dir(root)
    rgb_lines, depth_lines, gt_lines = ["# rgb"], ["# depth"], ["# gt"]
    for i, (quat, pos) in enumerate(poses):
        ts = _stamp(i)
        rgb_lines.append(f"{ts:.4f} rgb/{ts:.4f}.png")
        depth_lines.append(f"{ts + DEPTH_LAG_S:.4f} depth/{ts + DEPTH_LAG_S:.4f}.png")
        w, x, y, z = quat
        gt_lines.append(f"{ts:.4f} {pos[0] / 1000} {pos[1] / 1000} {pos[2] / 1000} "
                        f"{x} {y} {z} {w}")
    for name, lines in (("rgb.txt", rgb_lines), ("depth.txt", depth_lines),
                        ("groundtruth.txt", gt_lines)):
        with open(os.path.join(dataset, name), "w") as f:
            f.write("\n".join(lines))
    return dataset
