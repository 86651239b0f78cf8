"""A checkout for the CPU tests of the harness: ``BENCHMARK.json`` and the
benchmark's data files copied into a temporary root, with a cell's sequence
cut to a size the CPU steps in seconds (fewer frames, checked steps and
realisations), beside a link to the program."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def make_root(tmp: Path, frames: int = 8, warmup: int = 3, checked: int = 4,
              realizations: int = 2) -> Path:
    root = Path(tmp) / "checkout"
    (root / "slambench").mkdir(parents=True)
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(REPO / "slambench" / sub, root / "slambench" / sub)
    for path in (root / "slambench" / "configs").glob("*.json"):
        conf = json.loads(path.read_text())
        conf["sequence_frames"] = frames
        path.write_text(json.dumps(conf))
    for path in (root / "slambench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update(warmup_frames=warmup, checked_frames=checked, render_workers=2,
                   realizations=mix["realizations"][:realizations])
        path.write_text(json.dumps(mix))
    (root / "rgbd_slam_tpu_torch").symlink_to(REPO / "rgbd_slam_tpu_torch")
    return root
