#!/usr/bin/env python
"""TUM RGB-D sequence runner of the PyTorch port: ``rgbd_slam_tpu_torch.cli``
(same options as ``examples/run_tum.py``, plus ``--device``)."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from rgbd_slam_tpu_torch.cli import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
