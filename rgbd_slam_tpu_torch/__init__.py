"""PyTorch + CUDA port of the RGB-D SLAM engine in ``rgbd_slam_tpu``.

The JAX package stays the reference; this package keeps its module paths, function
names and fixed-capacity masked state, written as plain functions on tensors.  The
JAX package's Pallas kernels (the pyramidal LK: fused forward-backward,
forward-only and single-level) are hand-written CUDA kernels for Hopper
(``csrc/lk.cu``); every other op is plain PyTorch.  This package never imports
jax.
"""

import torch as _torch

# The SLAM pipeline's small-matrix algebra (4x4 transforms, covariance
# propagation, Kalman/LM solves) needs true f32: TF32 keeps ~3 decimal digits
# (the JAX package pins "highest" matmul precision for the same reason).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
