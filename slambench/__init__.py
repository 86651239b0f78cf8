"""The benchmark of the PyTorch and CUDA port, ``rgbd_slam_tpu_torch``, on one
NVIDIA H100 (``slambench/run.py``; its cells, metrics and bounds are in
``BENCHMARK.json`` at the root of the repository).  Nothing here imports JAX or
the JAX package."""
