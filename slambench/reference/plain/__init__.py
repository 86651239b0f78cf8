"""A frozen copy of the plain path of ``rgbd_slam_tpu_torch`` (commit 01a0d89):
the reference that decides ``correct``.

What differs from the package it was copied from:

* ``ops/{lk,lm,cells,components,cylinders}_cuda.py`` keep their plain versions
  only: the kernels, their build, their ctypes bindings, their launch counters
  and their work counts are cut, and each dispatcher calls the plain version on
  every device;
* ``runner.run_frames`` has no map export (``io/map_writer.py`` is cut);
* ``step_graph.py`` keeps the eager step (``EagerStep``) and ``solve_graph.py``
  the eager solve (``EagerSolve``): no CUDA graph is recorded;
* ``runner.run_frames`` takes ``make_stepper``, which builds the object that
  steps the frames in place of ``step_graph.stepper``;
* importing the package sets no global flag of PyTorch: whoever runs it pins
  TF32 off (``slambench.check``).

Nothing here imports the port, JAX or a kernel.
"""
