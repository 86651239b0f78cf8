"""Frozen plain copy: the eager solve only: no CUDA graph is recorded (see the package's docstring).

The backend's solves as CUDA graphs: the counterpart of the JAX package's
jitted packed solvers.

The JAX package compiles the windowed bundle adjustment's packed solve once
per window and static key (``jax.jit`` in ``KeyframeWindow._get_solver``) and
the pose graph's packed solve once per capacity (``pose_graph._solve_packed``),
and a refine or a graph solve is then one dispatch.  :class:`SolveGraph` does
the same on the card: a function of static input buffers is recorded once into
a ``torch.cuda.CUDAGraph`` and replayed at every call, as
``step_graph.StepGraph`` does for the step.

* Recording: at the first call the inputs are copied into static buffers on
  the card; one eager call on a side stream creates the libraries' handles and
  workspaces (cuBLAS for the products, cuSOLVER for the Cholesky factorization
  and solve), which a capture may not do; then the function is captured once
  over the static buffers and replayed.  A capture or replay that fails
  raises: nothing falls back to the eager solve.
* Inputs: a call copies each argument into its static buffer.  A host
  argument goes through a page-locked staging buffer in one asynchronous copy,
  and the next call waits for that copy before it fills the staging buffer
  again.
* Outputs: the function's outputs as the graph's static tensors, overwritten
  by the next call; a caller that keeps one past it copies it.
* Launch counts: as in ``StepGraph``, the counts a capture added are taken
  back and added again at every replay.

:func:`solver` gives the backend a :class:`SolveGraph` on a card and an
:class:`EagerSolve` (the function as it is) on the CPU.
"""

from __future__ import annotations


import torch


class EagerSolve:
    """The function as it is, on any device: what the CPU runs."""

    #: the returned tensors are the function's own, never overwritten
    reuses_outputs = False

    def __init__(self, fn, device):
        self._fn = fn
        self.device = torch.device(device)

    def __call__(self, *inputs):
        return self._fn(*(x.to(self.device) for x in inputs))

    def close(self):
        pass


def solver(fn, device):
    """How the backend solves: a :class:`SolveGraph` on a card, an
    :class:`EagerSolve` on the CPU."""
    return EagerSolve(fn, device)
