"""The backend's solves as CUDA graphs: the counterpart of the JAX package's
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
* Spans (``profiling.span``): ``solve.capture`` (the first call), ``solve.load``
  and ``solve.replay``; the caller's read of the outputs is its ``solve.read``.

:func:`solver` gives the backend a :class:`SolveGraph` on a card and an
:class:`EagerSolve` (the function as it is) on the CPU.
"""

from __future__ import annotations

import time

import torch

from . import profiling
from .ops import nvcc
from .step_graph import capture


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


class SolveGraph:
    """``fn`` over static input buffers as one CUDA graph on ``device``,
    recorded at the first call and replayed at every later one.  ``fn`` takes
    tensors of fixed shapes and dtypes and returns a tree of tensors (named
    tuples, tuples, lists).  :meth:`close` frees the graph and its memory
    pool."""

    #: the returned tensors are overwritten by the next call
    reuses_outputs = True

    def __init__(self, fn, device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"SolveGraph records a CUDA graph: the device must be a CUDA "
                             f"device, not {device}")
        self._fn = fn
        self.device = device
        self._graph = None
        self._inputs = None
        self._staging = None
        self._copied = None
        self._out = None
        self._launches = None
        #: seconds the warm-up and the capture took
        self.record_s = 0.0

    def __call__(self, *inputs):
        """Copy ``inputs`` into the static buffers and replay; the first call
        records the graph first.  Returns the static outputs."""
        if self._graph is None:
            with profiling.span("solve.capture"):
                self._record(inputs)
        else:
            with profiling.span("solve.load"):
                self._load(inputs)
        with profiling.span("solve.replay"):
            self._graph.replay()
        nvcc.add_launches(self._launches)
        return self._out

    def close(self):
        """Free the graph and its memory pool."""
        if self._graph is not None:
            self._graph.reset()
        self._graph = self._out = self._inputs = self._staging = self._copied = None

    def _load(self, inputs):
        if len(inputs) != len(self._inputs):
            raise ValueError(f"{len(inputs)} inputs for a graph of {len(self._inputs)}")
        # the last call's copies out of the staging buffers are done
        self._copied.synchronize()
        for k, (static, x) in enumerate(zip(self._inputs, inputs)):
            if x.shape != static.shape or x.dtype != static.dtype:
                raise ValueError(f"an input of {x.dtype} {tuple(x.shape)} for "
                                 f"{static.dtype} {tuple(static.shape)}")
            if x.device.type == "cpu":
                if self._staging[k] is None:
                    self._staging[k] = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                self._staging[k].copy_(x)
                x = self._staging[k]
            static.copy_(x, non_blocking=True)
        self._copied.record(torch.cuda.current_stream(self.device))

    def _record(self, inputs):
        t0 = time.perf_counter()
        device = self.device
        self._inputs = [torch.empty(x.shape, dtype=x.dtype, device=device) for x in inputs]
        self._staging = [None] * len(inputs)
        self._copied = torch.cuda.Event()
        self._copied.record(torch.cuda.current_stream(device))
        self._load(inputs)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._fn(*self._inputs)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        self._out, self._launches = capture(graph, lambda: self._fn(*self._inputs))
        self._graph = graph
        profiling.count("captures")
        self.record_s = time.perf_counter() - t0


def solver(fn, device):
    """How the backend solves: a :class:`SolveGraph` on a card, an
    :class:`EagerSolve` on the CPU."""
    cls = SolveGraph if torch.device(device).type == "cuda" else EagerSolve
    return cls(fn, device)
