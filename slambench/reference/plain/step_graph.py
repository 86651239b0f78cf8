"""Frozen plain copy: the eager step only: no CUDA graph is recorded (see the package's docstring).

The engine step as one CUDA graph: the counterpart of ``jax.jit(engine.step)``.

The JAX package compiles the whole step into one device program per static
configuration (``cam``, ``cfg``, ``with_planes``, ``with_lines``), and a frame
is one dispatch.  :class:`StepGraph` does the same on the card: the eager
``engine.step`` is recorded once into a ``torch.cuda.CUDAGraph`` over static
buffers (the state, the frame pair, the step's random draws) and replayed for
every frame.  The step reads the host nowhere on the card (the detection flag
stays a tensor, the components fixpoint is a kernel), which is what lets it be
recorded.

* Recording: one eager step on a side stream over a copy of the state and of
  its generator builds the kernels, creates the libraries' handles and fills
  the caches of constant tensors (none of which a capture may do); then the
  step is captured once.  At the end of the captured step the new state is
  copied into the static state buffers, so that a replay advances the state in
  place.  A capture or replay that fails raises: nothing falls back to the
  eager step.
* Randomness: the step's draws (:func:`engine.draw_step_draws`) are taken from
  the state's generator outside the graph before each replay, in the order and
  with the calls of the eager step, and copied into the static draw buffers;
  the graph therefore equals the eager step to the bit.
* Outputs: ``step`` returns the static state and the step's outputs.  Both are
  overwritten by the next replay: a caller that keeps anything past it copies
  it out (:func:`clone_tree`).
* Launch counts: a kernel wrapper counts its launches when Python calls it,
  which a replay does not.  The counts a capture added are taken back and added
  again on every replay.

:func:`stepper` gives the runner a :class:`StepGraph` on a card and an
:class:`EagerStep` (``engine.step`` as it is) on the CPU.
"""

from __future__ import annotations


import torch

from . import engine
from .config import CameraIntrinsics, SlamConfig


def tree_map(fn, tree):
    """``fn`` over every tensor of a tree of named tuples, tuples and lists;
    other leaves (the generator) are kept as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_map(fn, x) for x in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return tree


def tensor_leaves(tree) -> list:
    """The tensors of a tree, in ``tree_map``'s order."""
    found = []
    tree_map(found.append, tree)
    return found


def clone_tree(tree):
    """A copy of every tensor of a tree, on its device."""
    return tree_map(torch.clone, tree)


class EagerStep:
    """``engine.step`` frame by frame, on any device: what the CPU runs."""

    warmup_steps = 0
    #: the returned state and outputs are the step's own, never overwritten
    reuses_outputs = False

    def __init__(self, state: engine.SlamState, cam: CameraIntrinsics, cfg: SlamConfig,
                 with_planes: bool = True, with_lines: bool = False):
        self.state = state
        self._args = (cam, cfg, with_planes, with_lines)

    def step(self, gray, depth):
        cam, cfg, with_planes, with_lines = self._args
        self.state, out = engine.step(self.state, gray, depth, cam, cfg,
                                      with_planes=with_planes, with_lines=with_lines)
        return self.state, out

    def close(self):
        pass


def stepper(state: engine.SlamState, cam: CameraIntrinsics, cfg: SlamConfig,
            with_planes: bool = True, with_lines: bool = False):
    """How the runner steps: a :class:`StepGraph` on a card, an
    :class:`EagerStep` on the CPU."""
    return EagerStep(state, cam, cfg, with_planes=with_planes, with_lines=with_lines)
