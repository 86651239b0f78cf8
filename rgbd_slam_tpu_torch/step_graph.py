"""The engine step as one CUDA graph: the counterpart of ``jax.jit(engine.step)``.

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
* Stamps: recorded while a ``profiling`` recorder is active (``run_frames``'
  ``trace``), the graph holds one stamp node at the start of the step and one
  at the end of each stage of its path (``profiling.stamps(with_lines,
  with_planes)``; a nested section also at its start),
  each writing the card's clock into its slot of ``stamps``; a replay
  overwrites them.  Before the capture one stamp between two host clock reads
  gives the card's clock against the host's (``clock_bracket``, into the
  path's offset slot, :func:`stamp_slots`).  The runner stamps a frame's
  upload from the host into the path's two upload slots.  The stamps write
  only their own buffer.
* The cylinder stage's live slots (``profiling.count_cylinders``) are kept in
  ``cylinders_live``: in a ``StepGraph`` the graph's tensor, which each replay
  rewrites, in an ``EagerStep`` the last step's; None with planes off.

:func:`stepper` gives the runner a :class:`StepGraph` on a card and an
:class:`EagerStep` (``engine.step`` as it is) on the CPU.
"""

from __future__ import annotations

import time

import torch

from . import engine, profiling
from .config import CameraIntrinsics, SlamConfig
from .ops import nvcc, stamps_cuda

#: eager steps (on a copy of the state) before the step is recorded
WARMUP_STEPS = 1


def stamp_slots(with_lines: bool, with_planes: bool = True) -> tuple[int, tuple[int, int]]:
    """The last slots of a path's stamp buffer, after the replay's stamps
    (``profiling.stamps(with_lines, with_planes)``): the stamp taken between
    two host clock reads, then the two that the runner takes before and after
    a frame's upload.  Returns (that offset slot, the two upload slots)."""
    offset = len(profiling.stamps(with_lines, with_planes))
    return offset, (offset + 1, offset + 2)


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


def capture(graph: torch.cuda.CUDAGraph, fn):
    """``fn()`` captured into ``graph``.  A kernel wrapper counts its launches
    when Python calls it, which a replay does not: the counts the capture added
    are taken back (``nvcc.take_back``) and returned, for ``nvcc.add_launches``
    to add at every replay.  Returns (``fn``'s result, the added counts)."""
    def record():
        with torch.cuda.graph(graph):
            return fn()

    return nvcc.take_back(record)


class EagerStep:
    """``engine.step`` frame by frame, on any device: what the CPU runs."""

    warmup_steps = 0
    #: the returned state and outputs are the step's own, never overwritten
    reuses_outputs = False

    def __init__(self, state: engine.SlamState, cam: CameraIntrinsics, cfg: SlamConfig,
                 with_planes: bool = True, with_lines: bool = False):
        self.state = state
        self._args = (cam, cfg, with_planes, with_lines)
        #: the last step's live cylinder slots (``profiling.count_cylinders``)
        self.cylinders_live = None

    def step(self, gray, depth):
        cam, cfg, with_planes, with_lines = self._args
        self.cylinders_live = None
        with profiling.counting(self):
            self.state, out = engine.step(self.state, gray, depth, cam, cfg,
                                          with_planes=with_planes, with_lines=with_lines)
        return self.state, out

    def close(self):
        pass


class StepGraph:
    """``engine.step`` of one configuration as one CUDA graph on the state's
    card, recorded at the first :meth:`step` and replayed at every frame.

    ``state`` is copied into the graph's static state, which the replays then
    advance in place; the generator is the caller's own, and advances as the
    eager step advances it.  ``StepGraph.state`` reads the static state;
    assigning it copies a state of the same configuration into the static
    buffers (what differs from them), as the backend's landmark write-back
    does.  :meth:`close` frees the graph and its memory pool."""

    #: the returned state and outputs are overwritten by the next replay
    reuses_outputs = True

    def __init__(self, state: engine.SlamState, cam: CameraIntrinsics, cfg: SlamConfig,
                 with_planes: bool = True, with_lines: bool = False):
        device = state.quat.device
        if device.type != "cuda":
            raise ValueError(f"StepGraph records a CUDA graph: the state must be on a CUDA "
                             f"device, not {device}")
        #: what the graph is recorded for, as ``jax.jit``'s static arguments
        self.key = (cam, cfg, with_planes, with_lines, device)
        self._state = clone_tree(state)
        self._graph = None
        self._out = None
        self._frame = None
        self._draws = None
        self._launches = None
        #: eager steps run before the capture, and the seconds the warm-up and
        #: the capture took
        self.warmup_steps = 0
        self.record_s = 0.0
        #: the stamps of the path's replay, and its buffer's last slots
        #: (:func:`stamp_slots`)
        self.stamp_names = profiling.stamps(with_lines, with_planes)
        self.offset_slot, self.upload_slots = stamp_slots(with_lines, with_planes)
        #: with a recorder at the capture: the replay's stamps (int64 ns on the
        #: card's clock, ``stamp_names`` then the offset and upload slots: 15
        #: with planes on and lines off, 17 with both on, 13 and 15 with planes
        #: off), and the host's ``perf_counter_ns`` before and after the stamp
        #: in the offset slot
        self.stamps = None
        self.clock_bracket = None
        #: the step's live cylinder slots (``profiling.count_cylinders``): the
        #: graph's own tensor, which each replay rewrites
        self.cylinders_live = None

    @property
    def state(self) -> engine.SlamState:
        return self._state

    @state.setter
    def state(self, new: engine.SlamState):
        static, leaves = tensor_leaves(self._state), tensor_leaves(new)
        if len(static) != len(leaves):
            raise ValueError("a state of another configuration")
        for s, n in zip(static, leaves):
            if n is not s:
                if n.shape != s.shape or n.dtype != s.dtype:
                    raise ValueError(f"a state leaf of {n.dtype} {tuple(n.shape)} for "
                                     f"{s.dtype} {tuple(s.shape)}")
                s.copy_(n)
        # the graph draws nothing: the generator is the caller's to swap
        self._state = self._state._replace(generator=new.generator)

    def step(self, gray, depth):
        """One frame: draws from the state's generator, the frame into the
        static buffers, one replay.  Returns (state, StepOutput), both the
        graph's static tensors."""
        with profiling.span("step"):
            if self._graph is None:
                with profiling.span("step.capture"):
                    self._record(gray, depth)
            cam, cfg, _, _, device = self.key
            with profiling.span("step.draws"):
                draws = engine.draw_step_draws(cfg, self._state.generator, device)
                for dst, src in zip(tensor_leaves(self._draws), tensor_leaves(draws)):
                    dst.copy_(src)
            with profiling.span("step.load"):
                self._frame[0].copy_(gray)
                self._frame[1].copy_(depth)
            with profiling.span("step.replay"):
                self._graph.replay()
            nvcc.add_launches(self._launches)
        return self._state, self._out

    def close(self):
        """Free the graph and its memory pool; the state stays readable."""
        if self._graph is not None:
            self._graph.reset()
        self._graph = self._out = self._frame = self._draws = None
        self.cylinders_live = None

    def _record(self, gray, depth):
        t0 = time.perf_counter()
        cam, cfg, with_planes, with_lines, device = self.key
        generator = torch.Generator(device=device)
        generator.set_state(self._state.generator.get_state())
        warm = clone_tree(self._state)._replace(generator=generator)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                draws = engine.draw_step_draws(cfg, generator, device)
                warm, _ = engine.step(warm, gray, depth, cam, cfg, with_planes=with_planes,
                                      with_lines=with_lines, draws=draws)
        torch.cuda.current_stream(device).wait_stream(side)
        self.warmup_steps = WARMUP_STEPS
        del warm
        self._frame = tuple(torch.empty(t.shape, dtype=t.dtype, device=device)
                            for t in (gray, depth))
        self._draws = tree_map(torch.empty_like, draws)
        stamper = None
        if profiling.active() is not None:
            self.stamps = torch.zeros(self.upload_slots[-1] + 1, dtype=torch.int64,
                                      device=device)
            self.clock_bracket = self._read_clocks(device)
            stamper = _Stamper(self.stamps)
        graph = torch.cuda.CUDAGraph()
        with profiling.stamping(stamper), profiling.counting(self):
            self._out, self._launches = capture(graph, lambda: self._commit(*engine.step(
                self._state, *self._frame, cam, cfg, with_planes=with_planes,
                with_lines=with_lines, draws=self._draws)))
        if stamper is not None and tuple(stamper.names) != self.stamp_names:
            raise RuntimeError(f"the step stamped {stamper.names}, not {self.stamp_names}")
        self._graph = graph
        profiling.count("captures")
        self.record_s = time.perf_counter() - t0

    def _read_clocks(self, device):
        """One stamp into the offset slot between two host clock reads, the card
        drained before and after (a first stamp, unread, loads the kernel).
        Returns the host's ``perf_counter_ns`` (before, after); the stamp stays
        in the slot, for the runner's read with the first frame's summary."""
        stamps_cuda.stamp(self.stamps, self.offset_slot)
        torch.cuda.synchronize(device)
        before = time.perf_counter_ns()
        stamps_cuda.stamp(self.stamps, self.offset_slot)
        torch.cuda.synchronize(device)
        return before, time.perf_counter_ns()

    def _commit(self, new_state, out):
        """Inside the capture: copy the new state into the static state buffers
        and return the outputs.  A result that shares memory with a static
        input is copied first, so that no copy reads what another has
        overwritten."""
        static = tensor_leaves(self._state)
        inputs = static + list(self._frame) + tensor_leaves(self._draws)
        storages = {t.untyped_storage().data_ptr() for t in inputs}

        def detached(t):
            return t.clone() if t.untyped_storage().data_ptr() in storages else t

        out = tree_map(detached, out)
        sources = []
        for s, n in zip(static, tensor_leaves(new_state), strict=True):
            if n.shape != s.shape or n.dtype != s.dtype:
                raise RuntimeError(f"the step changed a state leaf from {s.dtype} "
                                   f"{tuple(s.shape)} to {n.dtype} {tuple(n.shape)}")
            sources.append(None if n is s else detached(n))
        for s, n in zip(static, sources):
            if n is not None:
                s.copy_(n)
        profiling.stamp("commit")
        return out


class _Stamper:
    """Inside a capture: each ``profiling.stamp`` records a stamp node that
    writes the next slot of ``stamps``."""

    def __init__(self, stamps):
        self.stamps = stamps
        self.names = []

    def __call__(self, name: str):
        stamps_cuda.stamp(self.stamps, len(self.names))
        self.names.append(name)


def stepper(state: engine.SlamState, cam: CameraIntrinsics, cfg: SlamConfig,
            with_planes: bool = True, with_lines: bool = False):
    """How the runner steps: a :class:`StepGraph` on a card, an
    :class:`EagerStep` on the CPU."""
    cls = StepGraph if state.quat.device.type == "cuda" else EagerStep
    return cls(state, cam, cfg, with_planes=with_planes, with_lines=with_lines)
