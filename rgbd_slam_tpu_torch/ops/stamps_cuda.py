"""The step graph's device stamps: the wrapper of ``csrc/stamps.cu``, a
one-thread kernel that writes the card's ``%globaltimer`` (ns) into one slot of
an int64 buffer on the card.

The kernel is compiled with ``nvcc`` on first use (:mod:`.nvcc`) and bound with
ctypes; it launches on the current stream and reads nothing back, so a CUDA
graph can record it (``step_graph.StepGraph`` does, at ``profiling.stamp``).
CUDA events would not do there: every replay of a graph overwrites them.
"""

from __future__ import annotations

import ctypes

import torch

from . import nvcc


def _bind(lib):
    lib.stamp_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.stamp_launch.restype = ctypes.c_int


LIBRARY = nvcc.Library("stamps.cu", _bind)


def stamp(slots, slot: int):
    """Write the card's clock (ns) into ``slots[slot]`` (``slots``: a contiguous
    int64 tensor on the card) when the work queued before on the current
    stream is done."""
    if slots.device.type != "cuda" or slots.dtype != torch.int64 or not slots.is_contiguous():
        raise ValueError(f"stamps go into a contiguous int64 tensor on a CUDA device, not "
                         f"{slots.dtype} on {slots.device}")
    if not 0 <= slot < slots.numel():
        raise IndexError(f"slot {slot} of {slots.numel()}")
    LIBRARY.build()
    stream = torch.cuda.current_stream(slots.device).cuda_stream
    err = LIBRARY.lib.stamp_launch(slots.data_ptr(), slot, stream)
    if err != 0:
        raise RuntimeError(f"stamp kernel launch failed: cudaError {err}")
