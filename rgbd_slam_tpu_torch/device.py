"""The port's default device: the card.

Every function of the package that makes tensors from nothing takes
``device=None``, which means the CUDA card; without one it raises rather than
move quietly to the CPU.  Callers that want the CPU (the parity tests) say
``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is the card, and raises when
    there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this package runs on the card by default; pass "
            "device=\"cpu\" to run on the CPU")
    return torch.device("cuda")
