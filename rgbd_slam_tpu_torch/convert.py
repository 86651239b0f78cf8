"""Carry a SLAM state across between the JAX package and this port.

``state_from_numpy`` takes the JAX package's ``SlamState`` with numpy leaves
(``jax.tree.map(np.asarray, state)``) and returns this package's ``SlamState``;
``state_to_numpy`` goes the other way, to this package's ``SlamState`` with numpy
leaves.  Fields are matched by name.  The JAX ``key`` leaf is dropped: the
port's state carries a ``torch.Generator`` seeded with ``seed`` instead.
Descriptors keep their bits: uint32 words in JAX, int32 here.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .engine import SlamState
from .mapping import maps
from .tracking.motion_model import MotionModelState

_NESTED = {"motion": MotionModelState, "points": maps.PointMap,
           "points2d": maps.Point2DMap, "planes": maps.PlaneMap, "lines": maps.LineMap}


def _to_torch(x, device):
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.tensor(a, device=device)   # a copy: JAX's host arrays are read-only


def state_from_numpy(tree, device=None, seed: int = 0) -> SlamState:
    """JAX ``SlamState`` with numpy leaves -> port ``SlamState`` on ``device``
    (``None``: the card, see ``resolve_device``)."""
    device = resolve_device(device)
    fields = {}
    for name in SlamState._fields:
        if name == "generator":
            continue
        x = getattr(tree, name)
        if name in _NESTED:
            cls = _NESTED[name]
            fields[name] = cls(*[_to_torch(getattr(x, f), device) for f in cls._fields])
        elif name == "prev_pyramid":
            fields[name] = tuple(_to_torch(level, device) for level in x)
        else:
            fields[name] = _to_torch(x, device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return SlamState(generator=generator, **fields)


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_to_numpy(v) for v in x])
    return tuple(_to_numpy(v) for v in x)


def state_to_numpy(state: SlamState) -> SlamState:
    """Port ``SlamState`` -> the same structure with numpy leaves and no
    generator; map descriptors come back as uint32 words."""
    fields = {name: _to_numpy(getattr(state, name)) for name in SlamState._fields
              if name != "generator"}
    for name in ("points", "points2d"):
        fields[name] = fields[name]._replace(desc=fields[name].desc.view(np.uint32))
    return SlamState(generator=None, **fields)
