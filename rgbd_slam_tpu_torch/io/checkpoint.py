"""Checkpoint / resume of the full SLAM state (port of
``rgbd_slam_tpu/io/checkpoint.py``).

The whole ``SlamState`` (pose, all feature maps, motion model, tracking
bookkeeping and the random generator's state) round-trips through one ``.npz``
file, so that a resumed sequence repeats the straight run to the last bit.

Leaves are numbered in the order of ``SlamState._fields``, nested maps field by
field and the pyramid level by level, which is the order in which the JAX
package flattens its state; the last leaf here is the generator's state (a
byte vector).  A checkpoint written by the JAX package therefore holds the same
leaves in the same order but for one: its ``key`` leaf (the threefry key, the
last one) has no counterpart, since the port draws from a ``torch.Generator``.
To carry such a file across, rebuild the JAX package's ``SlamState`` from its
leaves with numpy and hand it to ``convert.state_from_numpy``, which drops the
key and seeds a new generator.

A generator's state belongs to its kind of device (a CPU generator's is a
Mersenne twister's, a card's a Philox seed and offset).  Loaded onto the other
kind, the leaves are the same but the draws cannot go on where they stopped: the
new generator is seeded with a checksum of the saved state instead.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from ..device import resolve_device
from ..engine import SlamState


def _flatten(x, leaves):
    """Depth-first leaves of a state: tensors, through named and plain tuples."""
    if isinstance(x, tuple):
        for v in x:
            _flatten(v, leaves)
    else:
        leaves.append(x)
    return leaves


def _unflatten(template, leaves):
    """The structure of ``template`` filled from the iterator ``leaves``."""
    if isinstance(template, tuple):
        items = [_unflatten(v, leaves) for v in template]
        return type(template)(*items) if hasattr(template, "_fields") else tuple(items)
    return next(leaves)


def _leaves(state: SlamState):
    return _flatten(state._replace(generator=()), [])


def save_state(state: SlamState, path: str):
    """Write the state to ``path`` (``.npz``).  The tensors come to the host
    one by one: a checkpoint is rare, and its leaves differ in type."""
    leaves = [t.detach().cpu().numpy() for t in _leaves(state)]
    leaves.append(state.generator.get_state().numpy())
    arrays = {f"leaf_{i}": a for i, a in enumerate(leaves)}
    np.savez_compressed(path, n_leaves=len(leaves), **arrays)


def load_state(path: str, template: SlamState, device=None) -> SlamState:
    """Load a state saved by :func:`save_state`.  ``template`` gives the
    structure (``engine.init_state(cam, cfg)`` with the same configuration);
    the leaves go to ``device``, by default the template's."""
    device = template.position.device if device is None else resolve_device(device)
    with np.load(path) as data:
        n = int(data["n_leaves"])
        n_template = len(_leaves(template)) + 1
        if n != n_template:
            raise ValueError(
                f"checkpoint has {n} leaves, template has {n_template} — "
                "config/capacity mismatch")
        arrays = [data[f"leaf_{i}"] for i in range(n)]
    tensors = iter([torch.from_numpy(a).to(device) for a in arrays[:-1]])
    generator = torch.Generator(device=device)
    if arrays[-1].size == generator.get_state().numel():
        generator.set_state(torch.from_numpy(arrays[-1]))
    else:       # saved on the other kind of device
        generator.manual_seed(zlib.crc32(arrays[-1].tobytes()))
    state = _unflatten(template._replace(generator=()), tensors)
    return state._replace(generator=generator)
