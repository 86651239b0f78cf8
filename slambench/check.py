"""Whether what the timed path produced is correct: its answers against the
plain reference (:mod:`slambench.reference.plain`, a frozen copy of the port's
plain path that imports nothing of the port).

The reference follows the program step by step.  It runs its own copy of
``runner.run_frames`` over the benchmark's frames with a stepper
(:class:`Follow`) that, at each frame, starts from the state the program's
first timed sequence reached after the frame before (as ``on_frame`` handed it
over, with whatever the reference's own backend wrote into it since), and:

* at the checked frames (frame 0 from the reference's own initial state, and
  the others drawn from the seed) computes the step itself, with the draws of
  its own generator seeded as the program's, and compares every leaf of the
  new state (pose, pose covariance, motion model, point, 2D-point, plane and
  line maps, tracked rows, counters) and of the step's outputs with the
  program's;
* at the other frames takes the program's step as it stands.

Its backend (keyframes, windowed BA, pose graph, the landmark write-back) is
computed by the reference throughout, so the trajectory it returns holds the
reference's refined and graph-solved poses.  Every timed sequence's
trajectory and counts are then compared with it.  In the ``tum_files`` mix the
frames the program decoded are compared with what the written files hold.

Numbers (each with a limit in ``slambench/limits/<cell>.json``): those of
:func:`compare_sequences`, and in the ``tum_files`` mix ``frame_gap``, the
largest difference between a decoded gray or depth value and the file's.  A
plane's gap is its distance gap plus 1,000 mm times its normals' gap.  The
step gaps are medians over the checked steps, and ``steps_off`` counts the
checked steps on which any leaf lies past its limit: the kernels and the plain
versions round differently, and now and then that moves a RANSAC inlier and
with it one step's pose and map rows, where products in TF32 (the control)
move every step's; a fault on every step moves the medians, and one on a few
steps the count.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch


@contextlib.contextmanager
def tf32_off():
    """f32 products, as the configuration states, whatever the caller set."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def checked_frames(seed: int, n_frames: int, count: int, period: int = 8) -> list[int]:
    """Frame 0 and ``count - 1`` frames drawn from the seed: a third of the
    ``count`` just past a summary batch (frame % ``period`` == 1, where the
    backend's write-back lands, so that a fault there alone is more steps than
    ``steps_off``'s limit lets through), the rest among the others."""
    rng = np.random.default_rng([seed % 2 ** 64, 11])
    after = [i for i in range(1, n_frames) if i % period == 1]
    other = [i for i in range(1, n_frames) if i % period != 1]
    n_after = min(len(after), count // 3)
    n_other = min(len(other), count - 1 - n_after)
    picked = {0, *rng.choice(after, n_after, replace=False).tolist(),
              *rng.choice(other, n_other, replace=False).tolist()}
    return sorted(picked)


def build_dataclass(cls, values: dict):
    """An instance of the dataclass ``cls`` with ``values`` (nested dicts for
    nested dataclasses, lists for tuples); raises on a key it lacks or
    leaves out."""
    default = cls()
    names = {f.name for f in dataclasses.fields(cls)}
    if set(values) != names:
        raise ValueError(f"{cls.__name__}: keys {sorted(set(values) ^ names)} differ")
    kw = {}
    for name, value in values.items():
        current = getattr(default, name)
        if dataclasses.is_dataclass(current):
            value = build_dataclass(type(current), value)
        elif isinstance(current, tuple):
            value = tuple(value)
        kw[name] = value
    return dataclasses.replace(default, **kw)


def retype(src, like):
    """``src``, a tree of named tuples of the program's, as the reference's
    named tuples of ``like``; leaves are kept."""
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*[retype(getattr(src, f), getattr(like, f)) for f in like._fields])
    if isinstance(like, (tuple, list)):
        return type(like)(retype(s, x) for s, x in zip(src, like, strict=True))
    return src


#: a leaf whose shapes differ reads this gap, the most a relative gap reaches
SHAPE_GAP = 2.0
#: the least limit a leaf's gap is divided by: a leaf with the limit 0 is
#: compared exactly, and any gap there reads far past 1
LEAF_LIMIT_FLOOR = 1e-12


def tensor_leaves(tree, prefix: str):
    """(name, tensor) of every tensor of a tree of named tuples, tuples and
    lists, named by its path (``state.points.pos``); other leaves (the
    state's generator, a None) are passed over."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for field in tree._fields:
            yield from tensor_leaves(getattr(tree, field), f"{prefix}.{field}")
    elif isinstance(tree, (tuple, list)):
        for k, x in enumerate(tree):
            yield from tensor_leaves(x, f"{prefix}.{k}")


def leaf_gap(prog, ref) -> float:
    """The gap of one leaf of the program's from the reference's.  Floats: the
    largest difference over the elements finite in both, over the largest
    magnitude of either there, and at least the share of elements finite in one
    only; integers and flags: the share of elements that differ; a leaf the
    program lacks or shapes otherwise: ``SHAPE_GAP``."""
    if prog is None or tuple(prog.shape) != tuple(ref.shape):
        return SHAPE_GAP
    if ref.numel() == 0:
        return 0.0
    prog = prog.to(ref.device)
    if not ref.is_floating_point():
        return float((prog != ref).to(torch.float64).mean())
    a, b = prog.to(torch.float64), ref.to(torch.float64)
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    both = fa & fb
    zero = torch.zeros((), dtype=torch.float64, device=b.device)
    diff = torch.where(both, (a - b).abs(), zero).max()
    scale = torch.maximum(torch.where(both, a.abs(), zero).max(),
                          torch.where(both, b.abs(), zero).max())
    rel = torch.where(scale > 0, diff / torch.where(scale > 0, scale, 1.0), zero)
    return float(torch.maximum(rel, (fa != fb).to(torch.float64).mean()))


def leaf_ratios(gaps: dict, limits: dict) -> dict:
    """Each leaf's gap over its limit (``limits`` {leaf: limit}; a leaf it
    does not name has the limit 0, and is compared exactly)."""
    return {name: gap / max(limits.get(name, 0.0), LEAF_LIMIT_FLOOR)
            for name, gap in gaps.items()}


def rotation_gap_deg(q1, q2) -> float:
    """The angle of the rotation between two orientations (quaternions,
    normalised here), degrees: 4 asin(chord / 2) of the nearer of ``q2`` and
    ``-q2``, which stays exact for small angles where 2 acos(|q1 . q2|)
    does not."""
    a = np.asarray(q1, np.float64)
    b = np.asarray(q2, np.float64)
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    if np.dot(a, b) < 0:
        b = -b
    return math.degrees(4.0 * math.asin(min(float(np.linalg.norm(a - b)) / 2.0, 1.0)))


class Follow:
    """The reference runner's stepper (``make_stepper``): see the module's
    docstring.  ``program`` is [(state, out)] of the program's first timed
    sequence; ``generator`` draws as the program's does."""

    reuses_outputs = False
    warmup_steps = 0

    def __init__(self, state, cam, cfg, with_planes=True, with_lines=False, *, ref, program,
                 checked, generator, found):
        self.state = state
        self.ref = ref
        self.program = program
        self.checked = set(checked)
        self.generator = generator
        self.found = found
        self.args = (cam, cfg, with_planes, with_lines)
        self.i = 0

    def step(self, gray, depth):
        cam, cfg, with_planes, with_lines = self.args
        i = self.i
        self.i += 1
        draws = self.ref.engine.draw_step_draws(cfg, self.generator, gray.device)
        own_state = self.state
        prog_state, prog_out = (retype(x, like) for x, like in
                                zip(self.program[i], (own_state, _out_like(self.ref))))
        prog_state = prog_state._replace(generator=own_state.generator)
        if i in self.checked:
            new_state, out = self.ref.engine.step(own_state, gray, depth, cam, cfg,
                                                  with_planes=with_planes,
                                                  with_lines=with_lines, draws=draws)
            self.found.compare_step(i, self.ref, new_state, out, prog_state, prog_out)
        else:
            new_state, out = prog_state, prog_out
        self.state = prog_state
        return new_state, out

    def close(self):
        pass


def _out_like(ref):
    n = len(ref.engine.StepOutput._fields)
    return ref.engine.StepOutput(*([None] * n))


@dataclasses.dataclass
class Found:
    """What the checked steps showed."""
    flag_mismatches: int = 0
    #: checked steps after which a plane is live in one map only
    plane_live_mismatches: int = 0
    #: (frame, position gap mm, rotation gap deg, plane gap mm or None) of
    #: each checked step
    steps: list = dataclasses.field(default_factory=list)
    #: {leaf: gap} of each checked step, for every leaf of the new state
    #: (``state.*``) and of the step's outputs (``out.*``)
    leaves: list = dataclasses.field(default_factory=list)
    #: of each sequence compared: (frame of its largest gap off the checked
    #: steps, that gap mm, its largest distance from the first sequence mm)
    sequences: list = dataclasses.field(default_factory=list)

    def compare_step(self, i, ref, state, out, prog_state, prog_out):
        f64 = torch.float64
        pos = float(torch.linalg.vector_norm(out.position.to(f64) - prog_out.position.to(f64)))
        rot = rotation_gap_deg(out.quat.cpu().numpy(), prog_out.quat.cpu().numpy())
        self.flag_mismatches += int(bool(out.success) != bool(prog_out.success))
        self.flag_mismatches += int(bool(out.is_lost) != bool(prog_out.is_lost))
        # the state's own counter: a step that leaves its state as it was shows here
        self.flag_mismatches += int(int(state.frame_idx) != int(prog_state.frame_idx))
        live = ref.mapping.maps.alive(state.planes).cpu()
        prog_live = ref.mapping.maps.alive(prog_state.planes).cpu()
        self.plane_live_mismatches += int(bool((live != prog_live).any()))
        both = (live & prog_live).to(state.planes.params.device)
        plane = None
        if bool(both.any()):
            a = state.planes.params[both].to(f64)
            b = prog_state.planes.params[both].to(f64)
            gap = (a[:, 3] - b[:, 3]).abs() + 1000.0 * torch.linalg.vector_norm(
                a[:, :3] - b[:, :3], dim=-1)
            plane = float(gap.max())
        self.steps.append((i, pos, rot, plane))
        prog = dict(tensor_leaves(prog_state, "state"))
        prog.update(tensor_leaves(prog_out, "out"))
        ref_leaves = [*tensor_leaves(state, "state"), *tensor_leaves(out, "out")]
        self.leaves.append({name: leaf_gap(prog.get(name), t) for name, t in ref_leaves})

    @property
    def steps_checked(self) -> int:
        return len(self.steps)


def run_reference(frames, cam_values: dict, cfg_values: dict, run_kw: dict, seed: int,
                  checked, program, device):
    """The reference's run over ``frames`` [(gray, depth) numpy] following
    ``program`` [(state, out)].  Returns (Trajectory, RunStats, Found)."""
    from .reference import plain as ref
    from .reference.plain import config as ref_config
    from .reference.plain import engine as ref_engine  # noqa: F401
    from .reference.plain import runner as ref_runner
    from .reference.plain.mapping import maps as ref_maps  # noqa: F401

    cam = ref_config.CameraIntrinsics(**cam_values)
    cfg = build_dataclass(ref_config.SlamConfig, cfg_values)
    found = Found()
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)

    def make_stepper(state, cam_, cfg_, with_planes=True, with_lines=False):
        return Follow(state, cam_, cfg_, with_planes, with_lines, ref=ref, program=program,
                      checked=checked, generator=generator, found=found)

    staged = [(torch.as_tensor(g, device=device), torch.as_tensor(d, device=device))
              for g, d in frames]
    with tf32_off():
        _, traj, stats = ref_runner.run_frames(staged, cam, cfg, seed=seed, device=device,
                                               make_stepper=make_stepper, **run_kw)
    return traj, stats, found


def compare_sequences(sequences, ref_traj, ref_stats, found: Found, checked,
                      leaf_limits: dict) -> dict:
    """The numbers of the check.  ``sequences`` [(Trajectory, RunStats)] are
    the timed sequences of the realisation the reference followed;
    ``leaf_limits`` {leaf: limit} is the cell's limit of each leaf's gap
    (:func:`leaf_gap`).

    * ``step_gap_mm``, ``step_rot_gap_deg``, ``plane_gap_mm``: the median over
      the checked steps of the step's position gap, orientation gap, and
      largest gap of a live plane (over the steps with live planes);
    * ``leaf_gap``: over every leaf of the new state and the outputs, the
      largest median over the checked steps of the leaf's gap over its limit
      (1 at the limit);
    * ``steps_off``: the checked steps on which some leaf's gap lies past its
      limit;
    * ``traj_gap_mm``: the largest position gap between a sequence's
      trajectory and the reference's at the frames that are not checked steps,
      where the reference took the program's step: what the backend's refines
      and graph solves changed, and whether every sequence repeats the first;
    * ``flag_mismatches``: checked steps whose success or lost flag, or whose
      new state's frame counter, differs from the reference's, and sequences
      whose counts of tracked and lost frames differ from the reference's;
    * ``plane_live_mismatches``: checked steps after which a plane is live in
      one map only (a plane's promotion or loss at its threshold can go
      either way on a rounding, so it is shown and, where the cell's limits
      file leaves it out, not compared)."""
    ref_pos = ref_traj.positions_array()
    off = np.ones(len(ref_pos), bool)
    off[[i for i in checked if i < len(off)]] = False
    flags = found.flag_mismatches
    traj_gap = 0.0
    first = sequences[0][0].positions_array()
    for traj, stats in sequences:
        pos = traj.positions_array()
        if pos.shape != ref_pos.shape:
            flags += 1
            continue
        gaps = np.where(off, np.linalg.norm(pos - ref_pos, axis=1), 0.0)
        traj_gap = max(traj_gap, float(gaps.max()))
        flags += int(stats.success_count != ref_stats.success_count)
        flags += int(stats.lost_count != ref_stats.lost_count)
        found.sequences.append((int(gaps.argmax()), float(gaps.max()),
                                float(np.linalg.norm(pos - first, axis=1).max())))
    planes = [p for *_, p in found.steps if p is not None]
    ratios = [leaf_ratios(gaps, leaf_limits) for gaps in found.leaves]
    medians = {name: float(np.median([r[name] for r in ratios])) for name in ratios[0]}
    return {"step_gap_mm": float(np.median([s[1] for s in found.steps])),
            "step_rot_gap_deg": float(np.median([s[2] for s in found.steps])),
            "plane_gap_mm": float(np.median(planes)) if planes else 0.0,
            "leaf_gap": max(medians.values()),
            "steps_off": sum(max(r.values()) > 1.0 for r in ratios),
            "traj_gap_mm": traj_gap, "flag_mismatches": flags,
            "plane_live_mismatches": found.plane_live_mismatches}


def worst_leaves(found: Found, leaf_limits: dict, count: int = 3) -> list:
    """Of each checked step, its frame and the ``count`` leaves that lie
    farthest past their limits, with their gaps over their limits."""
    out = []
    for (frame, *_), gaps in zip(found.steps, found.leaves):
        ratios = leaf_ratios(gaps, leaf_limits)
        top = sorted(ratios.items(), key=lambda kv: -kv[1])[:count]
        out.append([frame, [[name, float(f"{r:.4g}")] for name, r in top]])
    return out


def frame_gap(decoded: dict, expected) -> float:
    """The largest difference between a decoded frame ({index: (gray,
    depth)}) and what its files hold."""
    gap = 0.0
    for i, (gray, depth) in decoded.items():
        eg, ed = expected[i]
        gap = max(gap, float(np.abs(np.asarray(gray, np.float64) - eg).max()),
                  float(np.abs(np.asarray(depth, np.float64) - ed).max()))
    return gap


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each number of the cell's limits file beside its limit, and whether
    all are within them; a number the file does not hold is shown with no
    limit and not compared.  A number the file holds and the run did not
    produce fails.  The file's ``leaves`` are the leaves' limits, which
    ``leaf_gap`` and ``steps_off`` read (:func:`compare_sequences`)."""
    shown = {}
    ok = bool(limits)
    for name, entry in limits.items():
        if name == "leaves":
            continue
        value = numbers.get(name)
        shown[name] = {"value": value, "limit": entry["limit"]}
        ok = ok and value is not None and value <= entry["limit"]
    for name, value in numbers.items():
        if name not in limits:
            shown[name] = {"value": value, "limit": None}
    return ok, shown
