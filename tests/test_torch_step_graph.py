"""The step reads the host nowhere, so that a CUDA graph can record it, and what
runs it as one graph (``rgbd_slam_tpu_torch.step_graph``) keeps the runner's
results.

On the CPU:

* four frames of the plane step at the 160x120 test camera (a refresh frame, a
  frame that detects to top up the tracked set, a frame that skips detection,
  and a blackout frame that is lost at once) run while ``Tensor.item``,
  ``__bool__``, ``__int__``, ``__float__``, ``tolist``, ``cpu`` and ``numpy``
  raise; only the components fixpoint's plain version, which reads the host by
  design (on the card it is a kernel), is let through.  Each step starts from
  the JAX step's input state with the JAX draws injected, and its outputs are
  held to the JAX step's as in ``test_torch_engine.py``;
* ``draw_step_draws`` gives the draws the step takes from its generator;
* ``StepGraph`` raises without a card, and the runner's CPU stepper is the
  eager step;
* the runner over a stepper that, like the graph, overwrites its state and
  outputs in place at every frame gives the eager runner's trajectory,
  callbacks and streamed map to the bit, with the backend on;
* the components kernel's grid limit, and its plain version against the JAX
  loop on a serpentine component, the longest chain of a grid.

The card's side (the kernel, the graph against the eager step, the runner over
the graph, no host sync in a warmed step) is in ``test_torch_cuda.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_slam_tpu import engine as j_engine
from rgbd_slam_tpu.config import DepthNoiseModel
from rgbd_slam_tpu.features import primitives as j_prim
from rgbd_slam_tpu.synthetic import RoomScene, orbit_trajectory
from rgbd_slam_tpu_torch import convert, engine, runner, step_graph
from rgbd_slam_tpu_torch.ops import components_cuda
from test_torch_engine import (CAM, CFG, DISCRETE_OUT, T_CAM, T_CFG, _jax_step,
                               _port_config, assert_pose_close, jax_step_draws)

torch.set_num_threads(2)

#: detection skips a frame that tracked this many points (and is no refresh
#: frame): the third frame; one failed frame loses tracking
GUARD_CFG = dataclasses.replace(
    CFG, detection=dataclasses.replace(CFG.detection, max_point_per_frame=12),
    engine=dataclasses.replace(CFG.engine, max_failed_tracking=0))
#: what each of the four frames is there for
GUARD_FRAMES = ("refresh", "tops_up", "skips_detection", "lost")

_HOST_READS = ("item", "__bool__", "__int__", "__float__", "tolist", "cpu", "numpy")


@pytest.fixture(scope="module")
def guarded():
    """[(jax out, port out, port state)] of the four frames, the port's steps run
    under the host-read guard."""
    scene = RoomScene(CAM, depth_noise=DepthNoiseModel())
    poses = orbit_trajectory(3, speed_mm=6.0)
    dark = (np.full((CAM.height, CAM.width), 128.0, np.float32),
            np.zeros((CAM.height, CAM.width), np.float32))
    frames = [scene.render(q, p) for q, p in poses] + [dark]
    t_cfg = _port_config(GUARD_CFG)
    plain = components_cuda.components_reference
    allowed = [False]
    reads = []

    def components_let_through(*args, **kw):
        allowed[0] = True
        try:
            return plain(*args, **kw)
        finally:
            allowed[0] = False

    def guard(name, real):
        def read(self, *args, **kw):
            if not allowed[0]:
                reads.append(name)
                raise RuntimeError(f"the step read the host: Tensor.{name}")
            return real(self, *args, **kw)
        return read

    results = []
    j_state = j_engine.init_state(CAM, GUARD_CFG, seed=0)
    with pytest.MonkeyPatch.context() as mp:
        for gray, depth in frames:
            t_state = convert.state_from_numpy(jax.tree.map(np.asarray, j_state),
                                               device="cpu")
            draws = jax_step_draws(j_state.key, GUARD_CFG)
            j_new, j_out = _jax_step(j_state, jnp.asarray(gray), jnp.asarray(depth), CAM,
                                     GUARD_CFG, with_planes=True)
            gray_t, depth_t = torch.from_numpy(gray), torch.from_numpy(depth)
            mp.setattr(components_cuda, "components_reference", components_let_through)
            for name in _HOST_READS:
                mp.setattr(torch.Tensor, name, guard(name, getattr(torch.Tensor, name)))
            try:
                t_new, t_out = engine.step(t_state, gray_t, depth_t, T_CAM, t_cfg,
                                           with_planes=True, draws=draws)
            finally:
                mp.undo()
            results.append((j_out, t_out, t_new))
            j_state = j_new
    assert not reads, reads
    return results


def test_guarded_frames_are_what_they_stand_for(guarded):
    """Detection ran on frames 0 and 1 and was skipped on frame 2, whose
    tracked set came in full; frame 3 is lost; every other frame tracks."""
    tracked_in = [int(t_state.tracked_ok.sum()) for _, _, t_state in guarded][:-1]
    n_detected = [int(t_out.n_detected) for _, t_out, _ in guarded]
    assert n_detected[0] > 0 and n_detected[1] > 0 and n_detected[2] == 0, n_detected
    assert tracked_in[0] < 12 <= tracked_in[1], tracked_in
    assert [bool(t_out.is_lost) for _, t_out, _ in guarded] == [False, False, False, True]
    assert [bool(t_out.success) for _, t_out, _ in guarded] == [True, True, True, False]


@pytest.mark.parametrize("frame", GUARD_FRAMES)
def test_guarded_step_matches_jax(guarded, frame):
    """The step run without a host read gives the JAX step's outputs: discrete
    fields equal, the pose within the bound of ``test_torch_engine.py``."""
    j_out, t_out, _ = guarded[GUARD_FRAMES.index(frame)]
    for name in DISCRETE_OUT:
        np.testing.assert_array_equal(getattr(t_out, name).numpy(),
                                      np.asarray(getattr(j_out, name)), err_msg=name)
    assert_pose_close(t_out, j_out)


def _orbit_frames(n):
    scene = RoomScene(CAM, depth_noise=DepthNoiseModel())
    return [tuple(torch.from_numpy(a) for a in scene.render(q, p))
            for q, p in orbit_trajectory(n, speed_mm=6.0)]


def _assert_trees_equal(a, b):
    for x, y in zip(step_graph.tensor_leaves(a), step_graph.tensor_leaves(b), strict=True):
        assert torch.equal(x.nan_to_num(), y.nan_to_num())


def test_draw_step_draws_are_the_steps_own():
    """A step that draws from its generator and one handed ``draw_step_draws``
    of a copy of that generator are the same to the bit."""
    (gray, depth), = _orbit_frames(1)
    state = engine.init_state(T_CAM, T_CFG, seed=5, device="cpu")
    twin = torch.Generator().manual_seed(5)
    new, out = engine.step(state, gray, depth, T_CAM, T_CFG, with_planes=False)
    draws = engine.draw_step_draws(T_CFG, twin)
    state_b = engine.init_state(T_CAM, T_CFG, seed=9, device="cpu")
    new_b, out_b = engine.step(state_b, gray, depth, T_CAM, T_CFG, with_planes=False,
                               draws=draws)
    _assert_trees_equal(out, out_b)
    _assert_trees_equal(new, new_b)
    assert torch.equal(state.generator.get_state(), twin.get_state())


def test_step_graph_raises_on_the_cpu():
    state = engine.init_state(T_CAM, T_CFG, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        step_graph.StepGraph(state, T_CAM, T_CFG)


def test_the_cpu_stepper_is_the_eager_step():
    frames = _orbit_frames(2)
    state = engine.init_state(T_CAM, T_CFG, device="cpu")
    stepper = step_graph.stepper(state, T_CAM, T_CFG, with_planes=False)
    assert isinstance(stepper, step_graph.EagerStep) and stepper.warmup_steps == 0
    ref = engine.init_state(T_CAM, T_CFG, device="cpu")
    for gray, depth in frames:
        got_state, got_out = stepper.step(gray, depth)
        ref, ref_out = engine.step(ref, gray, depth, T_CAM, T_CFG, with_planes=False)
        _assert_trees_equal(got_out, ref_out)
    _assert_trees_equal(stepper.state, ref)


class InPlaceStep:
    """The eager step behind a graph's contract: one state and one set of
    outputs, overwritten in place at every frame."""

    reuses_outputs = True
    warmup_steps = 0

    def __init__(self, state, cam, cfg, with_planes=True, with_lines=False):
        self._state = step_graph.clone_tree(state)
        self._args = (cam, cfg, with_planes, with_lines)
        self._out = None

    @property
    def state(self):
        return self._state

    @state.setter
    def state(self, new):
        for s, n in zip(step_graph.tensor_leaves(self._state), step_graph.tensor_leaves(new)):
            if n is not s:
                s.copy_(n)

    def step(self, gray, depth):
        cam, cfg, with_planes, with_lines = self._args
        new, out = engine.step(step_graph.clone_tree(self._state), gray, depth, cam, cfg,
                               with_planes=with_planes, with_lines=with_lines)
        self.state = new
        if self._out is None:
            self._out = step_graph.clone_tree(out)
        for s, n in zip(step_graph.tensor_leaves(self._out), step_graph.tensor_leaves(out)):
            s.copy_(n)
        return self._state, self._out

    def close(self):
        pass


def test_runner_over_reused_buffers_keeps_its_results(monkeypatch, tmp_path):
    """The runner keeps a frame's summary, keyframe record, state and outputs
    for up to a batch of 8 frames; a stepper that overwrites them at every
    frame gives the eager runner's trajectory, callbacks, counts and streamed
    map to the bit, with the backend (refines, pose graph, landmark write-back)
    on."""
    scene = RoomScene(CAM, depth_noise=DepthNoiseModel())
    frames = [scene.render(q, p) for q, p in orbit_trajectory(20, speed_mm=8.0)]

    def run(tag):
        seen = []

        def on_frame(i, state, out, dt):
            seen.append((i, int(state.frame_idx), out.position.clone(),
                         int(out.n_points_alive), state.points.pos.clone()))

        path = str(tmp_path / f"{tag}.obj")
        state, traj, stats = runner.run_frames(frames, T_CAM, T_CFG, with_planes=False,
                                               ba_every=8, on_frame=on_frame,
                                               export_map=path, device="cpu")
        with open(path) as f:
            return state, traj, stats, seen, f.read()

    eager = run("eager")
    monkeypatch.setattr(step_graph, "stepper", InPlaceStep)
    reused = run("reused")
    assert eager[2].ba_accepted >= 1 and eager[2].map_streamed >= 0
    np.testing.assert_array_equal(eager[1].positions_array(), reused[1].positions_array())
    np.testing.assert_array_equal(np.array(eager[1].quaternions),
                                  np.array(reused[1].quaternions))
    for key in ("keyframe_count", "ba_runs", "ba_accepted", "map_streamed",
                "map_alive_at_end", "success_count"):
        assert getattr(eager[2], key) == getattr(reused[2], key), key
    assert [s[:2] + (s[3],) for s in eager[3]] == [s[:2] + (s[3],) for s in reused[3]]
    assert [s[1] for s in eager[3]] == list(range(1, 21))
    for a, b in zip(eager[3], reused[3]):
        assert torch.equal(a[2], b[2]) and torch.equal(a[4], b[4])
    assert eager[4] == reused[4]
    _assert_trees_equal(eager[0], reused[0])


def test_components_kernel_takes_any_grid_that_fits():
    """The grid limit is one CTA's shared memory: ``SMEM_BYTES_PER_CELL`` a
    cell (its int32 label and its uint16 flags)."""
    components_cuda.check_grid(24, 32)
    components_cuda.check_grid(1, 1)
    cells = components_cuda.MAX_SMEM_BYTES // components_cuda.SMEM_BYTES_PER_CELL
    components_cuda.check_grid(1, cells)
    with pytest.raises(ValueError, match="shared memory"):
        components_cuda.check_grid(1, cells + 1)
    with pytest.raises(ValueError, match="shared memory"):
        components_cuda.check_grid(480, 640)
    with pytest.raises(ValueError, match="empty"):
        components_cuda.check_grid(0, 32)


def serpentine(gh, gw):
    """Directed edges [4, gh, gw] and planar mask [C] of one component that
    snakes through the grid a row at a time: the longest chain a grid holds."""
    edges = np.zeros((4, gh, gw), bool)
    edges[0, :, 1:] = True                      # every row joined left to right
    for y in range(gh - 1):
        x = gw - 1 if y % 2 == 0 else 0         # the turn at alternate ends
        edges[2, y + 1, x] = True
    return edges, np.ones(gh * gw, bool)


@pytest.mark.parametrize("shape", [(24, 32), (7, 5), (1, 40)], ids=["32x24", "5x7", "40x1"])
def test_components_plain_version_matches_jax_on_a_serpentine(shape):
    gh, gw = shape
    edges, planar = serpentine(gh, gw)
    planar[3] = False                           # a gap splits the snake in two
    want = np.asarray(j_prim._connected_components(jnp.asarray(edges), jnp.asarray(planar),
                                                   gh, gw))
    got = components_cuda.components_reference(torch.from_numpy(edges),
                                               torch.from_numpy(planar), gh, gw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want[planar])) == 2
    work = components_cuda.components_work(torch.from_numpy(edges),
                                           torch.from_numpy(planar), gh, gw)
    assert work["planar_cells"] == gh * gw - 1 and work["rounds"] >= 2
