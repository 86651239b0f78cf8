"""The benchmark's files for the points + lines deployment, with no card: the
configuration ``fr1_lines``, the traffic ``stripe_wall``, the cell
``fr1_lines.stripe_wall``'s limits, the four per-layer metrics that read the
line path, and ``slambench/lines_work.py``'s count of the line tiles' work
against the products the program runs.

This file imports no JAX.
"""

import json
import math
import os
import sys
import types

import pytest
import torch
from torch.overrides import TorchFunctionMode

from rgbd_slam_tpu_torch import config, engine, profiling, runner
from rgbd_slam_tpu_torch.features import lines as lines_mod
from rgbd_slam_tpu_torch.synthetic import StripeWallScene, lateral_trajectory

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from slambench import check, lines_work, measure, registry, traffic  # noqa: E402

torch.set_num_threads(2)

CELL = "fr1_lines.stripe_wall"
READERS = ("graph_line_tiles_us", "graph_lines_us", "line_tiles_roofline",
           "line_matches_per_frame")


@pytest.fixture(scope="module")
def bench():
    return registry.Benchmark(registry.ROOT)


def test_the_configuration_builds_with_lines_on_and_planes_off(bench):
    conf = bench.config("fr1_lines")
    cfg = check.build_dataclass(config.SlamConfig, conf["slam_config"])
    assert cfg == config.SlamConfig()
    assert config.CameraIntrinsics(**{k: v for k, v in conf["camera"].items()
                                      if k != "rate_hz"}) == config.TUM_FR1
    assert conf["with_lines"] is True and conf["with_planes"] is False
    assert conf["backend"] is None and conf["sequence_frames"] == 120
    # the rest of the deployment is fr1_vo's, as it is run
    vo = bench.config("fr1_vo")
    assert conf["camera"] == vo["camera"] and conf["slam_config"] == vo["slam_config"]


def test_the_mix_is_the_low_texture_wall(bench):
    mix = bench.traffic("stripe_wall")
    traffic.check_mix(mix)
    assert mix["scene"] == "StripeWallScene" and mix["trajectory"] == "lateral"
    assert mix["scene_args"] == {"texture_scale": 0.03, "stripe_period_z": 2400.0}
    assert mix["trajectory_args"] == {"speed_mm": 4.0}
    room = bench.traffic("room")
    for key in ("depth_noise", "delivery", "warmup_frames", "checked_frames", "realizations"):
        assert mix[key] == room[key], key


def test_the_cell_and_its_metrics_are_the_only_entries_it_adds(bench):
    cell = bench.workload(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("fr1_lines", "stripe_wall", 1)
    layer = {m["name"]: m for m in bench.per_layer(CELL)}
    assert set(READERS) < set(layer)
    assert all(layer[name]["workloads"] == [CELL] for name in READERS)
    # the step-level metrics of the older cells read this cell too: the cell
    # appended after the cells before it to their lists (later cells follow
    # it), the rest of each entry as it was
    older = set(layer) - set(READERS)
    assert older == {"capture_ms", "host_syncs_per_frame", "step_device_us", "step_kernels",
                     "device_idle_pct", "graph_span_us", "replay_gap_us",
                     *(f"graph_{s}_us" for s in profiling.STAGES if s != "plane_extract")}
    before = {"fr1_vo.room", "fr1_slam.room", "fr1_vo.tum_files"}
    for name in older:
        cells = layer[name]["workloads"]
        assert cells.count(CELL) == 1 and set(cells[:cells.index(CELL)]) <= before, name
    assert layer["line_matches_per_frame"]["moves"] == "ate_mm"
    assert {m["name"] for m in bench.end_to_end(CELL)} == {"fps", "frame_latency_p95_ms",
                                                           "ate_mm", "setup_s"}
    # one of the cell's readers asks for the profiled part, whose breakdown a
    # traced run's result line carries
    assert any("profile" in r.NEEDS for r in bench.readers(CELL).values())


def test_the_limits_hold_every_leaf_of_a_lines_on_step(bench):
    cam = config.CameraIntrinsics(width=160, height=120, fx=130.0, fy=130.0, cx=80.0, cy=60.0)
    cfg = config.SlamConfig()
    scene = StripeWallScene(cam, texture_scale=0.03, stripe_period_z=2400.0)
    gray, depth = scene.render(*lateral_trajectory(1)[0])
    state = engine.init_state(cam, cfg, seed=0, device="cpu")
    state, out = engine.step(state, torch.as_tensor(gray), torch.as_tensor(depth), cam, cfg,
                             with_planes=False, with_lines=True)
    names = {n for n, _ in [*check.tensor_leaves(state, "state"),
                            *check.tensor_leaves(out, "out")]}
    limits = bench.limits(CELL)
    leaves = limits.pop("leaves")
    assert set(leaves) == names
    assert all(v >= 0 for v in leaves.values())
    # the line map's leaves are compared like every other leaf
    assert {n for n in names if n.startswith("state.lines.")} <= set(leaves)
    # each limit lies above the program's largest reading, and the control
    # (TF32 products) lies past at least one of them
    numbers = ("step_gap_mm", "step_rot_gap_deg", "leaf_gap", "steps_off", "flag_mismatches")
    assert set(limits) == set(numbers)
    assert all(limits[n]["lower"] <= limits[n]["limit"] for n in numbers)
    assert any(limits[n]["limit"] < limits[n]["upper"] for n in numbers)


def _run(stats_list, frame_hw=(480, 640)):
    return types.SimpleNamespace(
        sequences=[types.SimpleNamespace(stats=s) for s in stats_list], frame_hw=frame_hw)


def _line_stats(k):
    """A lines-on sequence's ``RunStats`` with sums that name its index ``k``."""
    stages = {s: 9 * 10.0 for s in profiling.stages(True)}
    stages.update(line_tiles=9 * (1000.0 + k), lines=9 * (300.0 + k))
    return runner.RunStats(frame_count=10, stamped_frames=9, stage_device_us=stages,
                           graph_span_us=sum(stages.values()), lines_detected=200,
                           line_matches=10 * (8 + k), lines_alive=12)


def test_the_readers_read_the_unprofiled_sequences():
    """Sequences 1 and 2 ran under the profiler and are left out: sequences 0,
    3 and 4 are read, whose k average to 7/3."""
    run = _run([_line_stats(k) for k in (0, 500, 900, 3, 4)])
    read = {name: registry.load_reader(registry.ROOT, name).read(run) for name in READERS}
    assert read["graph_line_tiles_us"] == pytest.approx(1000.0 + 7.0 / 3.0)
    assert read["graph_lines_us"] == pytest.approx(300.0 + 7.0 / 3.0)
    assert read["line_matches_per_frame"] == pytest.approx(8.0 + 7.0 / 3.0)
    least_s, bound = measure.least_time_s(lines_work.line_tiles_work(480, 640))
    assert bound == "bytes"
    assert read["line_tiles_roofline"] == pytest.approx(
        100.0 * least_s / (1e-6 * (1000.0 + 7.0 / 3.0)))


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_nothing_where_the_program_records_nothing(name):
    """A program whose ``RunStats`` lacks the line sections and counts (the
    tree before them), or a run with lines off: None, and no raise."""
    reader = registry.load_reader(registry.ROOT, name)
    bare = types.SimpleNamespace(frame_count=10, stamped_frames=9,
                                 stage_device_us={s: 90.0 for s in profiling.STAGES})
    assert reader.read(_run([bare] * 4)) is None
    if name != "line_matches_per_frame":
        # lines off: the count is there, the sections are not
        lines_off = runner.RunStats(frame_count=10, stamped_frames=9,
                                    stage_device_us={s: 90.0 for s in profiling.STAGES})
        assert reader.read(_run([lines_off] * 4)) is None
    assert reader.read(_run([])) is None


class _Products(TorchFunctionMode):
    """Records the shapes of every matrix product until the ``line_tiles``
    stamp."""

    PRODUCTS = {"__matmul__", "matmul", "mm", "bmm", "einsum", "tensordot"}

    def __init__(self):
        super().__init__()
        self.shapes = []
        self.open = True

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if self.open and getattr(func, "__name__", "") in self.PRODUCTS:
            self.shapes.append(tuple(tuple(a.shape) for a in args
                                     if isinstance(a, torch.Tensor)))
        return func(*args, **(kwargs or {}))

    def stamp(self, name):
        if name == "line_tiles":
            self.open = False


def test_lines_work_counts_the_products_the_section_runs():
    """``detect_lines`` at 480x640, its matrix products counted from its start
    to its ``line_tiles`` stamp: every one is of two T x T matrices, the reach
    closure over ``line_tiles_work``'s T = 1,200 tiles.  The work counts what
    that closure needs, not the program's 11 dense products: a search of the
    8-neighbour tile graph (``EDGES`` T^2 operations) and the closure written
    once, so that bytes bound it (2.72 MB, 0.81 us), a floor that a faster
    closure can approach but not pass."""
    cam = config.TUM_FR1
    scene = StripeWallScene(cam, texture_scale=0.03, stripe_period_z=2400.0)
    gray, _ = scene.render(*lateral_trajectory(1)[0])
    products = _Products()
    with products, profiling.stamping(products.stamp):
        lines_mod.detect_lines(torch.as_tensor(gray))
    assert not products.open
    t = (cam.height // lines_mod.TILE) * (cam.width // lines_mod.TILE)
    assert lines_work.TILE == lines_mod.TILE and t == 1200
    assert lines_work.EDGES == len(lines_mod.SHIFTS) == 8
    assert products.shapes == [((t, t), (t, t))] * math.ceil(math.log2(t))
    work = lines_work.line_tiles_work(cam.height, cam.width)
    assert work["tiles"] == t
    assert work["flops"] == 8 * t * t
    assert work["bytes"] == 4 * 480 * 640 + 45 * t + t * t
    dense_flops = sum(2 * a[0] * a[1] * b[1] for a, b in products.shapes)
    assert work["flops"] * 1000 < dense_flops
    least_s, bound = measure.least_time_s(work)
    assert bound == "bytes" and least_s == pytest.approx(2_722_800 / 3.35e12)


def test_the_limits_file_is_json_with_a_limit_each(bench):
    limits = json.loads((registry.ROOT / "slambench" / "limits" / f"{CELL}.json").read_text())
    assert all(v["limit"] is not None for k, v in limits.items() if k != "leaves")
