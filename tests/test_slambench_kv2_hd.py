"""The Kinect v2 HD deployment with no card: the configuration ``kv2_hd`` and
its grid, the cylinder kernel's choice of path by the grid's size (pure
arithmetic), the camera that ``engine.init_state`` refuses, the frozen count
of the cylinder stage's work against the program's, the two readers of the
cylinder section, and two 1920x1080 room frames through the port's plain
step against the benchmark's plain reference (``slambench/reference/plain/``)
to the bit.

This file imports no JAX.
"""

import dataclasses
import os
import sys
import types

import pytest
import torch

from rgbd_slam_tpu_torch import config, engine, profiling, runner, synthetic
from rgbd_slam_tpu_torch.features import primitives
from rgbd_slam_tpu_torch.ops import cylinders_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from slambench import check, cylinders_work, measure, registry  # noqa: E402
from slambench.reference.plain import config as ref_config  # noqa: E402
from slambench.reference.plain import runner as ref_runner  # noqa: E402

torch.set_num_threads(2)

READERS = ("graph_cylinders_us", "cylinders_roofline")


@pytest.fixture(scope="module")
def bench():
    return registry.Benchmark(registry.ROOT)


def _camera(conf):
    return config.CameraIntrinsics(**{k: v for k, v in conf["camera"].items()
                                      if k != "rate_hz"})


def test_the_configuration_is_fr1_vo_at_the_kinect_v2_hd_camera(bench):
    """``kv2_hd`` loads through the registry: libfreenect2's colour camera at
    1920x1080 and 30 Hz, the default ``SlamConfig`` with planes on, lines
    off and no backend, a 96x54 grid of 20 px cells; the rest is
    ``fr1_vo``'s, and ``reduced`` names keys the file holds."""
    conf = bench.config("kv2_hd")
    cam = _camera(conf)
    assert cam == config.CameraIntrinsics(width=1920, height=1080, fx=1081.37, fy=1081.37,
                                          cx=959.5, cy=539.5)
    assert conf["camera"]["rate_hz"] == 30
    cfg = check.build_dataclass(config.SlamConfig, conf["slam_config"])
    assert cfg == config.SlamConfig()
    patch = cfg.detection.depth_patch_size_px
    assert (cam.height // patch, cam.width // patch) == (54, 96)
    vo = bench.config("fr1_vo")
    assert conf["slam_config"] == vo["slam_config"]
    for key in ("with_planes", "with_lines", "backend", "sequence_frames", "precision"):
        assert conf[key] == vo[key], key
    entry = [c for c in bench.spec["configs"] if c["name"] == "kv2_hd"][0]
    assert entry["reduced"] == ["sequence_frames"] and set(entry["reduced"]) <= set(conf)
    cells = {c["name"]: c for c in bench.spec["workloads"]}
    assert (cells["kv2_hd.room"]["config"], cells["kv2_hd.room"]["traffic"]) == ("kv2_hd",
                                                                                  "room")
    assert cells["kv2_hd.room"]["chips"] == 1


@pytest.mark.parametrize("cells, shared", [(768, True), (3_576, True), (3_577, False),
                                           (4_800, False), (5_184, False),
                                           (38_741, False), (65_536, False)])
def test_the_grid_chooses_the_path(cells, shared):
    """At 20 regions the shared-memory path takes grids up to 3,576 cells
    (``smem_bytes`` within ``MAX_SMEM_BYTES``) and the global-memory path the
    larger ones, up to ``MAX_CELLS``: 5,184 (1920x1080 at 20 px), 4,800
    (640x480 at 8 px) and the components kernel's 38,741 among them."""
    assert cylinders_cuda.shared_path(cells, 20) is shared
    assert (cylinders_cuda.smem_bytes(cells, 20) <= cylinders_cuda.MAX_SMEM_BYTES) is shared
    cylinders_cuda.check_grid(cells, 20)


class _CudaLooking(torch.Tensor):
    """A CPU tensor that says it lies on the card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("cells", [4_800, 5_184])
def test_the_kernel_takes_the_large_grids(cells):
    def card(t):
        return t.as_subclass(_CudaLooking)

    grid = types.SimpleNamespace(normal=card(torch.zeros(cells, 3)),
                                 mean=card(torch.zeros(cells, 3)),
                                 planar=card(torch.zeros(cells, dtype=torch.bool)))
    cylinders_cuda.check_inputs(grid, card(torch.zeros(20, cells, dtype=torch.bool)),
                                card(torch.zeros(20, dtype=torch.bool)), 43, 3)
    with pytest.raises(ValueError, match="cells: the cylinders kernel takes"):
        cylinders_cuda.check_grid(cylinders_cuda.MAX_CELLS + 1, 20)


FINE = dataclasses.replace(config.DetectionConfig(), depth_patch_size_px=2)


def test_init_state_refuses_a_grid_no_path_takes():
    """640x480 at 2 px cells is 76,800 cells, past the global-memory path:
    on a card with planes on, ``engine.init_state`` raises the kernel's
    message before the first frame (before it allocates anything, so the
    check runs here with no card); the 1080p camera and the fr1 camera at
    8 px are taken."""
    cfg = dataclasses.replace(config.SlamConfig(), detection=FINE)
    with pytest.raises(ValueError, match="76800 cells: the cylinders kernel takes 1 to 65536"):
        engine.init_state(config.TUM_FR1, cfg, device="cuda")
    with pytest.raises(ValueError, match="cylinders kernel"):
        primitives.check_grid(480, 640, FINE)
    primitives.check_grid(1080, 1920, config.DetectionConfig())
    primitives.check_grid(480, 640, dataclasses.replace(FINE, depth_patch_size_px=8))


@pytest.mark.parametrize("with_planes", [True, False])
def test_init_state_takes_any_grid_on_the_cpu(with_planes):
    """The CPU's plain version has no grid cap, nor has a path with planes
    off: ``init_state`` on the CPU builds the state at 640x480 at 2 px cells,
    planes on or off."""
    cfg = dataclasses.replace(config.SlamConfig(), detection=FINE)
    state = engine.init_state(config.TUM_FR1, cfg, device="cpu", with_planes=with_planes)
    assert state.prev_pyramid[0].shape == (480, 640)
    assert state.prev_pyramid[0].device.type == "cpu"


def test_the_frozen_work_count_is_the_programs():
    """``slambench/cylinders_work.py`` counts as ``ops.cylinders_cuda`` does,
    at the stage's own sizes; at 5,184 cells with no live slot its bytes bound
    it (545,880 B, 0.163 us), at 768 cells 82,200 B."""
    assert (cylinders_work.REGIONS, cylinders_work.SUBSEGMENTS, cylinders_work.HYPOTHESES) == (
        primitives.MAX_PLANES + primitives.MAX_CYLINDERS, primitives.CYL_SUBSEGMENTS,
        primitives._msac_iterations(config.DetectionConfig()))
    for name in ("FLOPS_AXIS_PAIR", "FLOPS_AXIS_REGION", "FLOPS_PROJECT_CELL",
                 "FLOPS_HYPOTHESIS", "FLOPS_DISTANCE", "FLOPS_REFIT_CELL"):
        assert getattr(cylinders_work, name) == getattr(cylinders_cuda, name), name
    for c, k, hyp, s, live in [(768, 20, 43, 3, 0), (5_184, 20, 43, 3, 1), (4_800, 20, 43, 3, 4),
                               (100, 7, 9, 2, 3)]:
        assert cylinders_work.cylinders_work(c, k, hyp, s, live) == \
            cylinders_cuda.cylinders_work(c, k, hyp, s, live)
    hd = cylinders_work.stage_work(1080, 1920, 20, 0)
    assert hd["bytes"] == 545_880
    least_s, bound = measure.least_time_s(hd)
    assert bound == "bytes" and least_s == pytest.approx(0.163e-6, rel=3e-3)
    assert cylinders_work.stage_work(480, 640, 20, 0)["bytes"] == 82_200


def _stats(k, with_section=True):
    stages = {s: 9 * 10.0 for s in profiling.stages(False, with_section)}
    if with_section:
        stages["cylinders"] = 9 * (12.0 + k)
    return runner.RunStats(frame_count=10, stamped_frames=9, stage_device_us=stages,
                           cylinders_live=5 * k)


def _run(stats_list, frame_hw=(1080, 1920)):
    return types.SimpleNamespace(sequences=[types.SimpleNamespace(stats=s)
                                            for s in stats_list],
                                 frame_hw=frame_hw, patch_px=20)


def test_the_readers_read_the_cylinder_section():
    """Sequences 1 and 2 ran under the profiler and are left out: sequences
    0, 3 and 4 are read (their k average to 7/3), and the roofline takes
    their mean live slots a frame (35 over 30 frames)."""
    run = _run([_stats(k) for k in (0, 500, 900, 3, 4)])
    us = registry.load_reader(registry.ROOT, "graph_cylinders_us").read(run)
    assert us == pytest.approx(12.0 + 7.0 / 3.0)
    least_s, _ = measure.least_time_s(cylinders_work.stage_work(1080, 1920, 20, 35 / 30))
    share = registry.load_reader(registry.ROOT, "cylinders_roofline").read(run)
    assert share == pytest.approx(100.0 * least_s / (1e-6 * us))


@pytest.mark.parametrize("name", READERS)
def test_a_cylinder_reader_reads_nothing_where_no_sequence_stamped_the_section(name):
    """A program without the section (the tree before it, whose ``RunStats``
    has neither the section nor the count), or planes off: None, no raise."""
    reader = registry.load_reader(registry.ROOT, name)
    bare = types.SimpleNamespace(frame_count=10, stamped_frames=9,
                                 stage_device_us={s: 90.0 for s in profiling.STAGES})
    assert reader.read(_run([bare] * 4)) is None
    assert reader.read(_run([_stats(1, with_section=False)] * 4)) is None
    assert reader.read(_run([])) is None


@pytest.fixture(scope="module")
def hd_runs():
    """The port's and the reference's ``run_frames`` over two 1920x1080 room
    frames (Kinect depth noise) from the same state seed, each frame's
    (state, outputs) kept."""
    cam = config.CameraIntrinsics(width=1920, height=1080, fx=1081.37, fy=1081.37, cx=959.5,
                                  cy=539.5)
    cfg = config.SlamConfig()
    scene = synthetic.RoomScene(cam, depth_noise=config.DepthNoiseModel())
    frames = [scene.render(q, p) for q, p in synthetic.orbit_trajectory(2, speed_mm=4.0)]
    kw = dict(seed=3, device="cpu")
    port_kept, ref_kept = [], []
    port = runner.run_frames(frames, cam, cfg,
                             on_frame=lambda i, s, o, dt: port_kept.append((s, o)), **kw)
    ref = ref_runner.run_frames(
        frames, ref_config.CameraIntrinsics(**dataclasses.asdict(cam)),
        check.build_dataclass(ref_config.SlamConfig, dataclasses.asdict(cfg)),
        on_frame=lambda i, s, o, dt: ref_kept.append((s, o)), **kw)
    return port, ref, port_kept, ref_kept


@pytest.mark.parametrize("frame", range(2))
def test_two_hd_frames_equal_the_reference_to_the_bit(hd_runs, frame):
    """Every leaf of the state and of the step's outputs, at 5,184 cells."""
    (_, _, stats), (_, _, ref_stats), port_kept, ref_kept = hd_runs
    port = [*check.tensor_leaves(port_kept[frame][0], "state"),
            *check.tensor_leaves(port_kept[frame][1], "out")]
    ref = [*check.tensor_leaves(ref_kept[frame][0], "state"),
           *check.tensor_leaves(ref_kept[frame][1], "out")]
    assert [n for n, _ in port] == [n for n, _ in ref]
    for (name, a), (_, b) in zip(port, ref):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a.nan_to_num(), b.nan_to_num()), name
        assert torch.equal(a.isnan(), b.isnan()), name
    assert port_kept[frame][1].cylinder_cells.shape == (5_184,)
    assert stats.success_count == ref_stats.success_count == 2
