"""The port's io modules against the JAX package's on the same inputs: the TUM and
CAPE dataset indexers, the trajectory file, the four map writers, the map export
of a state (snapshot and streamed), the debug image, the native PNG loader and
``chip_smoke.py``'s PNG writer.  Files are compared byte for byte and images
pixel for pixel; the state is made from a seed and carried across with
``convert.state_from_numpy``.  One exception is stated where it applies: a 2D
map point's vertex is ``to_world`` of its inverse-depth state, whose sine and
cosine come from another library in each package, so those lines may differ in
the last float32 bit.
"""

import filecmp
import os
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from rgbd_slam_tpu import engine as j_engine
from rgbd_slam_tpu.config import CameraIntrinsics as JCam
from rgbd_slam_tpu.io import datasets as j_datasets
from rgbd_slam_tpu.io import debug_image as j_debug
from rgbd_slam_tpu.io import map_writer as j_writer
from rgbd_slam_tpu.io.trajectory import Trajectory as JTrajectory
from rgbd_slam_tpu_torch import convert
from rgbd_slam_tpu_torch.config import CameraIntrinsics
from rgbd_slam_tpu_torch.io import datasets, debug_image, map_writer, native_loader
from rgbd_slam_tpu_torch.io.trajectory import Trajectory
from rgbd_slam_tpu_torch.synthetic import RoomScene, lateral_trajectory

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

CAM_KW = dict(width=320, height=240, fx=260.0, fy=260.0, cx=160.0, cy=120.0)
CAM, J_CAM = CameraIntrinsics(**CAM_KW), JCam(**CAM_KW)
MAPPING = dict(max_points_3d=64, max_points_2d=16, max_planes=6, max_lines=8,
               max_tracked_points=32)


# ---------------------------------------------------------------------------
# datasets and trajectory
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tum_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tum")
    poses = lateral_trajectory(4, speed_mm=4.0)
    scene = RoomScene(CAM)
    grays = [scene.render(q, p)[0] for q, p in poses]
    dataset, yaml = chip_smoke.write_tum_directory(str(root), CAM, grays, poses)
    return dataset, yaml, grays, poses


def _same_index(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        assert (a.timestamp, a.rgb_path, a.depth_path) == (b.timestamp, b.rgb_path,
                                                           b.depth_path)
        for x, y in ((a.gt_position, b.gt_position), (a.gt_quaternion, b.gt_quaternion)):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)


def test_index_tum_matches_jax(tum_dir):
    dataset, _, grays, poses = tum_dir
    ours, theirs = datasets.index_tum(dataset), j_datasets.index_tum(dataset)
    _same_index(ours, theirs)
    assert len(ours) == 4 and ours[0].gt_position is not None
    # ground truth in metres, quaternions stored wxyz
    np.testing.assert_allclose(ours[2].gt_position * 1000.0, poses[2][1], atol=1e-9)
    np.testing.assert_allclose(ours[2].gt_quaternion, poses[2][0], atol=1e-12)


def test_load_tum_frame_matches_jax_and_the_arrays_written(tum_dir):
    dataset, _, grays, _ = tum_dir
    idx = datasets.index_tum(dataset)[1]
    ours, theirs = datasets.load_tum_frame(idx), j_datasets.load_tum_frame(idx)
    np.testing.assert_array_equal(ours.gray, theirs.gray)
    np.testing.assert_array_equal(ours.depth_mm, theirs.depth_mm)
    assert ours.gray.dtype == ours.depth_mm.dtype == np.float32
    np.testing.assert_array_equal(ours.gray, np.clip(grays[1], 0, 255).astype(np.uint8))
    assert ours.timestamp == theirs.timestamp == idx.timestamp


def test_index_tum_prefers_associations(tum_dir, tmp_path):
    dataset = tum_dir[0]
    idx = datasets.index_tum(dataset)
    lines = ["# depth_ts depth_path rgb_ts rgb_path"] + [
        f"{i.timestamp + 0.002:.4f} {os.path.relpath(i.depth_path, dataset)} "
        f"{i.timestamp:.4f} {os.path.relpath(i.rgb_path, dataset)}" for i in idx[:2]]
    work = tmp_path / "assoc"
    os.symlink(dataset, work)
    try:
        with open(os.path.join(dataset, "associations.txt"), "w") as f:
            f.write("\n".join(lines))
        ours, theirs = datasets.index_tum(str(work)), j_datasets.index_tum(str(work))
    finally:
        os.remove(os.path.join(dataset, "associations.txt"))
    _same_index(ours, theirs)
    assert len(ours) == 2


def test_index_cape_matches_jax(tum_dir, tmp_path):
    dataset = tum_dir[0]
    idx = datasets.index_tum(dataset)
    for i, entry in enumerate(idx[:3]):
        os.symlink(entry.rgb_path, tmp_path / f"rgb_{i}.png")
        os.symlink(entry.depth_path, tmp_path / f"depth_{i}.png")
    ours, theirs = datasets.index_cape(str(tmp_path)), j_datasets.index_cape(str(tmp_path))
    _same_index(ours, theirs)
    a, b = datasets.load_cape_frame(ours[2]), j_datasets.load_cape_frame(theirs[2])
    np.testing.assert_array_equal(a.depth_mm, b.depth_mm)     # already in mm: not scaled
    np.testing.assert_array_equal(a.depth_mm, datasets.load_tum_frame(idx[2]).depth_mm * 5.0)


def test_trajectory_file_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    ours, theirs = Trajectory(), JTrajectory()
    for i in range(6):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        p = rng.normal(0, 500.0, 3)
        ours.append(1e9 + 0.05 * i, p, q)
        theirs.append(1e9 + 0.05 * i, p, q)
    ours.save_tum_format(str(tmp_path / "ours.txt"))
    theirs.save_tum_format(str(tmp_path / "theirs.txt"))
    assert filecmp.cmp(tmp_path / "ours.txt", tmp_path / "theirs.txt", shallow=False)
    assert len(open(tmp_path / "ours.txt").read().splitlines()[0].split()) == 8


# ---------------------------------------------------------------------------
# the four writers
# ---------------------------------------------------------------------------

def _feed(writer):
    rng = np.random.default_rng(1)
    pts = rng.normal(0, 1000.0, (5, 3)).astype(np.float32)
    with writer as w:
        for p in pts[:3]:
            w.add_point(p)
        w.add_line(pts[1:3])
        w.add_polygon(pts, np.array([0.0, 0.6, 0.8], np.float32))
        w.add_point(pts[4].astype(np.float64))


@pytest.mark.parametrize("name", ["XYZWriter", "PCDWriter", "OBJWriter"])
def test_writer_files_match_jax(name, tmp_path):
    _feed(getattr(map_writer, name)(str(tmp_path / "ours")))
    _feed(getattr(j_writer, name)(str(tmp_path / "theirs")))
    assert filecmp.cmp(tmp_path / "ours", tmp_path / "theirs", shallow=False)
    assert os.path.getsize(tmp_path / "ours") > 100


def test_base_writer_is_an_interface(tmp_path):
    with map_writer.MapWriter(str(tmp_path / "m")) as w:
        for call in (lambda: w.add_point(None), lambda: w.add_line(None),
                     lambda: w.add_polygon(None, None)):
            with pytest.raises(NotImplementedError):
                call()
    assert w._file.closed


# ---------------------------------------------------------------------------
# a seeded state, carried across
# ---------------------------------------------------------------------------

def _seeded_state(seed=0):
    """The JAX package's ``SlamState`` with numpy leaves and seeded map
    contents: alive and empty slots, local and staged features, polygons of 0
    to 8 vertices."""
    rng = np.random.default_rng(seed)
    from rgbd_slam_tpu.config import MappingConfig as JMapping
    from rgbd_slam_tpu.config import SlamConfig as JCfg
    tree = jax.tree.map(lambda x: np.array(x), j_engine.init_state(
        J_CAM, JCfg(mapping=JMapping(**MAPPING))))

    def counters(m):
        n = m.fid.shape[0]
        alive = rng.uniform(size=n) < 0.6
        return dict(fid=np.where(alive, np.arange(n) + 7, -1).astype(np.int32),
                    is_local=rng.uniform(size=n) < 0.5)

    def f32(*shape, scale=1.0, loc=0.0):
        return (loc + scale * rng.normal(size=shape)).astype(np.float32)

    pts = tree.points
    n = pts.fid.shape[0]
    pos = np.concatenate([f32(n, 1, scale=300.0, loc=2500.0), f32(n, 2, scale=600.0)], axis=1)
    pts = pts._replace(pos=pos, **counters(pts))
    p2 = tree.points2d
    n2 = p2.fid.shape[0]
    state2 = np.concatenate([f32(n2, 3, scale=50.0), np.abs(f32(n2, 1, scale=2e-4)) + 2e-4,
                             f32(n2, 1, scale=0.3, loc=1.5), f32(n2, 1, scale=0.3)], axis=1)
    p2 = p2._replace(state=state2, **counters(p2))
    ln = tree.lines
    ln = ln._replace(endpoints=f32(ln.fid.shape[0], 6, scale=800.0, loc=1500.0),
                     **counters(ln))
    pl = tree.planes
    np_, nv = pl.poly_verts.shape[:2]
    normal = f32(np_, 3)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    u = np.cross(normal, [0.0, 0.0, 1.0]).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pl = pl._replace(
        params=np.concatenate([normal, f32(np_, 1, scale=100.0, loc=-2500.0)], axis=1),
        poly_verts=f32(np_, nv, 2, scale=400.0),
        poly_count=rng.integers(0, nv + 1, np_).astype(np.int32),
        basis_center=np.concatenate([f32(np_, 1, scale=50.0, loc=2800.0),
                                     f32(np_, 2, scale=300.0)], axis=1),
        basis_u=u, basis_v=np.cross(normal, u).astype(np.float32), **counters(pl))
    nt = tree.tracked_ok.shape[0]
    return tree._replace(
        points=pts, points2d=p2, lines=ln, planes=pl,
        position=f32(3, scale=20.0), tracked_ok=rng.uniform(size=nt) < 0.7,
        tracked_uv=np.stack([rng.uniform(0, 320, nt), rng.uniform(0, 240, nt)],
                            axis=1).astype(np.float32))


@pytest.fixture(scope="module")
def states():
    tree = _seeded_state()
    return tree, convert.state_from_numpy(tree, device="cpu")


def _same_map_file(ours, theirs, n_points2d):
    """Equal line by line; at most ``n_points2d`` vertex lines (the 2D points')
    may differ, and then by 2 float32 ulps at most."""
    a, b = open(ours).read().splitlines(), open(theirs).read().splitlines()
    assert len(a) == len(b)
    differ = [(x, y) for x, y in zip(a, b) if x != y]
    assert len(differ) <= n_points2d
    for x, y in differ:
        assert x.startswith("v ") and y.startswith("v ")
        np.testing.assert_allclose(np.array(x.split()[1:], np.float64),
                                   np.array(y.split()[1:], np.float64), rtol=2.5e-7)


def test_export_slam_map_matches_jax(states, tmp_path):
    tree, state = states
    map_writer.export_slam_map(state, str(tmp_path / "ours.obj"))
    j_writer.export_slam_map(tree, str(tmp_path / "theirs.obj"))
    _same_map_file(tmp_path / "ours.obj", tmp_path / "theirs.obj",
                   int((tree.points2d.fid >= 0).sum()))
    text = open(tmp_path / "ours.obj").read()
    assert all(tag in text for tag in ("v ", "p ", "l ", "vn ", "f "))


def _eviction_record(seed, tensors):
    """What ``append_dying_features`` reads of a ``StepOutput``, seeded."""
    rng = np.random.default_rng(seed)
    to = torch.from_numpy if tensors else (lambda a: a)

    def f32(*shape, scale=500.0):
        return to((scale * rng.normal(size=shape)).astype(np.float32))

    def mask(n):
        return to(rng.uniform(size=n) < 0.4)

    return SimpleNamespace(
        point_evicted=mask(64), point_evict_pos=f32(64, 3),
        point2d_evicted=mask(16), point2d_evict_pos=f32(16, 3),
        plane_evicted=mask(6), plane_evict_params=f32(6, 4, scale=1.0),
        plane_evict_verts=f32(6, 8, 2), plane_evict_center=f32(6, 3),
        plane_evict_count=to(rng.integers(0, 9, 6).astype(np.int32)),
        plane_evict_u=f32(6, 3, scale=1.0), plane_evict_v=f32(6, 3, scale=1.0),
        line_evicted=mask(8), line_evict_eps=f32(8, 6))


@pytest.mark.parametrize("only_local", [True, False])
def test_streamed_export_matches_jax(states, only_local, tmp_path):
    tree, state = states
    counts = []
    for name, mod, tensors, final in (("ours.obj", map_writer, True, state),
                                      ("theirs.obj", j_writer, False, tree)):
        with mod.OBJWriter(str(tmp_path / name)) as w:
            n = [mod.append_dying_features(w, _eviction_record(seed, tensors))
                 for seed in (3, 4)]
            mod.append_alive_features(w, final, only_local=only_local)
        counts.append(n)
    _same_map_file(tmp_path / "ours.obj", tmp_path / "theirs.obj",
                   int((tree.points2d.fid >= 0).sum()))
    assert counts[0] == counts[1] and min(counts[0]) > 10


def test_export_counts_and_reads_the_device_once(states, tmp_path, monkeypatch):
    tree, state = states
    reads = []
    real_fetch = map_writer.fetch
    monkeypatch.setattr(map_writer, "fetch", lambda *t: reads.append(len(t)) or real_fetch(*t))
    with map_writer.OBJWriter(str(tmp_path / "m.obj")) as w:
        died = map_writer.append_dying_features(w, _eviction_record(3, True))
        alive = map_writer.append_alive_features(w, state, only_local=True)
    assert len(reads) == 2                                   # one packed read a call
    text = open(tmp_path / "m.obj").read().splitlines()
    assert sum(ln.startswith(("p ", "l ", "f ")) for ln in text) == died + alive


def test_fetch_keeps_shapes_and_kinds():
    a = torch.arange(6, dtype=torch.int32).reshape(2, 3) - 2
    b = torch.tensor([True, False, True])
    c = torch.tensor([[0.1, 1e-7], [3e8, -2.5]])
    got = map_writer.fetch(a, b, c)
    assert [g.shape for g in got] == [(2, 3), (3,), (2, 2)]
    np.testing.assert_array_equal(got[0], a.numpy())
    np.testing.assert_array_equal(got[1], b.numpy())
    np.testing.assert_array_equal(got[2], c.numpy())
    assert got[1].dtype == bool and got[2].dtype == np.float32


@pytest.mark.parametrize("is_lost, with_cells", [(False, False), (True, False), (False, True)])
def test_debug_image_matches_jax(states, is_lost, with_cells):
    tree, state = states
    gray = np.random.default_rng(2).uniform(0, 255, (240, 320)).astype(np.float32)
    cells = np.random.default_rng(3).uniform(size=(240 // 20) * (320 // 20)) < 0.1
    ours = debug_image.render_debug_image(
        torch.from_numpy(gray), state, CAM, fps=12.3, is_lost=is_lost,
        cylinder_cells=torch.from_numpy(cells) if with_cells else None)
    theirs = j_debug.render_debug_image(gray, tree, J_CAM, fps=12.3, is_lost=is_lost,
                                        cylinder_cells=cells if with_cells else None)
    assert ours.shape == (240, 320, 3) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, theirs)
    plain = debug_image.render_debug_image(gray, state, CAM, fps=12.3)
    if is_lost:      # the lost tint: red lifted by 80 below the header band
        assert (ours[18:, :, 0].astype(int) >= plain[18:, :, 0].astype(int)).all()
        assert (ours[18:, :, 0].astype(int) - plain[18:, :, 0]).max() == 80
    if with_cells:
        assert (ours != plain).any()


# ---------------------------------------------------------------------------
# the native loader and the smoke script's PNG writer
# ---------------------------------------------------------------------------

def _write_pngs(tmp_path, rng, n=3, h=48, w=64):
    from PIL import Image

    rgbs, depths = [], []
    for i in range(n):
        rgb = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        depth = rng.integers(500, 30000, (h, w)).astype(np.uint16)
        rp, dp = str(tmp_path / f"rgb_{i}.png"), str(tmp_path / f"depth_{i}.png")
        Image.fromarray(rgb).save(rp)
        Image.fromarray(depth.astype(np.int32), mode="I").convert("I;16").save(dp)
        rgbs.append(rp)
        depths.append(dp)
    return rgbs, depths


def test_native_rgb_to_gray_matches_pil(tmp_path, rng):
    from PIL import Image

    rgbs, _ = _write_pngs(tmp_path, rng, n=1)
    assert native_loader.available()
    native = native_loader.decode_png(rgbs[0], 48, 64, to_gray=True)
    ref = np.asarray(Image.open(rgbs[0]))
    expected = 0.299 * ref[..., 0] + 0.587 * ref[..., 1] + 0.114 * ref[..., 2]
    np.testing.assert_allclose(native, expected, atol=0.01)


def test_native_depth_16bit_scaled(tmp_path, rng):
    from PIL import Image

    _, depths = _write_pngs(tmp_path, rng, n=1)
    native = native_loader.decode_png(depths[0], 48, 64, to_gray=False, scale=0.2)
    ref = np.asarray(Image.open(depths[0]), dtype=np.float32) * 0.2
    np.testing.assert_allclose(native, ref, atol=0.01)


def test_native_wrong_size_rejected(tmp_path, rng):
    rgbs, _ = _write_pngs(tmp_path, rng, n=1)
    assert native_loader.decode_png(rgbs[0], 10, 10) is None


def test_native_sequential_frames(tmp_path, rng):
    rgbs, depths = _write_pngs(tmp_path, rng, n=3)
    loader = native_loader.NativeFrameLoader(rgbs, depths, 48, 64, depth_scale=0.2)
    frames = list(loader)
    assert len(frames) == len(loader) == 3
    for (gray, depth), dp in zip(frames, depths):
        assert gray.shape == (48, 64) and depth.shape == (48, 64)
        np.testing.assert_allclose(depth, datasets._load_depth_tum(dp), atol=0.01)
    loader.close()


def test_native_random_access(tmp_path, rng):
    rgbs, depths = _write_pngs(tmp_path, rng, n=3)
    loader = native_loader.NativeFrameLoader(rgbs, depths, 48, 64)
    g2, _ = loader.get(2)
    g0, _ = loader.get(0)
    assert not np.array_equal(g2, g0)
    loader.close()


def test_native_library_is_built_from_the_shared_source():
    assert native_loader.available() and native_loader.LIBRARY_ORIGIN == "built"
    built = [f for f in os.listdir(native_loader._BUILD_DIR)
             if f.startswith("libpng_loader_") and f.endswith(".so")]
    assert built


@pytest.mark.parametrize("kind", ["rgb8", "gray16"])
def test_smoke_png_writer_round_trips(kind, tmp_path, rng):
    from PIL import Image

    path = str(tmp_path / "image.png")
    if kind == "rgb8":
        g = rng.integers(0, 256, (48, 64), dtype=np.uint8)
        pixels = np.stack([g] * 3, -1)
        chip_smoke.write_png(path, pixels)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), pixels)
        np.testing.assert_array_equal(datasets._load_gray(path), g)
        np.testing.assert_allclose(native_loader.decode_png(path, 48, 64), g, atol=1e-3)
    else:
        pixels = rng.integers(0, 65536, (48, 64)).astype(np.uint16)
        pixels[0, :2] = (0, 65535)
        chip_smoke.write_png(path, pixels)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), pixels)
        np.testing.assert_array_equal(
            native_loader.decode_png(path, 48, 64, to_gray=False, scale=1.0), pixels)
    with pytest.raises(ValueError):
        chip_smoke.write_png(path, np.zeros((4, 4), np.float32))
