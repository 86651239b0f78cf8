"""Parity of the port's plane path below the engine with the JAX package: eig3,
moments, the depth cloud, the polygon ops (mirroring
tests/test_primitives.py::TestPolygonOps), the connected components, the CAPE
extraction ``find_primitives`` field by field (the test_primitives.py scenes,
cylinder_depth included, and a RoomScene and a TunnelScene frame at 640x480),
the plane covariances and helpers, and ``track_planes``.

Tolerances, all float32 on both sides:
* discrete fields (valid flags, polygon vertex counts, cell masks, point counts,
  component labels) equal;
* eigenvalues 1e-5 of the largest, eigenvectors (sign included) 1e-4;
* polygon areas and vertices 1e-5 relative (same sort order, same arithmetic);
* plane normals 3e-5, d 1e-5 relative; centres 3e-5 |d| + 1e-2 mm; polygon
  vertices 1e-4 of the polygon's extent; plane MSE 1e-6 extent^2 (it is the
  smallest eigenvalue of moments whose largest is ~ n extent^2, over n);
  the cloud covariance 1e-4 of its largest entry;
* cylinder centre and radius 1e-2 mm, axis 1e-5, MSE 1e-6 radius^2;
* covariance conversions and the Kalman update 1e-4 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_slam_tpu import config as jcfg
from rgbd_slam_tpu.features import moments as j_moments
from rgbd_slam_tpu.features import primitives as j_prim
from rgbd_slam_tpu.geometry import covariances as j_cov
from rgbd_slam_tpu.geometry import eig3 as j_eig3
from rgbd_slam_tpu.geometry import planes as j_planes
from rgbd_slam_tpu.ops import depth_cloud as j_depth_cloud
from rgbd_slam_tpu.tracking import kalman as j_kalman
from rgbd_slam_tpu.utils import polygon as j_poly
from rgbd_slam_tpu_torch import config as tcfg
from rgbd_slam_tpu_torch import synthetic
from rgbd_slam_tpu_torch.features import moments, primitives
from rgbd_slam_tpu_torch.geometry import covariances, eig3, planes
from rgbd_slam_tpu_torch.ops import depth_cloud
from rgbd_slam_tpu_torch.tracking import kalman
from rgbd_slam_tpu_torch.utils import polygon as poly
from test_primitives import CAM, CFG, cylinder_depth, plane_depth

torch.set_num_threads(2)

T_CAM = tcfg.CameraIntrinsics(**dataclasses.asdict(CAM))


def _t(a):
    return torch.from_numpy(np.array(a))


def _spd(rng, n, k, scale=1.0):
    a = rng.normal(size=(k, n, n))
    return (scale * (a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(n))).astype(np.float32)


# ---------------------------------------------------------------------------
# eig3, moments, depth cloud
# ---------------------------------------------------------------------------

def test_eig3_matches_jax():
    rng = np.random.default_rng(0)
    a = np.concatenate([_spd(rng, 3, 64),
                        # mm^2-scale moment matrices (norm-scaled before the cross products)
                        _spd(rng, 3, 8, 1e9),
                        # isotropic: repeated eigenvalue, fixed z-axis fallback
                        np.broadcast_to(np.eye(3, dtype=np.float32) * 5.0, (2, 3, 3))])
    j_vals, j_vec = j_eig3.sym_eig3_smallest(a)
    t_vals, t_vec = eig3.sym_eig3_smallest(_t(a))
    scale = np.abs(np.asarray(j_vals)).max(axis=-1, keepdims=True)
    assert np.all(np.abs(t_vals.numpy() - np.asarray(j_vals)) <= 1e-5 * scale)
    np.testing.assert_allclose(t_vec.numpy(), np.asarray(j_vec), atol=1e-4)
    np.testing.assert_array_equal(t_vec.numpy()[-2:], [[0, 0, 1], [0, 0, 1]])
    lam = np.asarray(j_vals)[:, 1]
    np.testing.assert_allclose(eig3.eigenvector_for(_t(a[:64]), _t(lam[:64])).numpy(),
                               np.asarray(j_eig3.eigenvector_for(a[:64], lam[:64])),
                               atol=1e-4)


def test_moments_match_jax():
    rng = np.random.default_rng(1)
    pts = rng.normal(1000.0, 300.0, (5, 40, 3)).astype(np.float32)
    w = (rng.uniform(size=(5, 40)) > 0.3).astype(np.float32)
    j = j_moments.from_points(pts, w)
    t = moments.from_points(_t(pts), _t(w))
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-2)
    cnt, mean, m2 = [np.asarray(x) for x in j]
    mask = rng.uniform(size=(3, 5)) > 0.4
    jc = j_moments.combine(cnt, mean, m2, mask)
    tc = moments.combine(_t(cnt), _t(mean), _t(m2), _t(mask))
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-2)
    jp = j_moments.combine_pair(cnt[0], mean[0], m2[0], cnt[1], mean[1], m2[1])
    tp = moments.combine_pair(_t(cnt[0]), _t(mean[0]), _t(m2[0]), _t(cnt[1]),
                              _t(mean[1]), _t(m2[1]))
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(moments.raw_second_moment(_t(cnt), _t(mean), _t(m2)).numpy(),
                               np.asarray(j_moments.raw_second_moment(cnt, mean, m2)),
                               rtol=1e-5)


def test_depth_to_cloud_matches_jax():
    depth = plane_depth(CAM, np.array([0.3, 0.2, 0.93]) / np.linalg.norm([0.3, 0.2, 0.93]),
                        -2500.0)
    depth[:10] = 0.0
    depth[-5:] = 7000.0
    j_cloud, j_valid = j_depth_cloud.depth_to_cloud(jnp.asarray(depth), CAM)
    t_cloud, t_valid = depth_cloud.depth_to_cloud(_t(depth), T_CAM)
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
    np.testing.assert_allclose(t_cloud.numpy(), np.asarray(j_cloud), rtol=1e-6, atol=1e-3)


# ---------------------------------------------------------------------------
# polygons
# ---------------------------------------------------------------------------

def _poly(v):
    verts = np.zeros((poly.MAX_VERTS, 2), np.float32)
    verts[:len(v)] = v
    return verts, np.int32(len(v))


def _square(size, cx=0.0, cy=0.0):
    h = size / 2
    return _poly([[cx - h, cy - h], [cx + h, cy - h], [cx + h, cy + h], [cx - h, cy + h]])


def _rect(x0, y0, x1, y1):
    return _poly([[x0, y0], [x1, y0], [x1, y1], [x0, y1]])


def _both(fn_t, fn_j, *polys):
    """Run a polygon op in the port and in JAX on the same (verts, count) pairs."""
    args_t = [_t(x) for p in polys for x in p]
    args_j = [jnp.asarray(x) for p in polys for x in p]
    return fn_t(*args_t), fn_j(*args_j)


class TestPolygonOps:
    """tests/test_primitives.py::TestPolygonOps on the port, each value also
    held to the JAX function's."""

    def _close(self, t, j):
        np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=1e-5, atol=1e-6)
        return float(t)

    def test_area(self):
        v = _square(2.0)
        area = self._close(*_both(poly.polygon_area, j_poly.polygon_area, v))
        np.testing.assert_allclose(area, 4.0, atol=1e-5)

    def test_self_iou(self):
        v = _square(2.0)
        iou = self._close(*_both(poly.polygon_iou, j_poly.polygon_iou, v, v))
        np.testing.assert_allclose(iou, 1.0, atol=1e-3)

    def test_disjoint_iou_zero(self):
        iou = self._close(*_both(poly.polygon_iou, j_poly.polygon_iou, _square(2.0),
                                 _square(2.0, cx=10.0)))
        np.testing.assert_allclose(iou, 0.0, atol=1e-5)

    def test_half_overlap(self):
        iou = self._close(*_both(poly.polygon_iou, j_poly.polygon_iou, _square(2.0),
                                 _square(2.0, cx=1.0)))
        np.testing.assert_allclose(iou, 2.0 / 6.0, atol=1e-2)

    def test_merge_grows(self):
        (tv, tc), (jv, jc) = _both(poly.merge_polygons, j_poly.merge_polygons,
                                   _square(2.0), _square(2.0, cx=1.5))
        assert int(tc) == int(jc)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
        assert float(poly.polygon_area(tv, tc)) > 4.5

    def test_concave_L_merge_inflation_bounded_17pct(self):
        a, b = _rect(0.0, 0.0, 2.0, 1.0), _rect(0.0, 0.0, 1.0, 2.0)
        inter = self._close(*_both(poly.convex_intersection_area,
                                   j_poly.convex_intersection_area, a, b))
        (tv, tc), (jv, jc) = _both(poly.merge_polygons, j_poly.merge_polygons, a, b)
        assert int(tc) == int(jc)
        hull_area = float(poly.polygon_area(tv, tc))
        true_union = 4.0 - inter
        assert hull_area >= true_union - 1e-4
        assert hull_area / true_union <= 7.0 / 6.0 + 1e-3

    def test_concave_L_merge_keeps_match_gate(self):
        gate = jcfg.MatchingConfig().min_plane_overlap_for_match
        for arm in (1.0, 3.0):   # the symmetric L and the 4:1 long-arm L
            a, b = _rect(0.0, 0.0, 1.0 + arm, 1.0), _rect(0.0, 0.0, 1.0, 1.0 + arm)
            (tv, tc), _ = _both(poly.merge_polygons, j_poly.merge_polygons, a, b)
            hull = (tv.numpy(), np.int32(tc))
            ratio = self._close(*_both(poly.inter_over_area, j_poly.inter_over_area, a, hull))
            assert ratio >= gate


def test_polygon_batches_match_jax():
    """Random point clouds: hull (with the 128-candidate prefilter), intersection
    and merge, batched in the port and vmapped in JAX."""
    rng = np.random.default_rng(3)
    for n in (40, 300):
        pts = (rng.normal(size=(6, n, 2)) * 800).astype(np.float32)
        mask = rng.uniform(size=(6, n)) > 0.4
        (tv, tc), (jv, jc) = _both(poly.convex_hull_by_angle,
                                   jax.vmap(j_poly.convex_hull_by_angle), (pts, mask))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-3)
    other = (tv.numpy()[::-1] * 0.7 + 50.0, tc.numpy()[::-1])
    ti, ji = _both(poly.convex_intersection_area, jax.vmap(j_poly.convex_intersection_area),
                   (tv.numpy(), tc.numpy()), other)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-5, atol=1e-2)
    (mv, mc), (jmv, jmc) = _both(poly.merge_polygons, jax.vmap(j_poly.merge_polygons),
                                 (tv.numpy(), tc.numpy()), other)
    np.testing.assert_array_equal(mc.numpy(), np.asarray(jmc))
    np.testing.assert_allclose(mv.numpy(), np.asarray(jmv), rtol=1e-5, atol=1e-3)
    normals = rng.normal(size=(8, 3)).astype(np.float32)
    normals[0] = [0.95, 0.1, 0.0]   # the |n_x| >= 0.9 reference axis
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    for a, b in zip(poly.plane_basis(_t(normals)), j_poly.plane_basis(normals)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


# ---------------------------------------------------------------------------
# connected components and find_primitives
# ---------------------------------------------------------------------------

def _serpentine(gh, gw):
    """Planar cells and edges of one path that snakes through the grid: its
    labels need many more than CC_CHUNK fixpoint iterations to settle."""
    planar = np.ones((gh, gw), bool)
    planar[1::4, :-1] = False
    planar[3::4, 1:] = False
    edges = np.zeros((4, gh, gw), bool)
    edges[0, :, 1:] = planar[:, 1:] & planar[:, :-1]     # from the left neighbour
    edges[2, 1:, :] = planar[1:, :] & planar[:-1, :]     # from the upper neighbour
    return edges, planar


@pytest.mark.parametrize("case", ["random", "serpentine"])
def test_connected_components_match_jax(case):
    """The chunked fixpoint gives the JAX while_loop's labels exactly."""
    gh, gw = 24, 32
    if case == "random":
        rng = np.random.default_rng(4)
        planar = rng.uniform(size=(gh, gw)) > 0.2
        edges = rng.uniform(size=(4, gh, gw)) > 0.35
    else:
        edges, planar = _serpentine(gh, gw)
    j_lbl = np.asarray(j_prim._connected_components(jnp.asarray(edges),
                                                    jnp.asarray(planar.reshape(-1)), gh, gw))
    t_lbl = primitives._connected_components(_t(edges), _t(planar.reshape(-1)), gh, gw)
    np.testing.assert_array_equal(t_lbl.numpy(), j_lbl)
    if case == "serpentine":   # one component spans every planar cell
        assert len(np.unique(j_lbl[planar.reshape(-1)])) == 1


def _corner_depth():
    d1 = plane_depth(CAM, np.array([0.0, 0.0, 1.0]), -2500.0)
    d2 = plane_depth(CAM, np.array([0.7071, 0.0, 0.7071]), -2500.0)
    depth = np.minimum(np.where(d1 > 0, d1, 1e9), np.where(d2 > 0, d2, 1e9))
    depth[depth > 5900] = 0.0
    return depth.astype(np.float32)


def _scene_depth(name):
    """(depth, JAX camera, port camera) of one test scene."""
    if name == "wall":
        return plane_depth(CAM, np.array([0.0, 0.0, 1.0]), -2000.0), CAM, T_CAM
    if name == "tilted":
        n = np.array([0.3, 0.2, 0.93])
        return (np.clip(plane_depth(CAM, n / np.linalg.norm(n), -2500.0), 0, 5500),
                CAM, T_CAM)
    if name == "corner":
        return _corner_depth(), CAM, T_CAM
    if name == "cylinder":
        return cylinder_depth(CAM, radius=900.0, center_z=2200.0), CAM, T_CAM
    if name == "noise":
        return (np.random.default_rng(1000).uniform(500, 4000, (240, 320)), CAM, T_CAM)
    cam = tcfg.TUM_FR1
    q, p = synthetic.orbit_trajectory(60, speed_mm=4.0)[30]
    if name == "room":
        _, depth = synthetic.RoomScene(cam, depth_noise=tcfg.DepthNoiseModel()).render(q, p)
    else:
        _, depth = synthetic.TunnelScene(cam).render(q, p)
    return depth, jcfg.TUM_FR1, cam


#: scene -> (planes, cylinders) the JAX extraction finds there
SCENES = {"wall": (1, 0), "tilted": (1, 0), "corner": (2, 0), "cylinder": (0, 1),
          "noise": (0, 0), "room": (4, 0), "tunnel": (0, 1)}


def _within(port, ref, tol, name):
    err = np.abs(np.asarray(port, np.float64) - np.asarray(ref, np.float64))
    assert np.all(err <= tol), (name, err.max())


@pytest.mark.parametrize("scene", list(SCENES))
def test_find_primitives_matches_jax(scene):
    depth, j_cam, t_cam = _scene_depth(scene)
    depth = np.asarray(depth, np.float32)
    jp, jc = jax.tree.map(np.asarray, j_prim.find_primitives(jnp.asarray(depth), j_cam, CFG))
    tp, tc = primitives.find_primitives(_t(depth), t_cam, tcfg.DetectionConfig())
    tp, tc = [type(x)(*[f.numpy() for f in x]) for x in (tp, tc)]
    assert (int(jp.valid.sum()), int(jc.valid.sum())) == SCENES[scene]

    for f in ("valid", "poly_count", "cell_mask", "point_count"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f), err_msg=f)
    for f in ("valid", "cell_mask"):
        np.testing.assert_array_equal(getattr(tc, f), getattr(jc, f), err_msg=f"cyl.{f}")
    v = jp.valid
    d = np.abs(jp.params[v, 3])
    extent = np.abs(jp.poly_verts[v]).max(axis=(1, 2), initial=1.0)
    _within(tp.params[v, :3], jp.params[v, :3], 3e-5, "normal")
    _within(tp.params[v, 3], jp.params[v, 3], 1e-5 * d + 1e-3, "d")
    _within(tp.centroid[v], jp.centroid[v], 1e-6 * np.abs(jp.centroid[v]).max(initial=0)
            + 1e-3, "centroid")
    _within(tp.mse[v], jp.mse[v], 1e-6 * extent ** 2, "mse")
    _within(tp.cloud_cov[v], jp.cloud_cov[v], 1e-4 * np.abs(jp.cloud_cov[v]).max(initial=0),
            "cloud_cov")
    _within(tp.basis_center[v], jp.basis_center[v], (3e-5 * d + 1e-2)[:, None],
            "basis_center")
    _within(tp.basis_u[v], jp.basis_u[v], 1e-4, "basis_u")
    _within(tp.basis_v[v], jp.basis_v[v], 1e-4, "basis_v")
    for k in np.flatnonzero(v):
        n = jp.poly_count[k]
        _within(tp.poly_verts[k, :n], jp.poly_verts[k, :n],
                1e-4 * np.abs(jp.poly_verts[k, :n]).max(), "poly_verts")
    cv = jc.valid
    _within(tc.axis[cv], jc.axis[cv], 1e-5, "cyl.axis")
    _within(tc.center[cv], jc.center[cv], 1e-2, "cyl.center")
    _within(tc.radius[cv], jc.radius[cv], 1e-2, "cyl.radius")
    _within(tc.mse[cv], jc.mse[cv], 1e-6 * jc.radius[cv] ** 2, "cyl.mse")


def test_fit_cells_matches_jax():
    depth = _corner_depth()
    depth[:, 170:] += 800.0   # a discontinuity through cell column 8
    j_cloud, j_valid = j_depth_cloud.depth_to_cloud(jnp.asarray(depth), CAM)
    jg = jax.tree.map(np.asarray, j_prim.fit_cells(j_cloud, j_valid, CFG))
    tg = primitives.fit_cells(*depth_cloud.depth_to_cloud(_t(depth), T_CAM),
                              tcfg.DetectionConfig())
    np.testing.assert_array_equal(tg.planar.numpy(), jg.planar)
    np.testing.assert_array_equal(tg.count.numpy(), jg.count)
    p = jg.planar
    _within(tg.normal.numpy()[p], jg.normal[p], 3e-5, "normal")
    _within(tg.d.numpy()[p], jg.d[p], 1e-5 * np.abs(jg.d[p]) + 1e-3, "d")
    _within(tg.distance_tol.numpy(), jg.distance_tol, 1e-5 * jg.distance_tol + 1e-4, "tol")


# ---------------------------------------------------------------------------
# plane covariances, helpers and the plane Kalman update
# ---------------------------------------------------------------------------

def _planes(rng, k):
    n = rng.normal(size=(k, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return np.concatenate([n, rng.uniform(500, 3000, (k, 1))], -1).astype(np.float32)


def test_plane_covariances_match_jax():
    rng = np.random.default_rng(5)
    pl_cam, pl_world = _planes(rng, 8), _planes(rng, 8)
    cloud_cov = _spd(rng, 3, 8, 1e-3)
    cov44 = _spd(rng, 4, 8, 1e-4)
    pose_cov = _spd(rng, 3, 1, 1e-2)[0]
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    c2w[:3, 3] = [100.0, -50.0, 20.0]
    pairs = [
        (covariances.plane_covariance_from_point_cloud(_t(pl_cam), _t(cloud_cov)),
         j_cov.plane_covariance_from_point_cloud(pl_cam, cloud_cov)),
        (covariances.reduced_point_cloud_covariance_from_plane(_t(pl_cam), _t(cov44)),
         j_cov.reduced_point_cloud_covariance_from_plane(pl_cam, cov44)),
        (covariances.world_plane_covariance(_t(pl_cam), _t(pl_world), _t(c2w), _t(cov44),
                                            _t(pose_cov)),
         j_cov.world_plane_covariance(pl_cam, pl_world, c2w, cov44, pose_cov)),
    ]
    for t, j in pairs:
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=1e-4 * np.abs(j).max())
    points = rng.normal(0, 1000, (8, 3)).astype(np.float32)
    np.testing.assert_allclose(planes.plane_center(_t(pl_cam)).numpy(),
                               np.asarray(j_planes.plane_center(pl_cam)), rtol=1e-6)
    np.testing.assert_allclose(planes.point_distance(_t(pl_cam), _t(points)).numpy(),
                               np.asarray(j_planes.point_distance(pl_cam, points)),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(planes.cos_angle(_t(pl_cam), _t(pl_world)).numpy(),
                               np.asarray(j_planes.cos_angle(pl_cam, pl_world)), atol=1e-6)


def test_track_planes_matches_jax():
    rng = np.random.default_rng(6)
    state = _planes(rng, 8)
    obs = (state + rng.normal(0, [0.01, 0.01, 0.01, 5.0], (8, 4))).astype(np.float32)
    cov, ocov = _spd(rng, 4, 8, 1e-3), _spd(rng, 4, 8, 2e-3)
    j = j_kalman.track_planes(state, cov, obs, ocov)
    t = kalman.track_planes(_t(state), _t(cov), _t(obs), _t(ocov))
    np.testing.assert_allclose(t[0].numpy(), np.asarray(j[0]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(j[1])).max())
