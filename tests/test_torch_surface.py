"""The port's public surface against the JAX package's.

(a) ``test_public_surface_matches`` reads the source of both packages with ``ast``
(it imports neither) and fails on any public top-level function, public class,
public method of a public class or parameter name of ``rgbd_slam_tpu`` that
``rgbd_slam_tpu_torch`` lacks, apart from the deliberate differences named in
``DELIBERATE`` (ROADMAP queue 1).  An entry of that list that no longer
excuses anything fails too, so the list cannot go stale.

(b) ``test_parity`` holds each function and parameter ported to close the gap to
the JAX function on seeded numpy inputs.  Where the JAX function draws from a
key, the port is given the same draws.  Tolerances: elementwise float32 math
to rtol 1e-5 (absolute 1e-4 px / 1e-5 on unit quantities, where a difference of
large nearly equal terms rounds); masks, flags and integer outputs equal; LM
solutions as ``tests/test_torch_pose.py`` holds them (1e-2 mm, 1e-5 in
quaternion and stereographic components) and Monte-Carlo covariances to 1e-2
of their scale.
"""

import ast
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_slam_tpu.config import TUM_FR1, EngineConfig
from rgbd_slam_tpu.geometry import basis as j_basis
from rgbd_slam_tpu.geometry import covariances as j_cov
from rgbd_slam_tpu.geometry import inverse_depth as j_idp
from rgbd_slam_tpu.geometry import lines as j_lines
from rgbd_slam_tpu.geometry import pinhole as j_pinhole
from rgbd_slam_tpu.geometry import se3 as j_se3
from rgbd_slam_tpu.mapping import maps as j_maps
from rgbd_slam_tpu.ops import fast as j_fast
from rgbd_slam_tpu.ops import image as j_image
from rgbd_slam_tpu.ops import optical_flow as j_flow
from rgbd_slam_tpu.pose import features as j_features
from rgbd_slam_tpu.pose import optimizer as j_opt
from rgbd_slam_tpu.pose import residuals as j_res
from rgbd_slam_tpu.tracking import kalman as j_kalman
from rgbd_slam_tpu.tracking import motion_model as j_motion
from rgbd_slam_tpu.utils import polygon as j_polygon
from rgbd_slam_tpu_torch.config import EngineConfig as TEngineConfig
from rgbd_slam_tpu_torch.geometry import basis, covariances, inverse_depth, lines, pinhole, se3
from rgbd_slam_tpu_torch.mapping import maps
from rgbd_slam_tpu_torch.ops import fast, image, optical_flow
from rgbd_slam_tpu_torch.pose import features, optimizer, residuals
from rgbd_slam_tpu_torch.pose.optimizer import PoseDraws
from rgbd_slam_tpu_torch.pose.residuals import VariationNoise
from rgbd_slam_tpu_torch.tracking import kalman, motion_model
from rgbd_slam_tpu_torch.utils import polygon

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CAM = TUM_FR1

#: the deliberate differences of the port's surface: JAX plumbing with no PyTorch
#: meaning (ROADMAP queue 1).  Module path -> why it has no counterpart file;
#: (module path, function) -> {parameter: what replaces it}.
DELIBERATE_MODULES = {
    "ops/pallas_lk.py": "the Pallas kernels are csrc/lk.cu, wrapped by ops/lk_cuda.py",
    "utils/compile_cache.py": "XLA's persistent compilation cache",
}
#: (module path, name) -> what replaces it: functions of the JAX package that the
#: port's own design removed
DELIBERATE_NAMES = {
    ("profiling.py", "device_trace"): "the run's own trace: StageTimer(log=True).export, "
                                      "run_frames(trace=...)",
}
_DRAWS = "the draws the key would give (injected randomness)"
_GROUPS = "a torch.distributed process group"
DELIBERATE_PARAMS = {
    ("ops/optical_flow.py", "lk_track"): {"use_pallas": "the CUDA kernel on a CUDA tensor"},
    ("ops/optical_flow.py", "track_forward_backward"): {
        "use_pallas": "the CUDA kernel on a CUDA tensor"},
    ("parallel/ba.py", "init_distributed"): {
        "coordinator_address": "init_method", "num_processes": "world_size",
        "process_id": "rank"},
    ("parallel/ba.py", "make_sharded_ba"): {"mesh": _GROUPS, "axis": _GROUPS},
    ("profiling.py", "StageTimer.stage"): {
        "block": "a span drains nothing; the step's device time comes from its stamps"},
    ("pose/optimizer.py", "compute_optimized_pose"): {"key": _DRAWS + ": draws"},
    ("pose/optimizer.py", "refit_with_variance"): {"key": _DRAWS + ": noise"},
    ("pose/optimizer.py", "compute_pose_variance"): {"key": _DRAWS + ": noise"},
    ("pose/residuals.py", "random_variation"): {"key": _DRAWS + ": noise"},
}


def _surface(package: Path):
    """{(module path, qualified name): parameter names or None} of the public
    top-level functions, classes and class methods under ``package``."""
    out = {}
    for path in sorted(package.rglob("*.py")):
        rel = path.relative_to(package).as_posix()
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and not node.name.startswith("_"):
                out[(rel, node.name)] = _params(node)
            elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
                out[(rel, node.name)] = None
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                            and not sub.name.startswith("_"):
                        out[(rel, f"{node.name}.{sub.name}")] = _params(sub)
    return out


def _params(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return names


def test_public_surface_matches():
    ref = _surface(ROOT / "rgbd_slam_tpu")
    port = _surface(ROOT / "rgbd_slam_tpu_torch")
    missing, used_modules, used_names, used_params = [], set(), set(), set()
    for (mod, name), params in ref.items():
        if mod in DELIBERATE_MODULES:
            used_modules.add(mod)
            continue
        if (mod, name) in DELIBERATE_NAMES:
            used_names.add((mod, name))
            continue
        if (mod, name) not in port:
            missing.append(f"{mod}: {name}")
            continue
        if params is None or port[(mod, name)] is None:
            continue
        excused = DELIBERATE_PARAMS.get((mod, name), {})
        for p in params:
            if p in port[(mod, name)]:
                continue
            if p in excused:
                used_params.add((mod, name, p))
            else:
                missing.append(f"{mod}: {name}({p}=)")
    assert not missing, "missing from the port: " + "; ".join(missing)
    stale = sorted(set(DELIBERATE_MODULES) - used_modules) + sorted(
        f"{m}: {n}" for m, n in set(DELIBERATE_NAMES) - used_names) + sorted(
        f"{m}: {n}({p}=)" for (m, n), ps in DELIBERATE_PARAMS.items() for p in ps
        if (m, n, p) not in used_params)
    assert not stale, "allow-list entries that excuse nothing: " + "; ".join(stale)


# ---------------------------------------------------------------------------
# (b) parity of each newly ported function and parameter
# ---------------------------------------------------------------------------

def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(port, ref, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(_np(port), _np(ref), rtol=rtol, atol=atol)


def _pose(rng):
    q = rng.normal(size=4).astype(np.float32) * [1.0, 0.1, 0.1, 0.1]
    q = (q / np.linalg.norm(q)).astype(np.float32)
    p = rng.uniform(-200, 200, 3).astype(np.float32)
    return q, p


def _world_in_view(rng, c2w, n, z=(800.0, 4000.0)):
    """World points whose camera depths lie in ``z`` and whose pixels fall in the
    image, with their pixels."""
    uv = rng.uniform([20, 20], [620, 460], (n, 2))
    depth = rng.uniform(*z, (n, 1))
    cam_pts = np.concatenate([(uv - [CAM.cx, CAM.cy]) / [CAM.fx, CAM.fy] * depth, depth], -1)
    return (cam_pts @ c2w[:3, :3].T + c2w[:3, 3]).astype(np.float32), uv.astype(np.float32)


def _scene(seed):
    """Seeded matched features of all four types around a posed camera, the
    pose and its w2c.  Points carry 0.3 px noise and 6 gross outliers."""
    rng = np.random.default_rng(seed)
    q, p = _pose(rng)
    c2w = np.asarray(j_se3.camera_to_world(q, p))
    w2c = np.asarray(j_se3.world_to_camera(q, p))
    world, uv = _world_in_view(rng, c2w, 40)
    obs = uv + rng.normal(0, 0.3, uv.shape).astype(np.float32)
    obs[:6] += rng.uniform(20, 60, (6, 2)).astype(np.float32)
    # inverse-depth points first seen from 150-300 mm off this camera, so that
    # their +-3 sigma spans project to segments, not to points
    target, uv2 = _world_in_view(rng, c2w, 10, z=(1500.0, 2500.0))
    origin = c2w[:3, 3] + rng.uniform(150, 300, (10, 3)) * rng.choice([-1, 1], (10, 3))
    rays = target - origin
    theta = np.arctan2(np.hypot(rays[:, 0], rays[:, 1]), rays[:, 2])
    phi = np.arctan2(rays[:, 1], rays[:, 0])
    state2d = np.concatenate([origin, 1.0 / np.linalg.norm(rays, axis=-1)[:, None],
                              theta[:, None], phi[:, None]], -1)
    n_w = rng.normal(size=(4, 3))
    n_w /= np.linalg.norm(n_w, axis=-1, keepdims=True)
    plane_world = np.concatenate([n_w, rng.uniform(-2000, 2000, (4, 1))], -1)
    plane_cam = plane_world @ np.asarray(j_se3.plane_world_to_camera_matrix(w2c)).T
    plane_cam[:, :3] += rng.normal(0, 0.01, (4, 3))
    e0, l0 = _world_in_view(rng, c2w, 5)
    e1, l1 = _world_in_view(rng, c2w, 5)
    f32 = np.float32
    arrays = dict(
        point_obs_uv=obs, point_world=world, point_world_std=np.full((40, 3), 5.0, f32),
        point2d_obs_uv=(uv2 + rng.normal(0, 0.5, uv2.shape)).astype(f32),
        point2d_state=state2d.astype(f32),
        point2d_state_std=np.tile([1.0, 1.0, 1.0, 2.5e-4, 0.01, 0.01], (10, 1)).astype(f32),
        plane_cam=plane_cam.astype(f32), plane_world=plane_world.astype(f32),
        plane_world_std=np.tile([0.01, 0.01, 0.01, 5.0], (4, 1)).astype(f32),
        line_obs_p0=(l0 + rng.normal(0, 0.5, l0.shape)).astype(f32),
        line_obs_p1=(l1 + rng.normal(0, 0.5, l1.shape)).astype(f32),
        line_world=np.concatenate([e0, e1], -1),
        line_world_std=np.full((5, 6), 5.0, f32))
    caps = (64, 16, 8, 8)
    j_feats = j_features.make_matched_features(**arrays, capacities=caps)
    t_feats = features.make_matched_features(**arrays, capacities=caps, device="cpu")
    return dict(rng=rng, q=q, p=p, c2w=c2w, w2c=w2c, j=j_feats, t=t_feats, arrays=arrays)


def _variation_draws(key, feats):
    """The five standard-normal draws ``residuals.random_variation`` makes from
    ``key`` for ``feats`` (residuals.py:236-258)."""
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    n = jax.random.normal
    return VariationNoise(
        _t(n(k1, feats.point_world.shape, jnp.float32)),
        _t(n(k2, feats.point2d_state.shape[:-1], jnp.float32)),
        _t(n(k3, feats.point2d_state.shape[:-1], jnp.float32)),
        _t(n(k4, feats.plane_world.shape, jnp.float32)),
        _t(n(k5, feats.line_world.shape, jnp.float32)))


def _close_coeffs(port, ref):
    """LM solutions: position to 1e-2 mm, stereographic components to 1e-5."""
    port, ref = _np(port), _np(ref)
    np.testing.assert_allclose(port[..., :3], ref[..., :3], atol=1e-2)
    np.testing.assert_allclose(port[..., 3:], ref[..., 3:], atol=1e-5)


def case_spherical_to_cartesian_jacobian(rng):
    sph = np.stack([rng.uniform(100, 5000, 32), rng.uniform(0, np.pi, 32),
                    rng.uniform(-np.pi, np.pi, 32)], -1).astype(np.float32)
    _close(basis.spherical_to_cartesian_jacobian(_t(sph)),
           j_basis.spherical_to_cartesian_jacobian(sph), atol=1e-3)


def case_cartesian_to_spherical_jacobian(rng):
    xyz = rng.uniform(-3000, 3000, (32, 3)).astype(np.float32)
    xyz[0, :2] = 0.0   # on the z axis: the epsilon guard
    _close(basis.cartesian_to_spherical_jacobian(_t(xyz)),
           j_basis.cartesian_to_spherical_jacobian(xyz))


def case_is_covariance_valid(rng):
    a = rng.normal(size=(24, 4, 4)).astype(np.float32)
    cov = a @ np.swapaxes(a, -1, -2)
    cov[:6] -= 3.0 * np.eye(4, dtype=np.float32)       # indefinite
    cov[6:9, 0, 1] += 1e-3                               # asymmetric
    cov[9, 2, 2] = np.nan
    got = covariances.is_covariance_valid(_t(cov))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_cov.is_covariance_valid(cov)))
    assert 0 < int(got.sum()) < 24


def case_camera_to_screen_covariance(rng):
    pts = np.concatenate([rng.uniform(-1000, 1000, (16, 2)), rng.uniform(500, 4000, (16, 1))],
                         -1).astype(np.float32)
    a = rng.normal(size=(16, 3, 3)).astype(np.float32)
    cov = a @ np.swapaxes(a, -1, -2)
    _close(covariances.camera_to_screen_covariance(_t(pts), _t(cov), CAM),
           j_cov.camera_to_screen_covariance(pts, cov, CAM), rtol=1e-4, atol=1e-6)


def _idp_inputs(rng):
    s = _scene(int(rng.integers(1 << 16)))
    a = s["arrays"]
    rho_var = (a["point2d_state_std"][:, 3] ** 2 * rng.uniform(0.5, 4, 10)).astype(np.float32)
    return s, a["point2d_state"], rho_var, a["point2d_obs_uv"]


def case_to_screen_segment(rng):
    s, state, rho_var, _ = _idp_inputs(rng)
    got = inverse_depth.to_screen_segment(_t(state), _t(rho_var), _t(s["w2c"]), CAM)
    want = j_idp.to_screen_segment(state, rho_var, s["w2c"], CAM)
    _close(got[0], want[0], rtol=1e-4, atol=1e-3)
    _close(got[1], want[1], rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def case_signed_screen_distance(rng):
    s, state, rho_var, obs = _idp_inputs(rng)
    _close(inverse_depth.signed_screen_distance(_t(state), _t(rho_var), _t(obs),
                                                _t(s["w2c"]), CAM),
           j_idp.signed_screen_distance(state, rho_var, obs, s["w2c"], CAM),
           rtol=1e-4, atol=1e-3)


def case_signed_line_distance_to_observation(rng):
    s, state, _, obs = _idp_inputs(rng)
    _close(inverse_depth.signed_line_distance_to_observation(_t(state), _t(obs),
                                                             _t(s["w2c"]), CAM),
           j_idp.signed_line_distance_to_observation(state, obs, s["w2c"], CAM),
           rtol=1e-3, atol=1e-2)


def _line_pairs(rng):
    p1, p2 = (rng.uniform(-500, 500, (16, 3)).astype(np.float32) for _ in range(2))
    d1 = rng.normal(size=(16, 3)).astype(np.float32)
    d2 = rng.normal(size=(16, 3)).astype(np.float32)
    d2[:3] = d1[:3] * 2.0     # parallel pairs: the fallback
    return p1, d1, p2, d2


def case_line_line_closest_points(rng):
    args = _line_pairs(rng)
    got = lines.line_line_closest_points(*map(_t, args))
    want = j_lines.line_line_closest_points(*args)
    _close(got[0], want[0], rtol=1e-4, atol=1e-2)
    _close(got[1], want[1], rtol=1e-4, atol=1e-2)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert bool(got[2][:3].all())


def case_signed_line_distance(rng):
    args = _line_pairs(rng)
    _close(lines.signed_line_distance(*map(_t, args)), j_lines.signed_line_distance(*args),
           rtol=1e-4, atol=1e-2)


def _projection_inputs(rng):
    s = _scene(int(rng.integers(1 << 16)))
    world = s["arrays"]["point_world"].copy()
    world[:3] = s["c2w"][:3, 3] - 100.0 * s["c2w"][:3, 2]   # behind the camera: big
    return s, world, s["arrays"]["point_obs_uv"]


def case_signed_screen_distance_2d(rng):
    s, world, obs = _projection_inputs(rng)
    _close(pinhole.signed_screen_distance_2d(_t(world), _t(obs), _t(s["w2c"]), CAM),
           j_pinhole.signed_screen_distance_2d(world, obs, s["w2c"], CAM), atol=1e-3)


def case_screen_distance_px(rng):
    s, world, obs = _projection_inputs(rng)
    _close(pinhole.screen_distance_px(_t(world), _t(obs), _t(s["w2c"]), CAM),
           j_pinhole.screen_distance_px(world, obs, s["w2c"], CAM), atol=1e-3)


def case_quat_from_axis_angle(rng):
    axis = rng.normal(size=(16, 3)).astype(np.float32)
    angle = rng.uniform(-np.pi, np.pi, 16).astype(np.float32)
    _close(se3.quat_from_axis_angle(_t(axis), _t(angle)),
           j_se3.quat_from_axis_angle(axis, angle), atol=1e-6)


def case_quat_from_euler(rng):
    yaw, pitch, roll = rng.uniform(-np.pi, np.pi, (3, 16)).astype(np.float32)
    _close(se3.quat_from_euler(_t(yaw), _t(pitch), _t(roll)),
           j_se3.quat_from_euler(yaw, pitch, roll), atol=1e-6)
    _close(se3.quat_from_euler(0.3, -0.2, 0.1), j_se3.quat_from_euler(0.3, -0.2, 0.1),
           atol=1e-6)


def _quat_pairs(rng):
    a = rng.normal(size=(16, 4)).astype(np.float32)
    b = a + rng.normal(0, 0.2, a.shape).astype(np.float32)
    b[0] = -a[0]     # the same rotation
    return (a / np.linalg.norm(a, axis=-1, keepdims=True),
            b / np.linalg.norm(b, axis=-1, keepdims=True))


def case_quat_angle_distance(rng):
    a, b = _quat_pairs(rng)
    _close(se3.quat_angle_distance(_t(a), _t(b)), j_se3.quat_angle_distance(a, b), atol=1e-3)


def case_rotation_error_deg(rng):
    a, b = _quat_pairs(rng)
    _close(se3.rotation_error_deg(_t(a), _t(b)), j_se3.rotation_error_deg(a, b), atol=5e-2)


def case_position_error(rng):
    a, b = rng.uniform(-1e3, 1e3, (2, 16, 3)).astype(np.float32)
    _close(se3.position_error(_t(a), _t(b)), j_se3.position_error(a, b))


def case_camera_to_world_no_correction(rng):
    q, p = _pose(rng)
    _close(se3.camera_to_world_no_correction(_t(q), _t(p)),
           j_se3.camera_to_world_no_correction(q, p), atol=1e-5)


def case_world_to_camera_no_correction(rng):
    q, p = _pose(rng)
    _close(se3.world_to_camera_no_correction(_t(q), _t(p)),
           j_se3.world_to_camera_no_correction(q, p), atol=1e-4)


def _image(rng):
    img = rng.uniform(0, 255, (48, 64)).astype(np.float32)
    img[10:30, 20:40] += 80.0
    return img


def case_fast_response(rng):
    img = _image(rng)
    got_c, got_s = fast.fast_response(_t(img), 20.0)
    want_c, want_s = j_fast.fast_response(jnp.asarray(img), 20.0)
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    _close(got_s, want_s, rtol=1e-5, atol=1e-3)
    assert int(got_c.sum()) > 0


def case_gaussian_blur5(rng):
    img = _image(rng)
    _close(image.gaussian_blur5(_t(img)), j_image.gaussian_blur5(jnp.asarray(img)),
           atol=1e-4)


def case_sample_window(rng):
    img = _image(rng)
    corners = np.concatenate([rng.uniform(-3, 60, (8, 1)), rng.uniform(-3, 45, (8, 1))],
                             -1).astype(np.float32)
    want = jax.vmap(lambda c: j_flow.sample_window(jnp.asarray(img), c, 7, 9))(corners)
    _close(optical_flow.sample_window(_t(img), _t(corners), 7, 9), want, atol=1e-4)
    _close(optical_flow.sample_window(_t(img), _t(corners[0]), 7, 9), want[0], atol=1e-4)


def case_make_matched_features(rng):
    s = _scene(int(rng.integers(1 << 16)))
    for name, got, want in zip(s["t"]._fields, s["t"], s["j"]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
    short = features.make_matched_features(point_obs_uv=np.zeros((70, 2), np.float32),
                                           device="cpu")
    assert int(short.point_mask.sum()) == 64 and short.capacities == (64, 32, 8, 8)


def case_total_score(rng):
    s = _scene(int(rng.integers(1 << 16)))
    _close(s["t"].total_score(), s["j"].total_score())


def case_split_unified(rng):
    s = _scene(int(rng.integers(1 << 16)))
    u = rng.normal(size=(3, sum(s["t"].capacities))).astype(np.float32)
    for got, want in zip(s["t"].split_unified(_t(u)), s["j"].split_unified(u)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def case_point_residuals(rng):
    s = _scene(int(rng.integers(1 << 16)))
    _close(residuals.point_residuals(s["t"], _t(s["w2c"]), CAM),
           j_res.point_residuals(s["j"], s["w2c"], CAM), atol=1e-3)


def case_point2d_residuals(rng):
    s = _scene(int(rng.integers(1 << 16)))
    _close(residuals.point2d_residuals(s["t"], _t(s["w2c"]), CAM),
           j_res.point2d_residuals(s["j"], s["w2c"], CAM), rtol=1e-4, atol=1e-3)


def case_plane_residuals(rng):
    s = _scene(int(rng.integers(1 << 16)))
    _close(residuals.plane_residuals(s["t"], _t(s["w2c"]), CAM),
           j_res.plane_residuals(s["j"], s["w2c"], CAM), rtol=1e-4, atol=1e-2)


def case_residual_vector_weights(rng):
    """The JAX ``residual_vector(weights=)`` unpacks three of the four blocks and
    raises; the port masks all four, as the JAX ``lm_solve(weights=)`` does, so it
    is held to the JAX residuals of the masked features."""
    s = _scene(int(rng.integers(1 << 16)))
    coeffs = np.asarray(j_se3.pose_to_coefficients(s["q"], s["p"] + 5.0))
    w = (rng.uniform(size=sum(s["t"].capacities)) > 0.4).astype(np.float32)
    with pytest.raises(ValueError):
        j_res.residual_vector(coeffs, s["j"], CAM, weights=w)
    masks = [m > 0 for m in s["j"].split_unified(w)]
    want = j_res.residual_vector(coeffs, s["j"].with_masks(*masks), CAM)
    _close(residuals.residual_vector(_t(coeffs), s["t"], CAM, weights=_t(w)), want,
           rtol=1e-4, atol=1e-2)
    _close(residuals.residual_vector(_t(coeffs), s["t"], CAM),
           j_res.residual_vector(coeffs, s["j"], CAM), rtol=1e-4, atol=1e-2)


def case_inlier_masks(rng):
    s = _scene(int(rng.integers(1 << 16)))
    got = residuals.inlier_masks(_t(s["q"]), _t(s["p"]), s["t"], CAM)
    want = j_res.inlier_masks(s["q"], s["p"], s["j"], CAM)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < int(got[0].sum()) < 40


def case_random_variation_scale(rng):
    s = _scene(int(rng.integers(1 << 16)))
    key = jax.random.PRNGKey(int(rng.integers(1 << 16)))
    want = j_res.random_variation(s["j"], key, scale=0.5)
    got = residuals.random_variation(s["t"], _variation_draws(key, s["j"]), scale=0.5)
    for name in ("point_world", "point2d_state", "plane_world", "line_world"):
        _close(getattr(got, name), getattr(want, name), atol=1e-4)


def case_lm_solve_weights(rng):
    s = _scene(int(rng.integers(1 << 16)))
    c0 = np.asarray(j_se3.pose_to_coefficients(s["q"], s["p"] + np.float32(20.0)))
    w = np.zeros(sum(s["t"].capacities), np.float32)
    w[6:40] = 1.0                 # the 34 inlying points, no outlier
    want, _ = jax.jit(j_opt.lm_solve, static_argnames=("cam", "iterations"))(
        c0, s["j"], CAM, weights=w, iterations=5)
    got, _ = optimizer.lm_solve(_t(c0), s["t"], CAM, weights=_t(w), iterations=5)
    _close_coeffs(got, want)


def case_compute_optimized_pose_no_covariance(rng):
    s = _scene(int(rng.integers(1 << 16)))
    eng = dict(pose_covariance_mc_iterations=8, ransac_hypothesis_batch=16,
               p3p_hypothesis_batch=8, lm_iterations=5, refit_lm_iterations=4)
    j_cfg, t_cfg = EngineConfig(**eng), TEngineConfig(**eng)
    key = jax.random.PRNGKey(3)
    q0 = s["q"]
    p0 = (s["p"] + np.float32(15.0)).astype(np.float32)
    want = jax.jit(j_opt.compute_optimized_pose,
                   static_argnames=("cam", "engine_cfg", "compute_covariance"))(
        key, q0, p0, s["j"], CAM, engine_cfg=j_cfg, compute_covariance=False)
    k_subsets, k_p3p, _ = jax.random.split(key, 3)
    draws = PoseDraws(
        subset_priority=_t(jax.random.uniform(
            k_subsets, (j_cfg.ransac_hypothesis_batch, sum(s["t"].capacities)))),
        p3p_priority=_t(jax.random.uniform(k_p3p, (j_cfg.p3p_hypothesis_batch, 64))),
        noise=None)
    got = optimizer.compute_optimized_pose(_t(q0), _t(p0), s["t"], CAM, engine_cfg=t_cfg,
                                           draws=draws, compute_covariance=False)
    assert bool(got.success) == bool(want.success) and bool(got.success)
    for name in ("point_inliers", "point2d_inliers", "plane_inliers", "line_inliers"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.position.numpy(), np.asarray(want.position), atol=1e-2)
    np.testing.assert_allclose(got.quat.numpy(), np.asarray(want.quat), atol=1e-5)
    np.testing.assert_array_equal(got.covariance.numpy(), np.asarray(want.covariance))


def case_compute_pose_variance(rng):
    s = _scene(int(rng.integers(1 << 16)))
    inliers = j_opt.compact_features(s["j"], (48, 16, 8, 8))
    inliers_t = optimizer.compact_features(s["t"], (48, 16, 8, 8))
    c0 = np.asarray(j_se3.pose_to_coefficients(s["q"], s["p"]))
    key = jax.random.PRNGKey(int(rng.integers(1 << 16)))
    want = jax.jit(j_opt.compute_pose_variance,
                   static_argnames=("cam", "iterations", "lm_iterations"))(
        key, c0, inliers, CAM, iterations=8, lm_iterations=3)
    draws = [_variation_draws(k, inliers) for k in jax.random.split(key, 8)]
    noise = VariationNoise(*[torch.stack(x) for x in zip(*draws)])
    got = optimizer.compute_pose_variance(_t(c0), inliers_t, CAM, noise, iterations=8,
                                          lm_iterations=3)
    want = np.asarray(want)
    scale = np.sqrt(np.outer(np.diag(want), np.diag(want)))
    assert np.all(np.abs(got.numpy() - want) <= 1e-2 * scale)


def _kalman_inputs(rng, batch, n, m):
    a = rng.normal(size=batch + (n, n)).astype(np.float32)
    cov = a @ np.swapaxes(a, -1, -2) + np.eye(n, dtype=np.float32)
    b = rng.normal(size=batch + (m, m)).astype(np.float32)
    meas_cov = b @ np.swapaxes(b, -1, -2) + np.eye(m, dtype=np.float32)
    return (rng.normal(size=batch + (n,)).astype(np.float32), cov,
            rng.normal(size=batch + (m,)).astype(np.float32), meas_cov)


def case_kalman_step_dynamics_output(rng):
    state, cov, meas, meas_cov = _kalman_inputs(rng, (5,), 4, 2)
    dyn = (np.eye(4) + 0.1 * rng.normal(size=(4, 4))).astype(np.float32)
    out = rng.normal(size=(2, 4)).astype(np.float32)
    q = (0.01 * np.eye(4)).astype(np.float32)
    got = kalman.kalman_step(_t(state), _t(cov), _t(meas), _t(meas_cov), dynamics=_t(dyn),
                             output=_t(out), process_noise=_t(q))
    want = j_kalman.kalman_step(state, cov, meas, meas_cov, dynamics=dyn, output=out,
                                process_noise=q)
    _close(got[0], want[0], rtol=1e-4, atol=1e-4)
    _close(got[1], want[1], rtol=1e-4, atol=1e-4)


def case_kalman_step_vectorized(rng):
    state, cov, _, _ = _kalman_inputs(rng, (2, 1), 3, 3)
    _, _, meas, meas_cov = _kalman_inputs(rng, (4,), 3, 3)
    got = kalman.kalman_step_vectorized(_t(state), _t(cov), _t(meas), _t(meas_cov))
    want = j_kalman.kalman_step_vectorized(state, cov, meas, meas_cov)
    assert got[0].shape == (2, 4, 3) and got[1].shape == (2, 4, 3, 3)
    _close(got[0], want[0], rtol=1e-4, atol=1e-4)
    _close(got[1], want[1], rtol=1e-4, atol=1e-4)


def case_lifecycle_update_staged_drop(rng):
    is_local = rng.uniform(size=64) < 0.5
    mc = rng.integers(0, 3, 64).astype(np.int32)
    miss = rng.integers(0, 12, 64).astype(np.int32)
    matched = rng.uniform(size=64) < 0.4
    for drop in (True, False):
        want = j_maps.lifecycle_update(is_local, mc, miss, matched, 3, 10,
                                       staged_drop_at_zero=drop)
        got = maps.lifecycle_update(_t(is_local), _t(mc), _t(miss), _t(matched), 3, 10,
                                    staged_drop_at_zero=drop)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def case_predict_next_pose_inflation(rng):
    j_state = j_motion.reset()
    t_state = motion_model.reset(device="cpu")
    for i in range(3):
        q, p = _pose(rng)
        j_state, jq, jp, j_infl = j_motion.predict_next_pose(
            j_state, q, p, should_increase_variance=i > 0)
        t_state, tq, tp, t_infl = motion_model.predict_next_pose(
            t_state, _t(q), _t(p), should_increase_variance=i > 0)
        _close(tq, jq, atol=1e-6)
        _close(tp, jp, atol=1e-4)
        np.testing.assert_array_equal(t_infl.numpy(), np.asarray(j_infl))


def case_unproject_from_plane(rng):
    n = rng.normal(size=3).astype(np.float32)
    u, v = j_polygon.plane_basis(n / np.linalg.norm(n))
    center = rng.uniform(-500, 500, 3).astype(np.float32)
    pts2 = rng.uniform(-300, 300, (12, 2)).astype(np.float32)
    got = polygon.unproject_from_plane(_t(pts2), _t(center), _t(u), _t(v))
    _close(got, j_polygon.unproject_from_plane(pts2, center, u, v), atol=1e-3)
    _close(polygon.project_to_plane(got, _t(center), _t(u), _t(v)), pts2, atol=1e-3)


CASES = {name[len("case_"):]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_parity(name):
    CASES[name](np.random.default_rng(zlib.crc32(name.encode())))
