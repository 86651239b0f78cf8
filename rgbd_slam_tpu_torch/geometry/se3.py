"""SE(3) / quaternion math (port of ``rgbd_slam_tpu/geometry/se3.py``).

Conventions are the JAX package's: quaternions ``[w, x, y, z]`` (Hamilton), camera
frame x-right / y-down / z-forward, world frame x-forward / y-left / z-up, and
``camera_to_world(q, p) = AXIS_CORRECTION_44 @ [R(q) | p]``.  Every function
broadcasts over leading axes and works under ``torch.func`` transforms.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_device

# Rotation taking camera-frame vectors to world-frame vectors:
# cam z (forward) -> world x, cam x (right) -> world -y, cam y (down) -> world -z.
AXIS_CORRECTION = np.array(
    [[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]]
)

_AXIS_CORRECTION_44 = np.eye(4)
_AXIS_CORRECTION_44[:3, :3] = AXIS_CORRECTION


@functools.lru_cache(maxsize=None)
def axis_correction_44(dtype, device):
    """``AXIS_CORRECTION`` as a 4x4 tensor, made once per dtype and device: a
    host-to-device copy on every use would synchronise the stream."""
    return torch.as_tensor(_AXIS_CORRECTION_44, dtype=dtype, device=device)


def quat_identity(dtype=torch.float32, device=None):
    device = resolve_device(device)
    q = torch.zeros(4, dtype=dtype, device=device)
    q[0].fill_(1.0)
    return q


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_multiply(a, b):
    """Hamilton product a*b, [w,x,y,z] layout; broadcasts over leading axes."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conjugate(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q, v):
    """Rotate vector(s) v by quaternion(s) q (without building the matrix)."""
    qv = q[..., 1:]
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + q[..., :1] * t + torch.linalg.cross(qv, t, dim=-1)


def quat_to_matrix(q):
    """Unit quaternion [w,x,y,z] -> 3x3 rotation matrix (batched)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m):
    """3x3 rotation matrix -> unit quaternion (batched, branch-free): the four
    candidate constructions are evaluated and the best conditioned one is picked
    with ``argmax`` (first maximum on ties, like ``jnp.argmax``)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tr = m00 + m11 + m22
    qs = torch.stack([1 + tr, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22,
                      1 - m00 - m11 + m22], dim=-1)
    case = torch.argmax(qs, dim=-1)

    def build(i):
        s = torch.sqrt(torch.clamp_min(qs[..., i], 1e-12)) * 2.0
        if i == 0:
            return torch.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s], -1)
        if i == 1:
            return torch.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s], -1)
        if i == 2:
            return torch.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s], -1)
        return torch.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s], -1)

    cands = torch.stack([build(i) for i in range(4)], dim=-2)
    idx = case[..., None, None].expand(case.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    return quat_normalize(q)


def quat_slerp(a, b, t):
    """Spherical interpolation (motion model)."""
    dot = torch.sum(a * b, dim=-1, keepdim=True)
    b = torch.where(dot < 0, -b, b)
    dot = torch.abs(dot)
    theta = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < 1e-6
    safe = torch.where(use_lerp, torch.ones_like(sin_theta), sin_theta)
    wa = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / safe)
    wb = torch.where(use_lerp, t * torch.ones_like(theta), torch.sin(t * theta) / safe)
    return quat_normalize(wa * a + wb * b)


# ---------------------------------------------------------------------------
# rigid transforms (4x4), with the fixed optical->physical axis correction
# ---------------------------------------------------------------------------

def make_transform(rotation_33, translation):
    """[R | t] as a 4x4 homogeneous matrix (batched)."""
    batch = torch.broadcast_shapes(rotation_33.shape[:-2], translation.shape[:-1])
    r = rotation_33.expand(batch + (3, 3))
    t = translation.expand(batch + (3,))
    top = torch.cat([r, t[..., None]], dim=-1)
    zeros = torch.zeros(batch + (1, 3), dtype=top.dtype, device=top.device)
    bottom = torch.cat([zeros, torch.ones_like(zeros[..., :1])], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def invert_transform(m):
    """Fast inverse of a rigid 4x4 transform."""
    rt = m[..., :3, :3].transpose(-1, -2)
    t = m[..., :3, 3]
    return make_transform(rt, -(rt @ t[..., None])[..., 0])


def camera_to_world(quat, position):
    """Pose (quat, position) -> camera->world 4x4 including the axis correction."""
    base = make_transform(quat_to_matrix(quat), position)
    return axis_correction_44(base.dtype, base.device) @ base


def world_to_camera(quat, position):
    """Pose -> world->camera 4x4."""
    return invert_transform(camera_to_world(quat, position))


def plane_camera_to_world_matrix(c2w):
    """4x4 transform acting on hessian plane vectors [n, d]:
    ``[[R, 0], [-t^T R, 1]]``."""
    r = c2w[..., :3, :3]
    t = c2w[..., :3, 3]
    last = -(t[..., None, :] @ r)[..., 0, :]
    zeros = torch.zeros(r.shape[:-1] + (1,), dtype=c2w.dtype, device=c2w.device)
    top = torch.cat([r, zeros], dim=-1)
    ones = torch.ones(last.shape[:-1] + (1,), dtype=c2w.dtype, device=c2w.device)
    return torch.cat([top, torch.cat([last, ones], dim=-1)[..., None, :]], dim=-2)


def plane_world_to_camera_matrix(w2c):
    """Inverse plane transform: the same construction applied to w2c."""
    return plane_camera_to_world_matrix(w2c)


# ---------------------------------------------------------------------------
# pose <-> optimization coefficients (stereographic quaternion projection)
# ---------------------------------------------------------------------------

def quat_to_stereographic(q):
    """Unit quaternion -> 3 stereographic coefficients (Terzakis et al.)."""
    divider = 1.0 / torch.clamp_min(1.0 + q[..., 3], 1e-3)
    return torch.stack([q[..., 0] * divider, q[..., 1] * divider,
                        q[..., 2] * divider], dim=-1)


def stereographic_to_quat(c):
    """3 coefficients -> unit quaternion [w,x,y,z]."""
    alpha = torch.sum(c * c, dim=-1)
    divider = 1.0 / (alpha + 1.0)
    return torch.stack([2.0 * c[..., 0] * divider, 2.0 * c[..., 1] * divider,
                        2.0 * c[..., 2] * divider, (1.0 - alpha) * divider], dim=-1)


def pose_to_coefficients(quat, position):
    """Pose -> 6-vector [position, stereographic(quat)]."""
    return torch.cat([position, quat_to_stereographic(quat)], dim=-1)


def coefficients_to_pose(coeffs):
    """6-vector -> (quat, position)."""
    return stereographic_to_quat(coeffs[..., 3:]), coeffs[..., :3]
