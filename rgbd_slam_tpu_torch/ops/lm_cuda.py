"""The pose optimizer's Levenberg-Marquardt solve: the CUDA kernel's wrapper and
its plain PyTorch version.

``lm_solve(inputs, coeffs0, iterations, damping0)`` runs the fixed-iteration
damped least squares of ``rgbd_slam_tpu/pose/optimizer.py:50`` (``lm_solve``,
which XLA compiles from an unrolled ``lax.scan`` over ``jax.linearize``) on a
batch of poses.  ``inputs`` is an :class:`LMInputs`: the prepared features of
``pose/residuals.prepare_features`` as contiguous tensors, the masks as uint8,
and the pinhole intrinsics.  For CUDA tensors it launches ``lm_solve_kernel``
(``csrc/lm.cu``: one CTA a batch member over its live features, forward-mode
tangents in registers, a transposing warp reduction in a fixed order, the LM
state on six lanes of every warp) or raises; for CPU
tensors it runs :func:`lm_solve_reference`, the ``vmap(jvp)`` linearization and
``linalg6.solve6_spd`` as tensor code.

``details=True`` also returns the best point's normal equations, the accept
decisions and a trace of every linearization (where, its cost and normal
equations), from the kernel and from the plain version alike, so that a run can
be checked step by step (``chip_smoke.lm_replay``).

A feature block with no batch axis is shared by every member: the kernel reads
it with a batch stride of 0.  The kernel is compiled with ``nvcc`` on first use
(:mod:`.nvcc`) and bound with ctypes; it launches on the current stream and
reads nothing back, so a CUDA graph can record it.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch
from torch.func import jvp, vmap

from ..pose.features import LINE_ALPHA, PLANE_ALPHA, POINT2D_ALPHA, POINT_ALPHA
from ..pose.linalg6 import solve6_spd
from ..pose.residuals import PreparedFeatures, residual_vector_prepared
from . import nvcc

#: each block's scale, alpha / parts (``residual_vector_prepared``)
SCALES = (POINT_ALPHA / 2.0, POINT2D_ALPHA / 2.0, PLANE_ALPHA / 3.0, LINE_ALPHA / 2.0)

#: FLOPs the kernel's forward-mode arithmetic spends (value and six tangents;
#: counted from ``csrc/lm.cu`` at 1 a float operation: a dual sum or a product
#: with a constant 7, a dual product or quotient 19, a dual root 13, a world
#: point's projection 180): a live feature of each type, an inverse-depth point
#: charged its segment branch
FLOPS_POINT, FLOPS_POINT2D, FLOPS_PLANE, FLOPS_LINE = 208, 640, 243, 609
#: a residual row into the normal equations: 21 + 6 + 1 multiply-adds
FLOPS_ROW = 56
#: the pose and its tangents, once a linearization; the damped 6x6 solve and
#: the trial, once an iteration
FLOPS_POSE, FLOPS_SOLVE = 1037, 199
#: floats of a row of the kernel's trace (``LM_TRACE`` in ``csrc/lm.cu``): the
#: point, its cost, JtJ's upper triangle in row order, Jtr
TRACE_ROW = 34
#: most threads a CTA (``LM_MAX_THREADS`` in ``csrc/lm.cu``)
MAX_THREADS = 128
#: most features a member: the kernel lists a member's live features in shared
#: memory, 4 bytes each, within ``LM_MAX_LIST_BYTES``
MAX_FEATURES = 8192


class LMInputs(NamedTuple):
    """The packed inputs of the LM solve (the fields of ``PreparedFeatures``).
    Each block has either no batch axis (shared) or the poses' batch axes."""
    pts_world: torch.Tensor       # [.., NP + 2 N2 + 2 NL, 3] f32
    point_obs_uv: torch.Tensor    # [.., NP, 2] f32
    point_mask: torch.Tensor      # [.., NP] uint8
    point2d_obs_uv: torch.Tensor  # [.., N2, 2] f32
    point2d_mask: torch.Tensor    # [.., N2] uint8
    plane_world: torch.Tensor     # [.., NK, 4] f32
    plane_cam: torch.Tensor       # [.., NK, 4] f32
    plane_mask: torch.Tensor      # [.., NK] uint8
    line_obs_p0: torch.Tensor     # [.., NL, 2] f32
    line_obs_p1: torch.Tensor     # [.., NL, 2] f32
    line_mask: torch.Tensor       # [.., NL] uint8
    fx: float
    fy: float
    cx: float
    cy: float

    @property
    def capacities(self):
        return (self.point_mask.shape[-1], self.point2d_mask.shape[-1],
                self.plane_mask.shape[-1], self.line_mask.shape[-1])


class Pinhole(NamedTuple):
    """The intrinsics the residuals read (``CameraIntrinsics``' fx, fy, cx, cy)."""
    fx: float
    fy: float
    cx: float
    cy: float


class LMResult(NamedTuple):
    """What ``details=True`` returns: the best point, its cost and normal
    equations, which iterations accepted their trial (bit i: iteration i + 1,
    for the first 63), and the trace of the L = iterations + 1 linearizations:
    where each was taken (the start, then each trial), its cost and its normal
    equations."""
    coeffs: torch.Tensor    # [..., 6]
    cost: torch.Tensor      # [...]
    jtj: torch.Tensor       # [..., 6, 6]
    jtr: torch.Tensor       # [..., 6]
    accepts: torch.Tensor   # [...] int64
    points: torch.Tensor    # [..., L, 6]
    costs: torch.Tensor     # [..., L]
    jtjs: torch.Tensor      # [..., L, 6, 6]
    jtrs: torch.Tensor      # [..., L, 6]


def pack(prep: PreparedFeatures, cam) -> LMInputs:
    """The packed layout of prepared features: contiguous f32 blocks and the
    bool masks viewed as uint8 (no copy where a block is contiguous)."""
    def mask(m):
        return m.contiguous().view(torch.uint8)

    return LMInputs(
        pts_world=prep.pts_world.contiguous(), point_obs_uv=prep.point_obs_uv.contiguous(),
        point_mask=mask(prep.point_mask), point2d_obs_uv=prep.point2d_obs_uv.contiguous(),
        point2d_mask=mask(prep.point2d_mask), plane_world=prep.plane_world.contiguous(),
        plane_cam=prep.plane_cam.contiguous(), plane_mask=mask(prep.plane_mask),
        line_obs_p0=prep.line_obs_p0.contiguous(), line_obs_p1=prep.line_obs_p1.contiguous(),
        line_mask=mask(prep.line_mask), fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy)


def prepared(inputs: LMInputs) -> PreparedFeatures:
    """The packed inputs as ``PreparedFeatures`` again (views)."""
    def mask(m):
        return m.view(torch.bool)

    return PreparedFeatures(
        pts_world=inputs.pts_world, point_obs_uv=inputs.point_obs_uv,
        point_mask=mask(inputs.point_mask), point2d_obs_uv=inputs.point2d_obs_uv,
        point2d_mask=mask(inputs.point2d_mask), plane_world=inputs.plane_world,
        plane_cam=inputs.plane_cam, plane_mask=mask(inputs.plane_mask),
        line_obs_p0=inputs.line_obs_p0, line_obs_p1=inputs.line_obs_p1,
        line_mask=mask(inputs.line_mask))


class _Args(ctypes.Structure):
    """``LMArgs`` of ``csrc/lm.cu``, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "pts", "point_obs", "point_mask", "p2d_obs", "p2d_mask", "plane_world", "plane_cam",
        "plane_mask", "line_p0", "line_p1", "line_mask", "coeffs0", "coeffs", "cost", "jtj",
        "jtr", "accepts", "trace")]
        + [("stride", ctypes.c_longlong * 11)]
        + [(name, ctypes.c_int) for name in ("batch", "np", "n2", "nk", "nl", "iterations")]
        + [(name, ctypes.c_float) for name in ("fx", "fy", "cx", "cy", "damping0")]
        + [("scale", ctypes.c_float * 4)])


def _bind(lib):
    lib.lm_solve_launch.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
    lib.lm_solve_launch.restype = ctypes.c_int


LIBRARY = nvcc.Library("lm.cu", _bind, launches=("lm_solve",))
#: launches of the CUDA kernel since import (``LIBRARY.launches``)
LAUNCHES = LIBRARY.launches


def lm_solve(inputs: LMInputs, coeffs0, iterations: int, damping0: float,
             details: bool = False):
    """Fixed-iteration LM from ``coeffs0`` [..., 6]: the kernel for CUDA
    tensors, the plain version for CPU tensors.  Returns (coeffs [..., 6], cost
    [...]), or an :class:`LMResult` with ``details``.  A single pose [6] runs as
    a batch of one."""
    if coeffs0.dim() == 1:
        out = [t[0] for t in lm_solve(inputs, coeffs0[None], iterations, damping0, details)]
        return LMResult(*out) if details else tuple(out)
    if coeffs0.device.type == "cuda":
        return lm_solve_cuda(inputs, coeffs0, iterations, damping0, details)
    if coeffs0.device.type == "cpu":
        return lm_solve_reference(inputs, coeffs0, iterations, damping0, details)
    raise ValueError(f"unsupported device {coeffs0.device}")


def lm_solve_reference(inputs: LMInputs, coeffs0, iterations: int, damping0: float,
                       details: bool = False):
    """The plain version: the residual's Jacobian by ``vmap(jvp)`` over the six
    unit tangents, the normal equations as products, the damped system by
    ``solve6_spd``; batched over the leading axes of ``coeffs0`` [..., 6] and of
    the feature blocks.

    LM accept/reject with deferred evaluation: each iteration linearizes the
    residual once at the pending trial point, folds the trial into the running
    best if its cost decreased (damping /2 on accept, x4 on reject), and emits
    the next trial from the best point's normal equations."""
    dt = coeffs0.dtype
    prep = prepared(inputs)
    cam = Pinhole(inputs.fx, inputs.fy, inputs.cx, inputs.cy)
    eye6 = torch.eye(6, dtype=dt, device=coeffs0.device)

    def res_fn(c):
        return residual_vector_prepared(c, prep, cam)

    def res_and_jac(c):
        tangents = eye6.reshape((6,) + (1,) * (c.dim() - 1) + (6,)).expand(
            (6,) + c.shape)
        r, jac = vmap(lambda t: jvp(res_fn, (c,), (t,)), out_dims=(0, -1))(tangents)
        return r[0], jac                     # [..., R], [..., R, 6]

    def normal_eq(r, jac):
        jt = jac.transpose(-1, -2)
        return jt @ jac, (jt @ r[..., None])[..., 0]

    r0, jac0 = res_and_jac(coeffs0)
    best_c = coeffs0
    best_cost = torch.sum(r0 * r0, dim=-1)
    jtj, g = normal_eq(r0, jac0)
    damping = torch.full(best_cost.shape, damping0, dtype=dt, device=coeffs0.device)
    accepts = torch.zeros(best_cost.shape, dtype=torch.int64, device=coeffs0.device)
    trace = [(coeffs0, best_cost, jtj, g)]
    trial = damped_step(best_c, jtj, g, damping)
    for it in range(iterations):
        r_t, jac_t = res_and_jac(trial)
        cost_t = torch.sum(r_t * r_t, dim=-1)
        accept = (cost_t < best_cost) & torch.isfinite(trial).all(dim=-1)
        if details and it < 63:
            accepts = accepts | (accept.to(torch.int64) << it)
        best_c = torch.where(accept[..., None], trial, best_c)
        best_cost = torch.where(accept, cost_t, best_cost)
        jtj_t, g_t = normal_eq(r_t, jac_t)
        if details:
            trace.append((trial, cost_t, jtj_t, g_t))
        jtj = torch.where(accept[..., None, None], jtj_t, jtj)
        g = torch.where(accept[..., None], g_t, g)
        damping = next_damping(damping, accept)
        trial = damped_step(best_c, jtj, g, damping)
    if details:
        points, costs, jtjs, jtrs = zip(*trace)
        return LMResult(best_c, best_cost, jtj, g, accepts, torch.stack(points, -2),
                        torch.stack(costs, -1), torch.stack(jtjs, -3), torch.stack(jtrs, -2))
    return best_c, best_cost


def damped_step(best, jtj, jtr, damping):
    """The LM trial from the best point ``best`` [..., 6], its normal equations
    ``jtj`` [..., 6, 6] and ``jtr`` [..., 6] and the damping [...]: ``best +
    solve6_spd(JtJ + damping diag(max(diag JtJ, 1e-8)) + 1e-12 I, -Jtr)``."""
    eye6 = torch.eye(6, dtype=jtj.dtype, device=jtj.device)
    diag = torch.clamp_min(torch.diagonal(jtj, dim1=-2, dim2=-1), 1e-8)
    a = jtj + damping[..., None, None] * torch.diag_embed(diag) + 1e-12 * eye6
    return best + solve6_spd(a, -jtr)


def next_damping(damping, accept):
    """The damping after a decision: halved on accept, four times on reject,
    clamped to [1e-9, 1e6]."""
    return torch.clamp(torch.where(accept, damping * 0.5, damping * 4.0), 1e-9, 1e6)


def _blocks(inputs: LMInputs):
    """The eleven feature blocks in ``LMArgs`` order, each with its trailing
    (per-member) rank."""
    return [(inputs.pts_world, 2), (inputs.point_obs_uv, 2), (inputs.point_mask, 1),
            (inputs.point2d_obs_uv, 2), (inputs.point2d_mask, 1), (inputs.plane_world, 2),
            (inputs.plane_cam, 2), (inputs.plane_mask, 1), (inputs.line_obs_p0, 2),
            (inputs.line_obs_p1, 2), (inputs.line_mask, 1)]


def kernel_layout(inputs: LMInputs, coeffs0):
    """What the kernel reads: (the batch shape, coeffs0 as [B, 6], each feature
    block as [N, k] (shared, batch stride 0) or [B, N, k] (its own batch
    stride)).  A block whose batch axes are not the batch's is expanded to it
    and copied; one with a single member is shared."""
    blocks = _blocks(inputs)
    batch = torch.broadcast_shapes(coeffs0.shape[:-1],
                                   *(t.shape[:t.dim() - rank] for t, rank in blocks))
    b = math.prod(batch)
    flat, strides = [], []
    for t, rank in blocks:
        tail = t.shape[t.dim() - rank:]
        if math.prod(t.shape[:t.dim() - rank]) == 1:
            flat.append(t.reshape(tail).contiguous())
            strides.append(0)
        else:
            flat.append(t.expand(batch + tail).reshape((b,) + tail).contiguous())
            strides.append(math.prod(tail))
    coeffs = coeffs0.expand(batch + (6,)).reshape(b, 6).contiguous()
    return batch, coeffs, flat, strides


def launch_shape(capacities) -> tuple[int, int]:
    """(threads a CTA, dynamic shared-memory bytes) of a launch over members
    with these feature ``capacities``: the features rounded up to whole warps,
    32 to ``MAX_THREADS`` threads (32 runs the one-warp kernel, which has no
    block barrier), and 4 bytes a feature for the list of a member's live
    features.  Raises past ``MAX_FEATURES``."""
    n = sum(capacities)
    if n > MAX_FEATURES:
        raise ValueError(f"the LM kernel takes at most {MAX_FEATURES} features a member, "
                         f"got {n}")
    return min(max(32 * -(-n // 32), 32), MAX_THREADS), 4 * n


def check_inputs(inputs: LMInputs, coeffs0):
    """Raise on inputs the kernel does not take."""
    device = coeffs0.device
    if device.type != "cuda":
        raise ValueError("the LM kernel takes CUDA tensors")
    if coeffs0.dtype != torch.float32 or coeffs0.shape[-1] != 6:
        raise ValueError(f"coeffs0 must be float32 [..., 6], got {coeffs0.dtype} "
                         f"{tuple(coeffs0.shape)}")
    np_, n2, nk, nl = inputs.capacities
    widths = [3, 2, None, 2, None, 4, 4, None, 2, 2, None]
    rows = [np_ + 2 * n2 + 2 * nl, np_, np_, n2, n2, nk, nk, nk, nl, nl, nl]
    for (t, rank), width, n in zip(_blocks(inputs), widths, rows):
        want = torch.float32 if width else torch.uint8
        tail = (n, width) if width else (n,)
        if t.device != device or t.dtype != want or tuple(t.shape[t.dim() - rank:]) != tail:
            raise ValueError(f"a feature block must be {want} [.., {tail}] on {device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def lm_solve_cuda(inputs: LMInputs, coeffs0, iterations: int, damping0: float,
                  details: bool = False):
    """Launch the kernel on the current stream (``coeffs0`` [..., 6] with at
    least one batch axis)."""
    check_inputs(inputs, coeffs0)
    if iterations < 0:
        raise ValueError(f"iterations must be >= 0, got {iterations}")
    threads, list_bytes = launch_shape(inputs.capacities)
    batch, coeffs, flat, strides = kernel_layout(inputs, coeffs0)
    b = coeffs.shape[0]
    device = coeffs0.device
    out = torch.empty((b, 6), dtype=torch.float32, device=device)
    cost = torch.empty((b,), dtype=torch.float32, device=device)
    extra = (torch.empty((b, 6, 6), dtype=torch.float32, device=device),
             torch.empty((b, 6), dtype=torch.float32, device=device),
             torch.empty((b,), dtype=torch.int64, device=device),
             torch.empty((b, iterations + 1, TRACE_ROW), dtype=torch.float32, device=device)
             ) if details else None
    if b > 0:
        LIBRARY.build()
        ptrs = [t.data_ptr() for t in flat] + [coeffs.data_ptr(), out.data_ptr(),
                                               cost.data_ptr()]
        ptrs += [t.data_ptr() for t in extra] if details else [None] * 4
        args = _Args(*ptrs, (ctypes.c_longlong * 11)(*strides), b, *inputs.capacities,
                     iterations, inputs.fx, inputs.fy, inputs.cx, inputs.cy, damping0,
                     (ctypes.c_float * 4)(*SCALES))
        stream = torch.cuda.current_stream(device).cuda_stream
        err = LIBRARY.lib.lm_solve_launch(ctypes.byref(args), threads, list_bytes, stream)
        if err != 0:
            raise RuntimeError(f"LM kernel launch failed: cudaError {err}")
        LAUNCHES["lm_solve"] += 1
    if details:
        jtj, jtr, accepts, trace = extra
        lin = trace.shape[1]
        upper = torch.triu_indices(6, 6, device=device)
        jtjs = torch.zeros((b, lin, 6, 6), dtype=torch.float32, device=device)
        jtjs[..., upper[0], upper[1]] = trace[..., 7:28]
        jtjs[..., upper[1], upper[0]] = trace[..., 7:28]
        return LMResult(out.reshape(batch + (6,)), cost.reshape(batch),
                        jtj.reshape(batch + (6, 6)), jtr.reshape(batch + (6,)),
                        accepts.reshape(batch), trace[..., :6].reshape(batch + (lin, 6)),
                        trace[..., 6].reshape(batch + (lin,)),
                        jtjs.reshape(batch + (lin, 6, 6)),
                        trace[..., 28:].reshape(batch + (lin, 6)))
    return out.reshape(batch + (6,)), cost.reshape(batch)


def lm_work(inputs: LMInputs, coeffs0, linearizations: int) -> dict:
    """What the LM solve needs on these inputs, for the kernel's roofline
    bound: FLOPs (every live feature of every member at every linearization,
    its rows into the normal equations, the pose a linearization and the solve
    an iteration, at the constants above: an upper count, since an
    inverse-depth point is charged its segment branch) and bytes (every input
    block read once as given, the coefficients in and out, the costs out).
    ``linearizations`` is ``iterations + 1``.  Returns a dict: ``batch``,
    ``live`` (features by type summed over the batch), ``rows``, ``flops``,
    ``bytes``."""
    batch, _, _, _ = kernel_layout(inputs, coeffs0)
    b = math.prod(batch)

    def live(mask):
        n = int(mask.to(torch.int64).sum())
        return n if math.prod(mask.shape[:-1]) > 1 else n * b

    counts = [live(m) for m in (inputs.point_mask, inputs.point2d_mask, inputs.plane_mask,
                                inputs.line_mask)]
    rows = 2 * counts[0] + 2 * counts[1] + 3 * counts[2] + 2 * counts[3]
    per_lin = (sum(n * f for n, f in zip(counts, (FLOPS_POINT, FLOPS_POINT2D, FLOPS_PLANE,
                                                  FLOPS_LINE)))
               + rows * FLOPS_ROW + b * FLOPS_POSE)
    flops = linearizations * per_lin + (linearizations - 1) * b * FLOPS_SOLVE
    n_bytes = sum(t.numel() * t.element_size() for t, _ in _blocks(inputs)) + b * (6 + 6 + 1) * 4
    return {"batch": b, "live": counts, "rows": rows, "flops": flops, "bytes": n_bytes}
