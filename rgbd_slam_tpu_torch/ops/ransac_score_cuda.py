"""The pose optimizer's RANSAC scoring: the CUDA kernel's wrapper and its plain
PyTorch version.

``score(coeffs, prep, cam, ransac, ok, caps)`` scores poses against prepared
features (``pose/residuals.prepare_features``) as ``compute_optimized_pose``
does, the scoring of ``rgbd_slam_tpu/pose/optimizer.py`` and
``rgbd_slam_tpu/pose/residuals.py:inlier_masks_prepared`` (XLA code of the
JAX step; no Pallas kernel).

* A batch of hypotheses, ``coeffs`` [H, 6]: each one's score counts the
  inliers among the first ``caps`` live rows of each type (points, 2D points,
  planes, lines), -1 where ``ok`` is False; the rank ``score + 1e-6 count``
  picks the best, the first maximum as ``torch.argmax`` does; its inlier masks
  are taken over every row.
* One pose, ``coeffs`` [6]: its score and masks over every row.

It returns a :class:`Scores`.  For CUDA tensors it launches
``ransac_score_kernel`` (``csrc/ransac_score.cu``: a CTA a hypothesis, a
thread a row, the winner picked and its masks written by the last CTA to
finish) or raises; for CPU tensors it runs :func:`score_reference`, which is
the composition the kernel replaces: ``inlier_masks_prepared`` on the features
compacted to ``caps``, the scores, the rank and its ``argmax``, then
``inlier_masks_prepared`` at the best pose.  ``details=True`` also returns
every hypothesis' tested values over every row (:func:`tested_values`), from
the kernel and from the plain version alike.

The kernel is compiled with ``nvcc -fmad=false`` on first use (:mod:`.nvcc`)
and bound with ctypes; it launches on the current stream and reads nothing
back, so a CUDA graph can record it.  Its last CTA finds itself with a ticket
that one buffer a device holds, which every launch leaves at 0: launches on
one stream at a time.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..config import CameraIntrinsics, RansacConfig
from ..geometry import lines, pinhole, planes, se3
from ..pose.features import LINE_SCORE, PLANE_SCORE, POINT2D_SCORE, POINT_SCORE
from ..pose.residuals import (BIG_RESIDUAL, PreparedFeatures, _line_distances,
                              _point2d_distances, inlier_masks_prepared)
from . import lm_cuda, nvcc

#: most threads a CTA (``RS_MAX_THREADS`` in ``csrc/ransac_score.cu``): a
#: thread a row, the rows past it in further passes
MAX_THREADS = 1024
#: rows of the projected points :func:`tested_values` takes at a time (see there)
VALUE_ROW_CHUNK = 50
#: each row type's score (``pose/features``), in the kernel's order
WEIGHTS = (POINT_SCORE, POINT2D_SCORE, PLANE_SCORE, LINE_SCORE)
#: FLOPs the kernel spends on a row of each type (counted from
#: ``csrc/ransac_score.cu`` at 1 a float operation, a fused multiply-add 2, a
#: sine, cosine or arctangent 20): a projection 24, a point 29, a 2D point's
#: two projections and its segment distance 70, a plane's four 4-term products
#: and three wrapped angles 212, a line's two projections and distances 66
FLOPS_POINT, FLOPS_POINT2D, FLOPS_PLANE, FLOPS_LINE = 29, 70, 212, 66
#: the pose of a hypothesis, on every thread
FLOPS_POSE = 75


class Scores(NamedTuple):
    """What a scoring gives: the best pose's index, coefficients and score and
    its inlier masks over every row, and each hypothesis' score and counted
    inliers (int32 from the kernel, int64 from the plain version)."""
    best: torch.Tensor             # [1] int64
    coeffs: torch.Tensor           # [6]
    score: torch.Tensor            # []
    point_inliers: torch.Tensor    # [NP] bool
    point2d_inliers: torch.Tensor  # [N2] bool
    plane_inliers: torch.Tensor    # [NK] bool
    line_inliers: torch.Tensor     # [NL] bool
    scores: torch.Tensor           # [H] (one pose: [1])
    counts: torch.Tensor           # [H]

    @property
    def masks(self):
        return (self.point_inliers, self.point2d_inliers, self.plane_inliers,
                self.line_inliers)


class _Args(ctypes.Structure):
    """``ScoreArgs`` of ``csrc/ransac_score.cu``, field for field."""
    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "pts", "point_obs", "point_mask", "p2d_obs", "p2d_mask", "plane_world", "plane_cam",
        "plane_mask", "line_p0", "line_p1", "line_mask", "coeffs", "hyp_ok", "scores",
        "counts", "ticket", "best", "best_coeffs", "best_score", "inliers", "values")]
        + [(name, ctypes.c_int) for name in ("hyps", "np", "n2", "nk", "nl", "batched")]
        + [("cap", ctypes.c_int * 4)]
        + [(name, ctypes.c_float) for name in ("fx", "fy", "cx", "cy")]
        + [("limit", ctypes.c_float * 5), ("weight", ctypes.c_float * 4)])


def _bind(lib):
    lib.ransac_score_launch.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_void_p]
    lib.ransac_score_launch.restype = ctypes.c_int


LIBRARY = nvcc.Library("ransac_score.cu", _bind, launches=("ransac_score",),
                       extra_flags=("-fmad=false",))
#: launches of the CUDA kernel since import (``LIBRARY.launches``)
LAUNCHES = LIBRARY.launches
#: the last-CTA ticket of each device, made at its first launch
_TICKETS: dict = {}


def limits(ransac: RansacConfig):
    """The five limits in the kernel's order: point px, 2D px, plane normal,
    plane mm, line px."""
    return (ransac.max_retroprojection_error_point_px,
            ransac.max_retroprojection_error_point2d_px,
            ransac.max_retroprojection_error_plane_normal,
            ransac.max_retroprojection_error_plane_mm,
            ransac.max_retroprojection_error_line_px)


def capacities(prep: PreparedFeatures):
    return (prep.point_mask.shape[-1], prep.point2d_mask.shape[-1],
            prep.plane_mask.shape[-1], prep.line_mask.shape[-1])


def score(coeffs, prep: PreparedFeatures, cam: CameraIntrinsics,
          ransac: RansacConfig = RansacConfig(), ok=None, caps=None, details: bool = False):
    """Score ``coeffs`` ([H, 6] hypotheses, or [6] one pose) against ``prep``:
    the kernel for CUDA tensors, the plain version for CPU tensors.  ``ok``
    [H] bool (None: all) and ``caps`` (live rows of each type that count
    towards a hypothesis' score; None: every row) apply to hypotheses.
    Returns a :class:`Scores`, or (it, the tested values [H, V]) with
    ``details``."""
    if coeffs.device.type == "cuda":
        return score_cuda(coeffs, prep, cam, ransac, ok, caps, details)
    if coeffs.device.type == "cpu":
        return score_reference(coeffs, prep, cam, ransac, ok, caps, details)
    raise ValueError(f"unsupported device {coeffs.device}")


def compact_prepared(prep: PreparedFeatures, caps) -> PreparedFeatures:
    """The first ``caps`` live rows of each type of prepared features, as
    ``prepare_features`` gives them for the features that
    ``optimizer.compact_features`` keeps (every block is row by row)."""
    from ..pose.optimizer import compact_rows

    np_, n2, _, nl = capacities(prep)
    cp, c2, ck, cl = caps
    ip, mp = compact_rows(prep.point_mask, cp)
    i2, m2 = compact_rows(prep.point2d_mask, c2)
    ik, mk = compact_rows(prep.plane_mask, ck)
    il, ml = compact_rows(prep.line_mask, cl)
    base = np_ + 2 * n2
    rows = torch.cat([ip, np_ + i2, np_ + n2 + i2, base + il, base + nl + il])
    return PreparedFeatures(
        pts_world=prep.pts_world[rows],
        point_obs_uv=prep.point_obs_uv[ip], point_mask=mp,
        point2d_obs_uv=prep.point2d_obs_uv[i2], point2d_mask=m2,
        plane_world=prep.plane_world[ik], plane_cam=prep.plane_cam[ik], plane_mask=mk,
        line_obs_p0=prep.line_obs_p0[il], line_obs_p1=prep.line_obs_p1[il], line_mask=ml)


def _score_pose(coeffs, prep, cam, ransac):
    """``inlier_masks_prepared`` at ``coeffs`` [..., 6]: (score, count, masks)."""
    quat, position = se3.coefficients_to_pose(coeffs)
    masks = inlier_masks_prepared(quat, position, prep, cam, ransac)
    dt = coeffs.dtype
    p_in, q_in, k_in, l_in = masks
    score_ = (POINT_SCORE * p_in.sum(-1).to(dt) + POINT2D_SCORE * q_in.sum(-1).to(dt)
              + PLANE_SCORE * k_in.sum(-1).to(dt) + LINE_SCORE * l_in.sum(-1).to(dt))
    count = p_in.sum(-1) + q_in.sum(-1) + k_in.sum(-1) + l_in.sum(-1)
    return score_, count, masks


def score_reference(coeffs, prep: PreparedFeatures, cam: CameraIntrinsics,
                    ransac: RansacConfig = RansacConfig(), ok=None, caps=None,
                    details: bool = False):
    """The plain version (any device): the hypotheses scored on the features
    compacted to ``caps``, ``where(ok, score, -1)``, the rank's ``argmax``,
    and the masks at the best pose over every row; one pose [6] scored and
    masked over every row."""
    if coeffs.dim() == 1:
        score_, count, masks = _score_pose(coeffs, prep, cam, ransac)
        out = Scores(torch.zeros((1,), dtype=torch.int64, device=coeffs.device), coeffs,
                     score_, *masks, score_[None], count[None])
        return (out, tested_values(coeffs, prep, cam)[None]) if details else out
    scored = prep if caps is None else compact_prepared(prep, caps)
    scores, counts, _ = _score_pose(coeffs, scored, cam, ransac)
    if ok is not None:
        scores = torch.where(ok, scores, -1.0)
    rank = scores + 1e-6 * counts.to(coeffs.dtype)
    best = torch.argmax(rank, dim=0, keepdim=True)   # [1]: indexing reads no host value
    best_coeffs = coeffs[best][0]
    _, _, masks = _score_pose(best_coeffs, prep, cam, ransac)
    out = Scores(best, best_coeffs, scores[best][0], *masks, scores, counts)
    return (out, tested_values(coeffs, prep, cam)) if details else out


def tested_values(coeffs, prep: PreparedFeatures, cam: CameraIntrinsics):
    """What ``inlier_masks_prepared`` holds to its limits at ``coeffs`` ([H, 6],
    or [6] one pose), for every row, masked or not, [.., NP + 2 N2 + 4 NK + 2
    NL]: a point's L1 px error, a 2D point's two signed px components, a
    plane's three wrapped normal angles and its d error (signed), a line's two
    endpoint distances.  The points are projected ``VALUE_ROW_CHUNK`` rows
    at a time: the card's batched matrix product rounds in fused pairs, as
    the kernel does, at the main path's batch counts (96 hypotheses by the
    compacted set's 544 rows, one pose by 1,056) and at 96 by 50, but
    otherwise at some other counts (96 by 150 to 300 rows, 16 or 32 by 1,056,
    past 65,535 matrices: ``tools/score_rounding.py``)."""
    quat, position = se3.coefficients_to_pose(coeffs)
    w2c = se3.world_to_camera(quat, position)
    screens = [pinhole.world_to_screen(rows, w2c[..., None, :, :], cam)
               for rows in prep.pts_world.split(VALUE_ROW_CHUNK, dim=-2)]
    scr = torch.cat([sc for sc, _ in screens], dim=-2)
    ok = torch.cat([o for _, o in screens], dim=-1)
    np_ = prep.point_mask.shape[-1]
    n2 = prep.point2d_mask.shape[-1]
    dp = torch.where(ok[..., :np_, None], prep.point_obs_uv - scr[..., :np_, :2],
                     BIG_RESIDUAL)
    d_pt = torch.sum(torch.abs(dp), dim=-1)
    d_2d = _point2d_distances(scr, ok, prep, np_, n2)
    plane_w2c = se3.plane_world_to_camera_matrix(w2c)[..., None, :, :]
    proj = planes.transform_plane(prep.plane_world, plane_w2c)
    d_pl = torch.cat([lines.angle_distance(prep.plane_cam[..., :3], proj[..., :3]),
                      prep.plane_cam[..., 3:4] - proj[..., 3:4]], dim=-1)
    d_ln = _line_distances(scr, ok, prep, np_, n2)
    return torch.cat([d_pt, d_2d.flatten(-2), d_pl.flatten(-2), d_ln.flatten(-2)], dim=-1)


def split_values(values, caps):
    """The tested values [H, V] of features of capacities ``caps`` by type:
    points [H, NP], 2D points [H, N2, 2], planes [H, NK, 4], lines [H, NL, 2]."""
    np_, n2, nk, nl = caps
    h = values.shape[0]
    pt, q2, pl, ln = values.split([np_, 2 * n2, 4 * nk, 2 * nl], dim=-1)
    return pt, q2.reshape(h, n2, 2), pl.reshape(h, nk, 4), ln.reshape(h, nl, 2)


def value_tests(values, caps, ransac: RansacConfig = RansacConfig()):
    """Each row's test from its tested values, the features' masks aside:
    (points, 2D points, planes, lines), each [H, rows of the type] bool."""
    pt, q2, pl, ln = split_values(values, caps)
    lim = limits(ransac)
    return (pt <= lim[0], (q2.abs() <= lim[1]).all(-1),
            (pl[..., :3].abs() <= lim[2]).all(-1) & (pl[..., 3].abs() <= lim[3]),
            (ln.abs() <= lim[4]).all(-1))


def launch_threads(rows: int) -> int:
    """Threads a CTA for ``rows`` rows: whole warps, 32 to ``MAX_THREADS``."""
    return min(max(32 * -(-rows // 32), 32), MAX_THREADS)


def _ticket(device) -> torch.Tensor:
    ticket = _TICKETS.get(device)
    if ticket is None:
        ticket = _TICKETS[device] = torch.zeros((1,), dtype=torch.int32, device=device)
    return ticket


def check_inputs(inputs: lm_cuda.LMInputs, coeffs, ok):
    """Raise on inputs the kernel does not take."""
    device = coeffs.device
    if device.type != "cuda":
        raise ValueError("the scoring kernel takes CUDA tensors")
    if coeffs.dtype != torch.float32 or coeffs.dim() != 2 or coeffs.shape[-1] != 6:
        raise ValueError(f"coeffs must be float32 [H, 6] or [6], got {coeffs.dtype} "
                         f"{tuple(coeffs.shape)}")
    if ok is not None and (ok.device != device or ok.dtype != torch.bool
                           or tuple(ok.shape) != coeffs.shape[:1]):
        raise ValueError(f"ok must be bool [{coeffs.shape[0]}] on {device}")
    np_, n2, nk, nl = inputs.capacities
    widths = [3, 2, None, 2, None, 4, 4, None, 2, 2, None]
    rows = [np_ + 2 * n2 + 2 * nl, np_, np_, n2, n2, nk, nk, nk, nl, nl, nl]
    for (t, _), width, n in zip(lm_cuda._blocks(inputs), widths, rows):
        want = torch.float32 if width else torch.uint8
        shape = (n, width) if width else (n,)
        if t.device != device or t.dtype != want or tuple(t.shape) != shape:
            raise ValueError(f"a feature block must be {want} {shape} on {device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def score_cuda(coeffs, prep: PreparedFeatures, cam: CameraIntrinsics,
               ransac: RansacConfig = RansacConfig(), ok=None, caps=None,
               details: bool = False):
    """Launch the kernel on the current stream."""
    single = coeffs.dim() == 1
    batch = coeffs.reshape(-1, 6).contiguous() if single else coeffs.contiguous()
    inputs = lm_cuda.pack(prep, cam)
    check_inputs(inputs, batch, ok)
    LIBRARY.build()
    caps_ = capacities(prep)
    caps = caps_ if caps is None or single else caps
    h, rows = batch.shape[0], sum(caps_)
    device = coeffs.device
    f32, i32 = torch.float32, torch.int32
    scores = torch.empty((h,), dtype=f32, device=device)
    counts = torch.empty((h,), dtype=i32, device=device)
    best = torch.empty((1,), dtype=torch.int64, device=device)
    best_coeffs = torch.empty((6,), dtype=f32, device=device)
    best_score = torch.empty((), dtype=f32, device=device)
    inliers = torch.empty((rows,), dtype=torch.uint8, device=device)
    n_values = caps_[0] + 2 * caps_[1] + 4 * caps_[2] + 2 * caps_[3]
    values = torch.empty((h, n_values), dtype=f32, device=device) if details else None
    if h > 0:
        ok_ptr = ok.contiguous().view(torch.uint8).data_ptr() if ok is not None else None
        ptrs = [t.data_ptr() for t, _ in lm_cuda._blocks(inputs)] + [
            batch.data_ptr(), ok_ptr, scores.data_ptr(), counts.data_ptr(),
            _ticket(device).data_ptr(), best.data_ptr(), best_coeffs.data_ptr(),
            best_score.data_ptr(), inliers.data_ptr(),
            values.data_ptr() if details else None]
        args = _Args(*ptrs, h, *caps_, int(not single), (ctypes.c_int * 4)(*caps), inputs.fx,
                     inputs.fy, inputs.cx, inputs.cy, (ctypes.c_float * 5)(*limits(ransac)),
                     (ctypes.c_float * 4)(*WEIGHTS))
        stream = torch.cuda.current_stream(device).cuda_stream
        err = LIBRARY.lib.ransac_score_launch(ctypes.byref(args), launch_threads(rows), stream)
        if err != 0:
            raise RuntimeError(f"scoring kernel launch failed: cudaError {err}")
        LAUNCHES["ransac_score"] += 1
    masks = inliers.view(torch.bool).split(caps_)
    out = Scores(best, best_coeffs, best_score, *masks, scores, counts)
    return (out, values) if details else out


def score_work(capacities_, hyps: int, batched: bool = True) -> dict:
    """What a launch over ``hyps`` hypotheses (``batched``: the winner's rows
    tested once more for its masks) or one pose, with features of these
    ``capacities_`` every row live, needs: FLOPs (each row of each pass at the
    constants above, and each pass's pose) and bytes (the feature blocks read
    once, the coefficients in, the scores and counts, the winner's outputs and
    masks out).  Returns a dict: ``rows``, ``flops``, ``bytes``."""
    np_, n2, nk, nl = capacities_
    rows = np_ + n2 + nk + nl
    passes = hyps + int(batched)
    flops = passes * (np_ * FLOPS_POINT + n2 * FLOPS_POINT2D + nk * FLOPS_PLANE
                      + nl * FLOPS_LINE + FLOPS_POSE)
    in_bytes = 4 * (3 * (np_ + 2 * n2 + 2 * nl) + 2 * np_ + 2 * n2 + 8 * nk + 4 * nl) + rows
    out_bytes = hyps * (4 + 4) + rows + 8 + 4 * 7
    return {"rows": passes * rows, "flops": flops, "bytes": in_bytes + 24 * hyps + out_bytes}
