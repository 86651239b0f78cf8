"""Fused forward-backward pyramidal LK: the CUDA kernel's wrapper and its plain
PyTorch version.

``lk_fwd_bwd`` is the entry point.  For CUDA tensors it launches the hand-written
Hopper kernel in ``csrc/lk_fwd_bwd.cu`` (which replaces
``rgbd_slam_tpu.ops.pallas_lk.lk_fwd_bwd_pallas``) or raises; for CPU tensors it
runs :func:`lk_fwd_bwd_reference`, the same semantics as batched tensor code with
lockstep masked iterations.

The kernel is compiled with ``nvcc`` on first use from the source in this
package, into ``rgbd_slam_tpu_torch/_build/``, and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(_HERE, "..", "csrc", "lk_fwd_bwd.cu")
_BUILD_DIR = os.path.join(_HERE, "..", "_build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC"]
_MAX_LEVELS = 8  # LK_MAX_LEVELS in the kernel source

#: launches of the CUDA kernel since import (or since the caller reset it)
LAUNCHES = 0

_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def build() -> float:
    """Compile and load the kernel library if it is not loaded yet.  The output
    name carries the source hash, so an edited source is rebuilt.  Returns the
    seconds spent (0.0 when already loaded)."""
    global _lib
    if _lib is not None:
        return 0.0
    t0 = time.perf_counter()
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(_BUILD_DIR, exist_ok=True)
    so_path = os.path.join(_BUILD_DIR, f"liblk_fwd_bwd_{digest}.so")
    if not os.path.exists(so_path):
        tmp = f"{so_path}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", tmp, _SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)
    fn = lib.lk_fwd_bwd_launch
    fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_float,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    return time.perf_counter() - t0


def window_sizes(dims, win_h: int, win_w: int, coarse_win: int | None,
                 coarse_from_level: int):
    """Per-level (rows, cols) windows, as lk_fwd_bwd_pallas computes them: the
    coarse window from ``coarse_from_level`` up, clamped to the level size - 8."""
    return tuple(
        (min(win_h if lvl < coarse_from_level else (coarse_win or win_h), lh - 8),
         min(win_w if lvl < coarse_from_level else (coarse_win or win_w), lw - 8))
        for lvl, (lh, lw) in enumerate(dims))


def lk_fwd_bwd(prev_pyramid, next_pyramid, points, valid, levels: int = 4,
               win_h: int = 53, win_w: int = 53, iterations: int = 10,
               eps: float = 0.03, max_roundtrip: float = 35.0,
               bwd_levels: int | None = None, coarse_win: int | None = None,
               coarse_from_level: int = 1):
    """Fused forward+backward pyramidal LK with the round-trip gate.

    ``points`` [N, 2] f32 (x, y) at level 0, ``valid`` [N] bool.  Returns
    (points + forward flow [N, 2], ok [N] bool).  CUDA tensors go to the kernel,
    CPU tensors to :func:`lk_fwd_bwd_reference`."""
    kw = dict(levels=levels, win_h=win_h, win_w=win_w, iterations=iterations,
              eps=eps, max_roundtrip=max_roundtrip, bwd_levels=bwd_levels,
              coarse_win=coarse_win, coarse_from_level=coarse_from_level)
    if points.device.type == "cuda":
        return lk_fwd_bwd_cuda(prev_pyramid, next_pyramid, points, valid, **kw)
    if points.device.type == "cpu":
        return lk_fwd_bwd_reference(prev_pyramid, next_pyramid, points, valid, **kw)
    raise ValueError(f"lk_fwd_bwd: unsupported device {points.device}")


def _check(name, t, device, dtype, shape=None, ndim=None):
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"lk_fwd_bwd_cuda: {name} must be a contiguous {dtype} "
                         f"tensor on {device}, got {t.dtype} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"lk_fwd_bwd_cuda: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"lk_fwd_bwd_cuda: {name} must be {ndim}-D")


def lk_fwd_bwd_cuda(prev_pyramid, next_pyramid, points, valid, levels: int = 4,
                    win_h: int = 53, win_w: int = 53, iterations: int = 10,
                    eps: float = 0.03, max_roundtrip: float = 35.0,
                    bwd_levels: int | None = None, coarse_win: int | None = None,
                    coarse_from_level: int = 1):
    """Launch the CUDA kernel (one CTA per point) on the current stream."""
    global LAUNCHES
    device = points.device
    if device.type != "cuda":
        raise ValueError("lk_fwd_bwd_cuda takes CUDA tensors")
    if not 0 <= levels < _MAX_LEVELS:
        raise ValueError(f"levels must be in [0, {_MAX_LEVELS - 1}], got {levels}")
    if len(prev_pyramid) < levels + 1 or len(next_pyramid) < levels + 1:
        raise ValueError("pyramids need levels + 1 images")
    bwd_top = levels if bwd_levels is None else bwd_levels
    if not 0 <= bwd_top <= levels:
        raise ValueError(f"bwd_levels must be in [0, {levels}], got {bwd_levels}")
    n = points.shape[0]
    _check("points", points, device, torch.float32, shape=(n, 2))
    _check("valid", valid, device, torch.bool, shape=(n,))
    prev = list(prev_pyramid[:levels + 1])
    nxt = list(next_pyramid[:levels + 1])
    dims = []
    for lvl, (a, b) in enumerate(zip(prev, nxt)):
        _check(f"prev_pyramid[{lvl}]", a, device, torch.float32, ndim=2)
        _check(f"next_pyramid[{lvl}]", b, device, torch.float32, shape=a.shape)
        dims.append((int(a.shape[0]), int(a.shape[1])))
    wins = window_sizes(dims, win_h, win_w, coarse_win, coarse_from_level)
    for (lh, lw), (wh, ww) in zip(dims, wins):
        if wh < 1 or ww < 1:
            raise ValueError(f"level {lh}x{lw} is too small for an LK window")

    build()
    out_points = torch.empty((n, 2), dtype=torch.float32, device=device)
    out_ok = torch.empty((n,), dtype=torch.bool, device=device)
    n_lv = levels + 1
    flat_dims = [v for (lh, lw), (wh, ww) in zip(dims, wins) for v in (lh, lw, wh, ww)]
    err = _lib.lk_fwd_bwd_launch(
        (ctypes.c_void_p * n_lv)(*[t.data_ptr() for t in prev]),
        (ctypes.c_void_p * n_lv)(*[t.data_ptr() for t in nxt]),
        (ctypes.c_int * len(flat_dims))(*flat_dims),
        levels, bwd_top, iterations, float(eps * eps),
        float(max_roundtrip * max_roundtrip),
        points.data_ptr(), valid.data_ptr(), out_points.data_ptr(),
        out_ok.data_ptr(), n, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lk_fwd_bwd kernel launch failed: cudaError {err}")
    LAUNCHES += 1
    return out_points, out_ok


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _sample_windows(img, x, y, h: int, w: int):
    """Bilinear [N, h, w] windows of ``img`` with float top-left (x[N], y[N]): the
    index clamps to ``l - (w + 1)``, the fraction comes from the unclamped floor."""
    lh, lw = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None, None]
    fy = (y - y0)[:, None, None]
    xi = x0.clamp(-1e9, 1e9).to(torch.int64).clamp(0, lw - (w + 1))
    yi = y0.clamp(-1e9, 1e9).to(torch.int64).clamp(0, lh - (h + 1))
    rows = yi[:, None] + torch.arange(h + 1, device=img.device)
    cols = xi[:, None] + torch.arange(w + 1, device=img.device)
    p = img[rows[:, :, None], cols[:, None, :]]
    return ((1 - fy) * ((1 - fx) * p[:, :h, :w] + fx * p[:, :h, 1:])
            + fy * ((1 - fx) * p[:, 1:, :w] + fx * p[:, 1:, 1:]))


def _track_direction_reference(src, dst, px, py, valid, top: int, dims, wins,
                               iterations: int, eps_sq: float):
    """Coarse-to-fine LK of all points in lockstep; a converged point's step is
    frozen (the Pallas group-of-4 semantics)."""
    gx = torch.zeros_like(px)
    gy = torch.zeros_like(py)
    ok = valid.clone()
    for lvl in range(top, -1, -1):
        lh, lw = dims[lvl]
        wh, ww = wins[lvl]
        scale = 0.5 ** lvl
        tlx = torch.clamp(px * scale - (ww - 1) / 2.0, 2.0, lw - ww - 3.0)
        tly = torch.clamp(py * scale - (wh - 1) / 2.0, 2.0, lh - wh - 3.0)
        tp = _sample_windows(src[lvl], tlx - 1.0, tly - 1.0, wh + 2, ww + 2)
        t = tp[:, 1:-1, 1:-1]
        ix = 0.5 * (tp[:, 1:-1, 2:] - tp[:, 1:-1, :-2])
        iy = 0.5 * (tp[:, 2:, 1:-1] - tp[:, :-2, 1:-1])
        gxx = (ix * ix).sum(dim=(1, 2))
        gxy = (ix * iy).sum(dim=(1, 2))
        gyy = (iy * iy).sum(dim=(1, 2))
        det = gxx * gyy - gxy * gxy
        lvl_ok = (det > 1e-6) & valid
        if lvl == 0:  # only the finest level sets status
            ok = ok & lvl_ok
        inv_det = torch.where(lvl_ok, 1.0 / torch.where(lvl_ok, det, torch.ones_like(det)),
                              torch.zeros_like(det))
        done = ~ok
        for _ in range(iterations):
            if bool(done.all()):
                break
            j = _sample_windows(dst[lvl], tlx + gx, tly + gy, wh, ww)
            diff = t - j
            bx = (ix * diff).sum(dim=(1, 2))
            by = (iy * diff).sum(dim=(1, 2))
            dx = torch.where(done, torch.zeros_like(bx), (gyy * bx - gxy * by) * inv_det)
            dy = torch.where(done, torch.zeros_like(by), (gxx * by - gxy * bx) * inv_det)
            gx = gx + dx
            gy = gy + dy
            done = done | (dx * dx + dy * dy < eps_sq)
        if lvl > 0:
            gx = gx * 2.0
            gy = gy * 2.0
    return gx, gy, ok


def lk_fwd_bwd_reference(prev_pyramid, next_pyramid, points, valid, levels: int = 4,
                         win_h: int = 53, win_w: int = 53, iterations: int = 10,
                         eps: float = 0.03, max_roundtrip: float = 35.0,
                         bwd_levels: int | None = None,
                         coarse_win: int | None = None, coarse_from_level: int = 1):
    """Plain PyTorch version of the kernel: same semantics, batched over points."""
    dims = tuple((int(p.shape[0]), int(p.shape[1])) for p in prev_pyramid[:levels + 1])
    wins = window_sizes(dims, win_h, win_w, coarse_win, coarse_from_level)
    bwd_top = levels if bwd_levels is None else bwd_levels
    px = points[:, 0].to(torch.float32)
    py = points[:, 1].to(torch.float32)
    kw = dict(dims=dims, wins=wins, iterations=iterations, eps_sq=float(eps * eps))
    fgx, fgy, fok = _track_direction_reference(prev_pyramid, next_pyramid, px, py,
                                               valid, levels, **kw)
    fx = px + fgx
    fy = py + fgy
    bgx, bgy, bok = _track_direction_reference(next_pyramid, prev_pyramid, fx, fy,
                                               fok, bwd_top, **kw)
    rt2 = (fgx + bgx) ** 2 + (fgy + bgy) ** 2
    ok = fok & bok & (rt2 <= float(max_roundtrip * max_roundtrip))
    return torch.stack([fx, fy], dim=-1), ok


def roundtrip_px_reference(prev_pyramid, next_pyramid, points, tracked, levels: int = 4,
                           win_h: int = 53, win_w: int = 53, iterations: int = 10,
                           eps: float = 0.03, bwd_levels: int | None = None,
                           coarse_win: int | None = None, coarse_from_level: int = 1):
    """The distance the round-trip gate compares, from the plain version: for each
    row, |forward flow + backward flow| with the backward pass run from
    ``tracked`` (the forward result).  Comparisons of two LK versions use it to
    excuse flag disagreements on rows that sit at the gate."""
    dims = tuple((int(p.shape[0]), int(p.shape[1])) for p in prev_pyramid[:levels + 1])
    wins = window_sizes(dims, win_h, win_w, coarse_win, coarse_from_level)
    bgx, bgy, _ = _track_direction_reference(
        next_pyramid, prev_pyramid, tracked[:, 0], tracked[:, 1],
        torch.ones(tracked.shape[0], dtype=torch.bool, device=tracked.device),
        levels if bwd_levels is None else bwd_levels, dims, wins, iterations,
        float(eps * eps))
    flow = tracked - points
    return torch.hypot(flow[:, 0] + bgx, flow[:, 1] + bgy)
