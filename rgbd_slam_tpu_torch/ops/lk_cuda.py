"""Pyramidal Lucas-Kanade: the CUDA kernels' wrappers and their plain PyTorch
versions.

Three entry points, one per kernel of ``csrc/lk.cu``:

* ``lk_fwd_bwd``: fused forward + backward pyramidal LK with the round-trip gate
  (replaces ``rgbd_slam_tpu.ops.pallas_lk.lk_fwd_bwd_pallas``);
* ``lk_pyramid``: forward-only pyramidal LK, flow and status (replaces
  ``lk_pyramid_pallas``);
* ``lk_level``: one LK level from per-point guesses (replaces
  ``lk_level_pallas``).

For CUDA tensors each launches its hand-written Hopper kernel or raises; for CPU
tensors it runs its plain version (``*_reference``), the same semantics as
batched tensor code with lockstep masked iterations.

The kernels are compiled with ``nvcc`` on first use from the source in this
package, into ``rgbd_slam_tpu_torch/_build/``, and bound with ctypes.

``lk_work`` and ``lk_level_work`` count what a call needs on given inputs
(iterations really taken, bilinear samples, FLOPs, bytes), for the kernels'
roofline bounds.
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
_SOURCE = os.path.join(_HERE, "..", "csrc", "lk.cu")
_BUILD_DIR = os.path.join(_HERE, "..", "_build")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_MAX_LEVELS = 8  # LK_MAX_LEVELS in the kernel source

#: launches of each CUDA kernel since import (or since :func:`reset_launches`)
LAUNCHES = {"lk_fwd_bwd": 0, "lk_pyramid": 0, "lk_level": 0}

#: what nvcc printed when the loaded library was built (ptxas -v: registers,
#: shared memory and spills of each kernel); kept in a file beside the library
BUILD_LOG = ""

_lib = None
_lib_profiled = False


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def build(profile: bool = False) -> float:
    """Compile and load the kernel library if none is loaded yet.  The output
    name carries the hash of the source and flags, so an edited source is
    rebuilt.  ``profile`` asks for the ``-DLK_PHASE_PROFILE`` build (see
    :func:`profile_attach`), which takes the normal one's place and then stays:
    it launches the same kernels.  Returns the seconds spent (0.0 when already
    loaded)."""
    global _lib, _lib_profiled, BUILD_LOG
    if _lib is not None and (_lib_profiled or not profile):
        return 0.0
    t0 = time.perf_counter()
    flags = [*_NVCC_FLAGS, *(["-DLK_PHASE_PROFILE"] if profile else [])]
    digest = hashlib.sha256(" ".join(flags).encode())
    with open(_SOURCE, "rb") as f:
        digest.update(f.read())
    os.makedirs(_BUILD_DIR, exist_ok=True)
    so_path = os.path.join(_BUILD_DIR, f"liblk_{digest.hexdigest()[:16]}.so")
    log_path = so_path + ".log"
    if not os.path.exists(so_path):
        tmp = f"{so_path}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *flags, "-o", tmp, _SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        with open(log_path, "w") as f:
            f.write(proc.stderr)
        os.replace(tmp, so_path)
    with open(log_path) as f:
        BUILD_LOG = f.read()
    lib = ctypes.CDLL(so_path)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    lib.lk_fwd_bwd_launch.argtypes = [ptrs, ptrs, ctypes.POINTER(ctypes.c_int), i32, i32,
                                      i32, f32, f32, ptr, ptr, ptr, ptr, i32, ptr]
    lib.lk_pyramid_launch.argtypes = [ptrs, ptrs, ctypes.POINTER(ctypes.c_int), i32, i32,
                                      f32, ptr, ptr, ptr, ptr, i32, ptr]
    lib.lk_level_launch.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, f32, ptr, ptr, ptr,
                                    ptr, ptr, i32, ptr]
    for fn in (lib.lk_fwd_bwd_launch, lib.lk_pyramid_launch, lib.lk_level_launch):
        fn.restype = ctypes.c_int
    if profile:
        lib.lk_profile_attach.argtypes = [ptr, i32, i32]
        lib.lk_profile_attach.restype = ctypes.c_int
    _lib, _lib_profiled = lib, profile
    return time.perf_counter() - t0


def profile_attach(buffer, ctas: int, capacity: int):
    """Point the phase marks of a ``LK_PHASE_PROFILE`` build at ``buffer``, a
    zeroed int64 CUDA tensor [ctas, capacity, 3] of (tag, clock64, global timer
    ns) records, one row per CTA; the tags are listed in the kernel source."""
    if not _lib_profiled:
        raise RuntimeError("load the profiled library first: build(profile=True)")
    _check("buffer", buffer, buffer.device, torch.int64, shape=(ctas, capacity, 3))
    if buffer.device.type != "cuda":
        raise ValueError("the profile buffer must be a CUDA tensor")
    err = _lib.lk_profile_attach(buffer.data_ptr(), ctas, capacity)
    if err != 0:
        raise RuntimeError(f"lk_profile_attach failed: cudaError {err}")


def window_sizes(dims, win_h: int, win_w: int, coarse_win: int | None,
                 coarse_from_level: int):
    """Per-level (rows, cols) windows, as lk_fwd_bwd_pallas computes them: the
    coarse window from ``coarse_from_level`` up, clamped to the level size - 8.
    At ``coarse_win`` None (or equal to the window) this is lk_pyramid_pallas's
    ``min(win, level - 8)``."""
    return tuple(
        (min(win_h if lvl < coarse_from_level else (coarse_win or win_h), lh - 8),
         min(win_w if lvl < coarse_from_level else (coarse_win or win_w), lw - 8))
        for lvl, (lh, lw) in enumerate(dims))


def _dims(pyramid, levels: int):
    return tuple((int(p.shape[0]), int(p.shape[1])) for p in pyramid[:levels + 1])


def _dispatch(points, cuda_fn, plain_fn, *args, **kw):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if points.device.type == "cuda":
        return cuda_fn(*args, **kw)
    if points.device.type == "cpu":
        return plain_fn(*args, **kw)
    raise ValueError(f"unsupported device {points.device}")


def lk_fwd_bwd(prev_pyramid, next_pyramid, points, valid, levels: int = 4,
               win_h: int = 53, win_w: int = 53, iterations: int = 10,
               eps: float = 0.03, max_roundtrip: float = 35.0,
               bwd_levels: int | None = None, coarse_win: int | None = None,
               coarse_from_level: int = 1):
    """Fused forward+backward pyramidal LK with the round-trip gate.

    ``points`` [N, 2] f32 (x, y) at level 0, ``valid`` [N] bool.  Returns
    (points + forward flow [N, 2], ok [N] bool)."""
    return _dispatch(points, lk_fwd_bwd_cuda, lk_fwd_bwd_reference, prev_pyramid,
                     next_pyramid, points, valid, levels=levels, win_h=win_h, win_w=win_w,
                     iterations=iterations, eps=eps, max_roundtrip=max_roundtrip,
                     bwd_levels=bwd_levels, coarse_win=coarse_win,
                     coarse_from_level=coarse_from_level)


def lk_pyramid(prev_pyramid, next_pyramid, points, valid, levels: int = 4,
               win_h: int = 53, win_w: int = 53, iterations: int = 10,
               eps: float = 0.03, coarse_win: int | None = None,
               coarse_from_level: int = 1):
    """Forward-only pyramidal LK, zero-seeded at the top level, for any N >= 0.

    ``points`` [N, 2] f32 (x, y) at level 0, ``valid`` [N] bool.  Returns (flow
    [N, 2] at level 0, ok [N] bool); only level 0 sets ok."""
    return _dispatch(points, lk_pyramid_cuda, lk_pyramid_reference, prev_pyramid,
                     next_pyramid, points, valid, levels=levels, win_h=win_h, win_w=win_w,
                     iterations=iterations, eps=eps, coarse_win=coarse_win,
                     coarse_from_level=coarse_from_level)


def lk_level(prev_img, next_img, points, guesses, valid, win_h: int, win_w: int,
             iterations: int = 10, eps: float = 0.03):
    """One LK level.  ``points`` and ``guesses`` [N, 2] at this level's scale, an
    explicit window (no size clamp).  Returns (new guesses [N, 2], ok [N] bool),
    ok = det > 1e-6 & valid."""
    return _dispatch(points, lk_level_cuda, lk_level_reference, prev_img, next_img,
                     points, guesses, valid, win_h=win_h, win_w=win_w,
                     iterations=iterations, eps=eps)


# ---------------------------------------------------------------------------
# CUDA launches
# ---------------------------------------------------------------------------

def _check(name, t, device, dtype, shape=None, ndim=None):
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor on {device}, got "
                         f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D")


def _check_points(points, valid, *extra):
    device = points.device
    if device.type != "cuda":
        raise ValueError("the LK kernels take CUDA tensors")
    n = points.shape[0]
    _check("points", points, device, torch.float32, shape=(n, 2))
    _check("valid", valid, device, torch.bool, shape=(n,))
    for name, t in extra:
        _check(name, t, device, torch.float32, shape=(n, 2))
    return device, n


def _check_pyramids(prev_pyramid, next_pyramid, levels, device, win_h, win_w,
                    coarse_win, coarse_from_level):
    """Validated level lists and the flat [rows, cols, win rows, win cols] dims."""
    if not 0 <= levels < _MAX_LEVELS:
        raise ValueError(f"levels must be in [0, {_MAX_LEVELS - 1}], got {levels}")
    if len(prev_pyramid) < levels + 1 or len(next_pyramid) < levels + 1:
        raise ValueError("pyramids need levels + 1 images")
    prev = list(prev_pyramid[:levels + 1])
    nxt = list(next_pyramid[:levels + 1])
    for lvl, (a, b) in enumerate(zip(prev, nxt)):
        _check(f"prev_pyramid[{lvl}]", a, device, torch.float32, ndim=2)
        _check(f"next_pyramid[{lvl}]", b, device, torch.float32, shape=a.shape)
    dims = _dims(prev, levels)
    wins = window_sizes(dims, win_h, win_w, coarse_win, coarse_from_level)
    for (lh, lw), (wh, ww) in zip(dims, wins):
        if wh < 1 or ww < 1:
            raise ValueError(f"level {lh}x{lw} is too small for an LK window")
    flat = [v for (lh, lw), (wh, ww) in zip(dims, wins) for v in (lh, lw, wh, ww)]
    n_lv = levels + 1
    return ((ctypes.c_void_p * n_lv)(*[t.data_ptr() for t in prev]),
            (ctypes.c_void_p * n_lv)(*[t.data_ptr() for t in nxt]),
            (ctypes.c_int * len(flat))(*flat))


def _launch(name, fn, *args):
    """Call a launch function of the library; count the launch, raise on its
    error."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def lk_fwd_bwd_cuda(prev_pyramid, next_pyramid, points, valid, levels: int = 4,
                    win_h: int = 53, win_w: int = 53, iterations: int = 10,
                    eps: float = 0.03, max_roundtrip: float = 35.0,
                    bwd_levels: int | None = None, coarse_win: int | None = None,
                    coarse_from_level: int = 1):
    """Launch the fused kernel (one CTA per point) on the current stream."""
    device, n = _check_points(points, valid)
    bwd_top = levels if bwd_levels is None else bwd_levels
    if not 0 <= bwd_top <= levels:
        raise ValueError(f"bwd_levels must be in [0, {levels}], got {bwd_levels}")
    prev, nxt, dims = _check_pyramids(prev_pyramid, next_pyramid, levels, device, win_h,
                                      win_w, coarse_win, coarse_from_level)
    build()
    out_points = torch.empty((n, 2), dtype=torch.float32, device=device)
    out_ok = torch.empty((n,), dtype=torch.bool, device=device)
    if n:
        _launch("lk_fwd_bwd", _lib.lk_fwd_bwd_launch, prev, nxt, dims, levels, bwd_top,
                iterations, float(eps * eps), float(max_roundtrip * max_roundtrip),
                points.data_ptr(), valid.data_ptr(), out_points.data_ptr(),
                out_ok.data_ptr(), n, torch.cuda.current_stream(device).cuda_stream)
    return out_points, out_ok


def lk_pyramid_cuda(prev_pyramid, next_pyramid, points, valid, levels: int = 4,
                    win_h: int = 53, win_w: int = 53, iterations: int = 10,
                    eps: float = 0.03, coarse_win: int | None = None,
                    coarse_from_level: int = 1):
    """Launch the forward-only kernel (one CTA per point) on the current stream."""
    device, n = _check_points(points, valid)
    prev, nxt, dims = _check_pyramids(prev_pyramid, next_pyramid, levels, device, win_h,
                                      win_w, coarse_win, coarse_from_level)
    build()
    out_flow = torch.empty((n, 2), dtype=torch.float32, device=device)
    out_ok = torch.empty((n,), dtype=torch.bool, device=device)
    if n:
        _launch("lk_pyramid", _lib.lk_pyramid_launch, prev, nxt, dims, levels, iterations,
                float(eps * eps), points.data_ptr(), valid.data_ptr(), out_flow.data_ptr(),
                out_ok.data_ptr(), n, torch.cuda.current_stream(device).cuda_stream)
    return out_flow, out_ok


def _check_level_window(shape, win_h: int, win_w: int):
    lh, lw = shape
    if win_h < 1 or win_w < 1 or win_h + 3 > lh or win_w + 3 > lw:
        raise ValueError(f"a {win_h}x{win_w} LK window needs a level of at least "
                         f"{win_h + 3}x{win_w + 3}, got {lh}x{lw}")


def lk_level_cuda(prev_img, next_img, points, guesses, valid, win_h: int, win_w: int,
                  iterations: int = 10, eps: float = 0.03):
    """Launch the single-level kernel (one CTA per point) on the current stream."""
    device, n = _check_points(points, valid, ("guesses", guesses))
    _check("prev_img", prev_img, device, torch.float32, ndim=2)
    _check("next_img", next_img, device, torch.float32, shape=prev_img.shape)
    _check_level_window(prev_img.shape, win_h, win_w)
    build()
    out_guesses = torch.empty((n, 2), dtype=torch.float32, device=device)
    out_ok = torch.empty((n,), dtype=torch.bool, device=device)
    lh, lw = prev_img.shape
    if n:
        _launch("lk_level", _lib.lk_level_launch, prev_img.data_ptr(), next_img.data_ptr(),
                lh, lw, win_h, win_w, iterations, float(eps * eps), points.data_ptr(),
                guesses.data_ptr(), valid.data_ptr(), out_guesses.data_ptr(),
                out_ok.data_ptr(), n, torch.cuda.current_stream(device).cuda_stream)
    return out_guesses, out_ok


# ---------------------------------------------------------------------------
# plain PyTorch versions
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


def _level_reference(src, dst, tlx, tly, gx, gy, valid, wh: int, ww: int,
                     iterations: int, eps_sq: float, taken=None):
    """One LK level of all points in lockstep from the guesses (gx, gy); a
    converged point's step is frozen (the Pallas semantics).  Returns (gx, gy,
    lvl_ok).  ``taken``, a list, receives the [N] count of iterations each point
    really ran (a point stops after the step that falls under eps)."""
    tp = _sample_windows(src, tlx - 1.0, tly - 1.0, wh + 2, ww + 2)
    t = tp[:, 1:-1, 1:-1]
    ix = 0.5 * (tp[:, 1:-1, 2:] - tp[:, 1:-1, :-2])
    iy = 0.5 * (tp[:, 2:, 1:-1] - tp[:, :-2, 1:-1])
    gxx = (ix * ix).sum(dim=(1, 2))
    gxy = (ix * iy).sum(dim=(1, 2))
    gyy = (iy * iy).sum(dim=(1, 2))
    det = gxx * gyy - gxy * gxy
    lvl_ok = (det > 1e-6) & valid
    inv_det = torch.where(lvl_ok, 1.0 / torch.where(lvl_ok, det, torch.ones_like(det)),
                          torch.zeros_like(det))
    done = ~lvl_ok
    n_taken = torch.zeros_like(done, dtype=torch.int64)
    for _ in range(iterations):
        if bool(done.all()):
            break
        n_taken += ~done
        j = _sample_windows(dst, tlx + gx, tly + gy, wh, ww)
        diff = t - j
        bx = (ix * diff).sum(dim=(1, 2))
        by = (iy * diff).sum(dim=(1, 2))
        dx = torch.where(done, torch.zeros_like(bx), (gyy * bx - gxy * by) * inv_det)
        dy = torch.where(done, torch.zeros_like(by), (gxx * by - gxy * bx) * inv_det)
        gx = gx + dx
        gy = gy + dy
        done = done | (dx * dx + dy * dy < eps_sq)
    if taken is not None:
        taken.append(n_taken)
    return gx, gy, lvl_ok


def _top_left(p, win: int, size: int):
    return torch.clamp(p - (win - 1) / 2.0, 2.0, size - win - 3.0)


def _track_direction_reference(src, dst, px, py, valid, top: int, dims, wins,
                               iterations: int, eps_sq: float, taken=None):
    """Coarse-to-fine LK of all points from level ``top`` down, zero-seeded.
    ``taken``, a list, receives one [N] iteration count per level, top first."""
    gx = torch.zeros_like(px)
    gy = torch.zeros_like(py)
    ok = valid.clone()
    for lvl in range(top, -1, -1):
        (lh, lw), (wh, ww) = dims[lvl], wins[lvl]
        scale = 0.5 ** lvl
        gx, gy, lvl_ok = _level_reference(
            src[lvl], dst[lvl], _top_left(px * scale, ww, lw), _top_left(py * scale, wh, lh),
            gx, gy, valid, wh, ww, iterations, eps_sq, taken=taken)
        if lvl == 0:  # only the finest level sets status
            ok = ok & lvl_ok
        else:
            gx = gx * 2.0
            gy = gy * 2.0
    return gx, gy, ok


def lk_fwd_bwd_reference(prev_pyramid, next_pyramid, points, valid, levels: int = 4,
                         win_h: int = 53, win_w: int = 53, iterations: int = 10,
                         eps: float = 0.03, max_roundtrip: float = 35.0,
                         bwd_levels: int | None = None,
                         coarse_win: int | None = None, coarse_from_level: int = 1):
    """Plain PyTorch version of the fused kernel: same semantics, batched."""
    dims = _dims(prev_pyramid, levels)
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


def lk_pyramid_reference(prev_pyramid, next_pyramid, points, valid, levels: int = 4,
                         win_h: int = 53, win_w: int = 53, iterations: int = 10,
                         eps: float = 0.03, coarse_win: int | None = None,
                         coarse_from_level: int = 1):
    """Plain PyTorch version of the forward-only kernel."""
    dims = _dims(prev_pyramid, levels)
    wins = window_sizes(dims, win_h, win_w, coarse_win, coarse_from_level)
    gx, gy, ok = _track_direction_reference(
        prev_pyramid, next_pyramid, points[:, 0].to(torch.float32),
        points[:, 1].to(torch.float32), valid, levels, dims, wins, iterations,
        float(eps * eps))
    return torch.stack([gx, gy], dim=-1), ok


def lk_level_reference(prev_img, next_img, points, guesses, valid, win_h: int,
                       win_w: int, iterations: int = 10, eps: float = 0.03):
    """Plain PyTorch version of the single-level kernel."""
    _check_level_window(prev_img.shape, win_h, win_w)
    lh, lw = prev_img.shape
    gx, gy, ok = _level_reference(
        prev_img, next_img, _top_left(points[:, 0], win_w, lw),
        _top_left(points[:, 1], win_h, lh), guesses[:, 0].to(torch.float32),
        guesses[:, 1].to(torch.float32), valid, win_h, win_w, iterations,
        float(eps * eps))
    return torch.stack([gx, gy], dim=-1), ok


def roundtrip_px_reference(prev_pyramid, next_pyramid, points, tracked, levels: int = 4,
                           win_h: int = 53, win_w: int = 53, iterations: int = 10,
                           eps: float = 0.03, bwd_levels: int | None = None,
                           coarse_win: int | None = None, coarse_from_level: int = 1):
    """The distance the round-trip gate compares, from the plain version: for each
    row, |forward flow + backward flow| with the backward pass run from
    ``tracked`` (the forward result).  Comparisons of two LK versions use it to
    excuse flag disagreements on rows that sit at the gate."""
    dims = _dims(prev_pyramid, levels)
    wins = window_sizes(dims, win_h, win_w, coarse_win, coarse_from_level)
    bgx, bgy, _ = _track_direction_reference(
        next_pyramid, prev_pyramid, tracked[:, 0], tracked[:, 1],
        torch.ones(tracked.shape[0], dtype=torch.bool, device=tracked.device),
        levels if bwd_levels is None else bwd_levels, dims, wins, iterations,
        float(eps * eps))
    flow = tracked - points
    return torch.hypot(flow[:, 0] + bgx, flow[:, 1] + bgy)


# ---------------------------------------------------------------------------
# what a call needs: iterations, samples, FLOPs, bytes
# ---------------------------------------------------------------------------

#: FLOPs of one bilinear sample: 6 multiplies and 3 additions (the weights 1 - f
#: are the same for the whole window and are not counted)
FLOPS_PER_SAMPLE = 9
#: a window pixel of the structure tensor: 2 central differences (a subtraction
#: and a halving each), 3 products, 3 additions into the sums
FLOPS_PER_TENSOR_PIXEL = 10
#: a window pixel of one Gauss-Newton iteration: its bilinear sample (9), the
#: difference from the template, 2 products with the gradients, 2 additions
FLOPS_PER_ITERATION_PIXEL = 14


def _pass_work(direction: str, top: int, wins, valid, taken):
    """Per-level records of one coarse-to-fine pass: the template patch and the
    structure tensor once per valid point, the iterations as counted."""
    n_valid = int(valid.sum())
    records = []
    for lvl, n_taken in zip(range(top, -1, -1), taken):
        wh, ww = wins[lvl]
        total = int(n_taken.sum())
        samples = n_valid * (wh + 2) * (ww + 2) + total * wh * ww
        flops = (n_valid * ((wh + 2) * (ww + 2) * FLOPS_PER_SAMPLE
                            + wh * ww * FLOPS_PER_TENSOR_PIXEL)
                 + total * wh * ww * FLOPS_PER_ITERATION_PIXEL)
        records.append({"direction": direction, "level": lvl, "window": (wh, ww),
                        "points": n_valid, "iterations": total,
                        "iterations_max": int(n_taken.max()) if n_taken.numel() else 0,
                        "samples": samples, "flops": flops})
    return records


def _work_summary(records, n_bytes: int, chain):
    return {"levels": records, "samples": sum(r["samples"] for r in records),
            "flops": sum(r["flops"] for r in records), "bytes": n_bytes,
            "iterations": sum(r["iterations"] for r in records),
            "longest_chain": int(chain.max()) if chain.numel() else 0}


def lk_work(prev_pyramid, next_pyramid, points, valid, levels: int = 4, win_h: int = 53,
            win_w: int = 53, iterations: int = 10, eps: float = 0.03,
            backward: bool = True, bwd_levels: int | None = None,
            coarse_win: int | None = None, coarse_from_level: int = 1):
    """What ``lk_fwd_bwd`` (``backward=True``) or ``lk_pyramid`` (``False``)
    needs on these inputs, counted by running the plain sweep (any device).

    A point runs, at each level of a pass, one (win+2)^2 bilinear template patch
    and one structure tensor if it is valid, and the Gauss-Newton iterations it
    really takes: none at a singular level, and none after the step that falls
    under ``eps``.  The backward pass runs only points the forward pass kept.
    The counts use one convention: ``FLOPS_PER_SAMPLE`` = 9 a bilinear sample,
    ``FLOPS_PER_TENSOR_PIXEL`` = 10 a window pixel of the structure tensor,
    ``FLOPS_PER_ITERATION_PIXEL`` = 14 a window pixel of one iteration (its
    sample included).  Bytes count every input once and every output once: both
    pyramids' levels 0..``levels``, the points and flags, the results.  Both are
    upper counts of what a kernel must do: 9 FLOPs charge every sample its own
    four taps (neighbours that share row blends need about 6), and the windows
    of a few hundred points cover only a part of the finer levels.

    Returns a dict: ``samples``, ``flops``, ``bytes``, ``iterations`` (sum over
    points, levels and passes), ``longest_chain`` (the most iterations one point
    runs in sequence) and ``levels``, one record per pass and level."""
    dims = _dims(prev_pyramid, levels)
    wins = window_sizes(dims, win_h, win_w, coarse_win, coarse_from_level)
    px = points[:, 0].to(torch.float32)
    py = points[:, 1].to(torch.float32)
    kw = dict(dims=dims, wins=wins, iterations=iterations, eps_sq=float(eps * eps))
    fwd_taken = []
    fgx, fgy, fok = _track_direction_reference(prev_pyramid, next_pyramid, px, py, valid,
                                               levels, taken=fwd_taken, **kw)
    records = _pass_work("forward", levels, wins, valid, fwd_taken)
    chain = sum(fwd_taken)
    if backward:
        bwd_top = levels if bwd_levels is None else bwd_levels
        bwd_taken = []
        _track_direction_reference(next_pyramid, prev_pyramid, px + fgx, py + fgy, fok,
                                   bwd_top, taken=bwd_taken, **kw)
        records += _pass_work("backward", bwd_top, wins, fok, bwd_taken)
        chain = chain + sum(bwd_taken)
    n = points.shape[0]
    n_bytes = (2 * 4 * sum(lh * lw for lh, lw in dims)   # both pyramids, f32
               + n * (8 + 1) + n * (8 + 1))              # points + valid in, result + ok out
    return _work_summary(records, n_bytes, chain)


def lk_level_work(prev_img, next_img, points, guesses, valid, win_h: int, win_w: int,
                  iterations: int = 10, eps: float = 0.03):
    """What ``lk_level`` needs on these inputs; the counts and the returned dict
    are :func:`lk_work`'s, for one level and one pass."""
    _check_level_window(prev_img.shape, win_h, win_w)
    lh, lw = prev_img.shape
    taken = []
    _level_reference(prev_img, next_img, _top_left(points[:, 0], win_w, lw),
                     _top_left(points[:, 1], win_h, lh), guesses[:, 0].to(torch.float32),
                     guesses[:, 1].to(torch.float32), valid, win_h, win_w, iterations,
                     float(eps * eps), taken=taken)
    n = points.shape[0]
    n_bytes = 2 * 4 * lh * lw + n * (8 + 8 + 1) + n * (8 + 1)
    return _work_summary(_pass_work("forward", 0, ((win_h, win_w),), valid, taken),
                         n_bytes, taken[0])
