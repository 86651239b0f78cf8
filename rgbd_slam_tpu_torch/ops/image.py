"""Core image operations (port of ``rgbd_slam_tpu/ops/image.py``): pyramids, box
filter, gradients, bilinear sampling, max pool and the border test, on [H, W]
float32 images.

Stencil sums are written as the same sequence of shifted adds as the JAX
package, so they round the same way; the horizontal pyr_down pass stays a banded
decimation matmul, which the JAX package also leaves to XLA outside any kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

_GAUSS_5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _edge_rows(img, r: int):
    """Pad rows by ``r`` with edge replication."""
    h = img.shape[0]
    idx = torch.arange(-r, h + r, device=img.device).clamp(0, h - 1)
    return img[idx]


def _edge_cols(img, r: int):
    w = img.shape[1]
    idx = torch.arange(-r, w + r, device=img.device).clamp(0, w - 1)
    return img[:, idx]


def box_filter(img, size: int):
    """Box sum filter of odd ``size`` with edge replication (the BRIEF
    pre-smoothing): two separable windows of sequential adds."""
    r = size // 2
    h, w = img.shape
    padded = _edge_cols(_edge_rows(img, r), r)
    out = torch.zeros((h, w + 2 * r), dtype=img.dtype, device=img.device)
    for i in range(size):
        out = out + padded[i:i + h]
    out2 = torch.zeros_like(img)
    for i in range(size):
        out2 = out2 + out[:, i:i + w]
    return out2


@functools.lru_cache(maxsize=None)
def _decim_matrix(w: int, dtype, device):
    """[w, ceil(w/2)] matrix fusing the horizontal 5-tap binomial blur with 2x
    column decimation (edge-replicated taps); made once per width, dtype and
    device (a host-to-device copy per call would synchronise the stream)."""
    k = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float64) / 16.0
    wo = (w + 1) // 2
    d = np.zeros((w, wo), np.float32)
    for jj in range(wo):
        for t in range(5):
            j = min(max(2 * jj + t - 2, 0), w - 1)
            d[j, jj] += k[t]
    return torch.as_tensor(d, dtype=dtype, device=device)


def pyr_down(img):
    """Gaussian blur + 2x decimation (cv::pyrDown equivalent)."""
    h, w = img.shape
    padded = _edge_rows(img, 2)
    v = torch.zeros_like(img)
    for i in range(5):
        v = v + _GAUSS_5[i] * padded[i:i + h]
    if h % 2:
        v = torch.cat([v, v[-1:]], dim=0)
    ho = (h + 1) // 2
    v_even = v.reshape(ho, 2 * w)[:, :w]
    return v_even @ _decim_matrix(w, img.dtype, img.device)


def build_pyramid(img, levels: int):
    """Image pyramid [level0=full ... levelN]."""
    pyr = [img]
    for _ in range(levels):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def gradients(img):
    """Central-difference gradients (Ix, Iy); the border columns of Ix and the
    border rows of Iy are zero."""
    ix = torch.zeros_like(img)
    iy = torch.zeros_like(img)
    ix[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    iy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    return ix, iy


def bilinear_sample(img, xy):
    """Bilinear interpolation of an [H, W] image at float (x, y) positions
    [..., 2].  Coordinates are clipped to the valid range (border replication)."""
    h, w = img.shape
    x = xy[..., 0].clamp(0.0, w - 1.000001)
    y = xy[..., 1].clamp(0.0, h - 1.000001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    x1 = torch.clamp_max(x0 + 1, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    fx = x - x0.to(img.dtype)
    fy = y - y0.to(img.dtype)
    flat = img.reshape(-1)
    v00, v01 = flat[y0 * w + x0], flat[y0 * w + x1]
    v10, v11 = flat[y1 * w + x0], flat[y1 * w + x1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def in_border(xy, h: int, w: int, margin: float = 1.0):
    """Strict in-image test with margin."""
    return ((xy[..., 0] >= margin) & (xy[..., 0] < w - margin)
            & (xy[..., 1] >= margin) & (xy[..., 1] < h - margin))


def max_pool_same(img, window: int = 3):
    """Max pool with 'same' (-inf) padding for non-maximum suppression."""
    return F.max_pool2d(img[None, None], window, stride=1,
                        padding=window // 2)[0, 0]
