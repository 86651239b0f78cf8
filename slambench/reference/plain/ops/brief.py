"""BRIEF-256 binary descriptors (port of ``rgbd_slam_tpu/ops/brief.py``).

Same sampling pattern (numpy ``default_rng(12345)``) and the same bit layout as the
JAX package's uint32 words, held in int32 (bit 31 is the sign bit): bit j of a
descriptor is word j // 32, bit j % 32.  The JAX package reads the pattern pixels
with a one-hot [1024, 512] matmul, which returns each pixel exactly; here they are
gathered directly.  Hamming distances count bits with SWAR on int64.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .image import box_filter

PATCH_SIZE = 31
_PATCH = 32
N_BITS = 256
N_WORDS = N_BITS // 32


def _make_pattern(seed: int = 12345):
    """Deterministic BRIEF sampling pattern: isotropic Gaussian pairs with
    sigma = patch/5, rounded to integer offsets and clamped to the patch."""
    rng = np.random.default_rng(seed)
    sigma = PATCH_SIZE / 5.0
    half = PATCH_SIZE // 2
    a = np.rint(np.clip(rng.normal(0.0, sigma, (N_BITS, 2)), -half, half))
    b = np.rint(np.clip(rng.normal(0.0, sigma, (N_BITS, 2)), -half, half))
    return a.astype(np.int32), b.astype(np.int32)


_PATTERN_A, _PATTERN_B = _make_pattern()


@functools.lru_cache(maxsize=None)
def _pattern_offsets(device):
    """The two pattern halves as int64 offsets into the patch, made once per
    device (a host-to-device copy per call would synchronise the stream)."""
    half = PATCH_SIZE // 2
    return tuple(torch.as_tensor(p, dtype=torch.int64, device=device) + half
                 for p in (_PATTERN_A, _PATTERN_B))


def _to_int32_bits(x):
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    return (x - ((x >> 31) & 1) * (1 << 32)).to(torch.int32)


def compute_brief(img, xy, valid):
    """Descriptors for keypoints ``xy`` [N, 2] on image [H, W].

    Returns (descriptors [N, 8] int32 bit patterns, desc_valid [N] bool); points
    whose patch leaves the image are invalidated."""
    h, w = img.shape
    n = xy.shape[0]
    smoothed = box_filter(img, 9)
    half = PATCH_SIZE // 2
    ci = torch.round(xy).to(torch.int64)
    corner_x = (ci[:, 0] - half).clamp(0, w - _PATCH)
    corner_y = (ci[:, 1] - half).clamp(0, h - _PATCH)

    def pattern_values(off):
        ys = corner_y[:, None] + off[None, :, 1]
        xs = corner_x[:, None] + off[None, :, 0]
        return smoothed[ys, xs]                               # [N, 256]

    off_a, off_b = _pattern_offsets(img.device)
    bits = pattern_values(off_a) < pattern_values(off_b)
    shifts = torch.arange(32, device=img.device, dtype=torch.int64)
    words = torch.sum(bits.to(torch.int64).reshape(n, N_WORDS, 32) << shifts, dim=-1)
    desc = _to_int32_bits(words)

    inside = ((xy[:, 0] >= half) & (xy[:, 0] < w - half)
              & (xy[:, 1] >= half) & (xy[:, 1] < h - half))
    return desc, valid & inside


def popcount32(x):
    """Set bits of each 32-bit word (int32 or int64 holding 32 bits) -> int64."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_distance_matrix(desc_a, desc_b):
    """Pairwise Hamming distances [A, B] int32 between descriptor sets [A, 8] and
    [B, 8]."""
    x = torch.bitwise_xor(desc_a[:, None, :], desc_b[None, :, :])
    return torch.sum(popcount32(x), dim=-1).to(torch.int32)
