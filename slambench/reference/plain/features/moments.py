"""Centered second-moment accumulators for plane fitting (port of
``rgbd_slam_tpu/features/moments.py``).

Moments are stored centered, (count, mean, M2) with
``M2 = sum (p - mean)(p - mean)^T``, and combined with Chan's parallel-axis
update: additive like raw sums, but stable in f32 at mm scales.
"""

from __future__ import annotations

import torch


def from_points(points, weights):
    """Masked point set -> (count, mean [3], m2 [3,3]).  points [..., P, 3],
    weights [..., P]."""
    cnt = weights.sum(dim=-1)
    safe = torch.clamp_min(cnt, 1.0)
    mean = (points * weights[..., None]).sum(dim=-2) / safe[..., None]
    rel = points - mean[..., None, :]
    m2 = torch.einsum("...pi,...pj->...ij", rel * weights[..., None], rel)
    return cnt, mean, m2


def combine(cnts, means, m2s, mask):
    """Combine per-cell accumulators over a masked set: cnts [..., C], means
    [..., C, 3], m2s [..., C, 3, 3], mask [..., C] (broadcast against each
    other).  Returns (count, mean, m2) of the union."""
    w = torch.where(mask, cnts, torch.zeros_like(cnts))
    total = w.sum(dim=-1)
    safe = torch.clamp_min(total, 1.0)
    mean = (means * w[..., None]).sum(dim=-2) / safe[..., None]
    dev = means - mean[..., None, :]
    shift = torch.einsum("...c,...ci,...cj->...ij", w, dev, dev)
    m2 = torch.where(mask[..., None, None], m2s, torch.zeros_like(m2s)).sum(dim=-3) + shift
    return total, mean, m2


def combine_pair(cnt_a, mean_a, m2_a, cnt_b, mean_b, m2_b):
    """Combine two accumulators."""
    total = cnt_a + cnt_b
    safe = torch.clamp_min(total, 1.0)
    mean = (mean_a * cnt_a[..., None] + mean_b * cnt_b[..., None]) / safe[..., None]
    da = mean_a - mean
    db = mean_b - mean
    return (total, mean,
            m2_a + m2_b + cnt_a[..., None, None] * (da[..., :, None] * da[..., None, :])
            + cnt_b[..., None, None] * (db[..., :, None] * db[..., None, :]))


def raw_second_moment(cnt, mean, m2):
    """The raw moment matrix ``sum p p^T`` (source of the plane-parameter
    covariance)."""
    return m2 + cnt[..., None, None] * (mean[..., :, None] * mean[..., None, :])
