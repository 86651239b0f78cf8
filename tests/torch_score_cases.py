"""Inputs of the RANSAC scoring's tests (``test_torch_ransac_score.py`` on the
CPU, ``test_torch_cuda.py`` on the card): seeded feature sets of every shape
the scoring meets, with hypotheses around the true pose as the pose optimizer
makes them.  Imports torch and the port only."""

import numpy as np
import torch

from rgbd_slam_tpu_torch.pose.residuals import prepare_features

from torch_lm_cases import CAM, scene

#: the main path's feature capacities and the scores' caps
#: (``optimizer._REFIT_CAPS``)
MAIN = (512, 256, 32, 16)
CAPS = (256, 128, 32, 16)
#: each kind of feature set: (capacities, the share of rows live per type,
#: what is switched off); rows past a cap in the main and wide shapes, types
#: that meet inside a warp in the odd ones, two passes of 1024 rows in the wide
KINDS = {
    "main": (MAIN, (0.7, 0.7, 0.5, 0.6), ()),
    "lines_off": (MAIN, (0.7, 0.7, 0.5, 0.6), ("lines",)),
    "planes_off": (MAIN, (0.7, 0.7, 0.5, 0.6), ("planes",)),
    "sparse": (MAIN, (0.1, 0.1, 0.2, 0.2), ()),
    "empty": (MAIN, (0.0, 0.0, 0.0, 0.0), ()),
    "odd": ((70, 33, 5, 7), (0.8, 0.8, 0.8, 0.8), ()),
    "tiny": ((24, 8, 4, 6), (0.9, 0.9, 0.9, 0.9), ()),
    "wide": ((1024, 256, 32, 16), (0.8, 0.8, 0.8, 0.8), ()),
}
#: the main path's hypotheses: 32 from the LM, 16 x 4 from P3P
HYPOTHESES = 96


def features(seed, kind="main"):
    """A posed scene's features at ``KINDS[kind]``'s capacities, every row
    filled, a seeded subset live, a fifth of the observations moved far off
    (outliers) and some dead rows NaN.  Returns (features, the true pose's
    coefficients)."""
    caps, live, off = KINDS[kind]
    feats, c_true, _ = scene(seed, counts=caps, caps=caps)
    rng = np.random.default_rng(seed + 300)

    def mask(n, share, name):
        if name in off:
            return torch.zeros(n, dtype=torch.bool)
        return torch.as_tensor(rng.uniform(size=n) < share)

    def outliers(t, scale):
        hit = torch.as_tensor(rng.uniform(size=t.shape[:1]) < 0.2)[:, None]
        return torch.where(hit, t + torch.as_tensor(rng.normal(0, scale, t.shape),
                                                     dtype=t.dtype), t)

    names = ("points", "points2d", "planes", "lines")
    masks = [mask(n, s, name) for n, s, name in zip(caps, live, names)]
    point_world = feats.point_world.clone()
    dead = ~masks[0] & torch.as_tensor(rng.uniform(size=caps[0]) < 0.3)
    point_world[dead] = float("nan")
    feats = feats._replace(
        point_world=point_world, point_obs_uv=outliers(feats.point_obs_uv, 20.0),
        point2d_obs_uv=outliers(feats.point2d_obs_uv, 20.0),
        plane_cam=outliers(feats.plane_cam, 0.3),
        line_obs_p0=outliers(feats.line_obs_p0, 10.0),
        point_mask=masks[0], point2d_mask=masks[1], plane_mask=masks[2], line_mask=masks[3])
    return feats, c_true


def hypotheses(seed, c_true, h=HYPOTHESES):
    """``h`` hypotheses around ``c_true``: a third close (0.3 mm, 3e-4), a third
    farther (5 mm, 3e-3), the rest far (200 mm, 0.2); two copies of one close
    hypothesis (equal ranks), one with NaN coefficients; ``ok`` [h] bool false
    for a tenth and for the NaN one."""
    rng = np.random.default_rng(seed + 400)
    scale = np.repeat([[0.3] * 3 + [3e-4] * 3, [5.0] * 3 + [3e-3] * 3,
                       [200.0] * 3 + [0.2] * 3], [h // 3, h // 3, h - 2 * (h // 3)], axis=0)
    coeffs = c_true.double().numpy() + rng.normal(0, 1, (h, 6)) * scale
    coeffs = torch.as_tensor(coeffs[rng.permutation(h)], dtype=torch.float32)
    ok = torch.as_tensor(rng.uniform(size=h) > 0.1)
    if h >= 8:
        coeffs[5] = coeffs[2]
        coeffs[7] = float("nan")
        ok[7] = False
    return coeffs.contiguous(), ok


def case(seed, kind="main", h=HYPOTHESES, device="cpu"):
    """(hypotheses [h, 6], ok [h], prepared features, caps) on ``device``."""
    feats, c_true = features(seed, kind)
    coeffs, ok = hypotheses(seed, c_true, h)
    prep = prepare_features(feats, CAM)
    prep = type(prep)(*(t.to(device) for t in prep))
    return coeffs.to(device), ok.to(device), prep, CAPS
