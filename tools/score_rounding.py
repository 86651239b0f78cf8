"""How the card rounds the plain scoring chain's matrix products and
reductions, for ``csrc/ransac_score.cu`` to round alike.

    python tools/score_rounding.py          # on the card; prints one line a quantity

The RANSAC scoring kernel's decisions equal its plain version's only because
each tested value is the plain version's on the card to the bit.  The plain
chain (``se3.coefficients_to_pose``, ``world_to_camera``,
``plane_world_to_camera_matrix``, ``pinhole.apply_transform``,
``planes.transform_plane``) calls ``torch.sum``, ``torch.linalg.vector_norm``
and small ``torch.matmul``s, whose kernels on the card choose an order of the
terms and fuse some products into the sums.  This tool runs each of those
intermediates on the card, for a batch of 96 poses (the hypotheses) and for
one pose at a time (the best pose's masks, the refit), against numpy
emulations of every order of the terms with each step fused or not (and the
pairwise sums of four terms), and prints for each the candidates that match
most elements and the share that some candidate matches.  On an H100 with
torch 2.11.0+cu128 it found: the sum of three squares
``(c0^2 + c2^2) + c1^2``; the batched products of points and planes the terms
in pairs, a pair's second product fused (``c012_10``, ``p0123_10``), at the
main path's counts (96 hypotheses by 544 rows, one pose by 1,056) and at 96
by 50, 100, 400, 512 or 700 and 64 by 1,056; but ``c021_10`` at 96 by 150,
200 or 300 and at 16 or 32 by 1,056, and a mix past 65,535 matrices
(``BATCH_SHAPES``): the product's kernel is the library's choice by shape;
the pose's translation and plane row ``c012_11`` (a fused chain) for a batch
of poses and ``c012_10`` for one pose; the norm of a 2-vector unfused.  The
kernel follows the main path's shapes, so other capacities may part from the
plain version by an ulp, and a decision only at a near-tie.  Run it again
after a change of torch, of the chain or of the capacities, and make the
kernel's ``dot_pairs``, ``dot_chain``, ``pose_of`` and ``norm2`` follow.
Exits 1 without a card.
"""

from __future__ import annotations

import itertools
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from rgbd_slam_tpu_torch.geometry import pinhole, planes, se3  # noqa: E402

F32, F64 = np.float32, np.float64
#: rows of projected points: the compacted set's and the whole set's
POINT_ROWS = (544, 1056)
#: (hypotheses, rows) of the points' product at other batch counts
BATCH_SHAPES = ((96, 50), (96, 150), (32, 150), (96, 100), (96, 200), (96, 300), (96, 400),
                (96, 512), (16, 1056), (32, 1056), (64, 1056), (96, 700))


def _mul(a, b):
    return (a.astype(F64) * b.astype(F64)).astype(F32)


def _add(a, b):
    return (a.astype(F64) + b.astype(F64)).astype(F32)


def _fma(a, b, c):
    """A fused multiply-add in float32: the product is exact in float64."""
    return (a.astype(F64) * b.astype(F64) + c.astype(F64)).astype(F32)


def candidates(a, x) -> dict:
    """Every rounding of sum_k a[..., k] x[..., k]: an order of the terms
    (``c`` and the order) with each later step fused (1) or not (0), and for
    four terms the sum of two pairs (``p``)."""
    k = a.shape[-1]
    out = {}
    for perm in itertools.permutations(range(k)):
        for fused in itertools.product((0, 1), repeat=k - 1):
            s = _mul(a[..., perm[0]], x[..., perm[0]])
            for j, f in zip(perm[1:], fused):
                s = _fma(a[..., j], x[..., j], s) if f else _add(s, _mul(a[..., j], x[..., j]))
            out["c" + "".join(map(str, perm)) + "_" + "".join(map(str, fused))] = s
    if k == 4:
        def pair(i, j, f):
            return _fma(a[..., j], x[..., j], _mul(a[..., i], x[..., i])) if f \
                else _add(_mul(a[..., i], x[..., i]), _mul(a[..., j], x[..., j]))

        for (p, q), (r, t) in (((0, 1), (2, 3)), ((0, 2), (1, 3)), ((0, 3), (1, 2))):
            for f1, f2 in itertools.product((0, 1), repeat=2):
                out[f"p{p}{q}{r}{t}_{f1}{f2}"] = _add(pair(p, q, f1), pair(r, t, f2))
    return out


def matches(got, cands: dict) -> dict:
    """The four candidates that match most elements of ``got``, and the share
    of elements some candidate matches."""
    shares = {name: float(np.mean(got == c)) for name, c in cands.items()}
    some = np.zeros(got.shape, bool)
    for c in cands.values():
        some |= got == c
    return {"best": sorted(shares.items(), key=lambda kv: -kv[1])[:4],
            "any": float(some.mean()), "n": int(got.size)}


def _stack(results):
    """Concatenate per-call (got, candidates) pairs."""
    got = np.concatenate([g.reshape(-1) for g, _ in results])
    names = results[0][1].keys()
    return got, {n: np.concatenate([c[n].reshape(-1) for _, c in results]) for n in names}


def probe(device, seed: int = 11) -> dict:
    g = torch.Generator().manual_seed(seed)

    def coeffs(n):
        return torch.cat([torch.randn(n, 3, generator=g) * 200,
                          torch.randn(n, 3, generator=g) * 0.3], -1)

    pts = {n: torch.randn(n, 3, generator=g) * 1500 + torch.tensor([2500.0, 0.0, 0.0])
           for n in POINT_ROWS}
    plane = torch.randn(32, 4, generator=g) * torch.tensor([1.0, 1.0, 1.0, 2000.0])
    res = {}
    for tag, calls in (("batch", [coeffs(96).to(device)]),
                       ("one_pose", [c.to(device) for c in coeffs(64)])):
        alpha, trans, last, points, plane_rows = [], [], [], {n: [] for n in POINT_ROWS}, []
        for c in calls:
            quat, position = se3.coefficients_to_pose(c)
            sq = (c[..., 3:] * c[..., 3:]).reshape(-1, 3).cpu().numpy()
            alpha.append((torch.sum(c[..., 3:] * c[..., 3:], dim=-1).cpu().numpy(),
                          candidates(sq, np.ones_like(sq))))
            c2w = se3.camera_to_world(quat, position)
            w2c = se3.world_to_camera(quat, position)
            rt = c2w[..., :3, :3].transpose(-1, -2).reshape(-1, 3, 3).cpu().numpy()
            t = w2c[..., :3, 3].reshape(-1, 3).cpu().numpy()
            trans.append((-t, candidates(rt, c2w[..., :3, 3].reshape(-1, 1, 3).cpu().numpy())))
            pw = se3.plane_world_to_camera_matrix(w2c)
            r = w2c[..., :3, :3].reshape(-1, 3, 3).cpu().numpy()
            last.append((-pw[..., 3, :3].reshape(-1, 3).cpu().numpy(),
                         candidates(np.swapaxes(r, -1, -2), t[:, None, :])))
            m = w2c[..., None, :, :]
            rot, tr = m[..., :3, :3].cpu().numpy(), m[..., :3, 3].cpu().numpy()
            for n, p in pts.items():
                got = pinhole.apply_transform(m, p.to(device)).cpu().numpy()
                points[n].append((got, {k: _add(v, tr) for k, v in
                                        candidates(rot, p.numpy()[:, None, :]).items()}))
            got = planes.transform_plane(plane.to(device), pw[..., None, :, :]).cpu().numpy()
            plane_rows.append((got, candidates(pw[..., None, :, :].cpu().numpy(),
                                               plane.numpy()[:, None, :])))
        res[f"alpha_{tag}"] = matches(*_stack(alpha))
        res[f"translation_{tag}"] = matches(*_stack(trans))
        res[f"plane_row_{tag}"] = matches(*_stack(last))
        for n in POINT_ROWS:
            res[f"points_{tag}_{n}"] = matches(*_stack(points[n]))
        res[f"planes_{tag}"] = matches(*_stack(plane_rows))
    # the points' product at other batch counts (hypotheses x rows)
    for h, n in BATCH_SHAPES:
        p = torch.randn(n, 3, generator=g) * 1500 + torch.tensor([2500.0, 0.0, 0.0])
        quat, position = se3.coefficients_to_pose(coeffs(h).to(device))
        m = se3.world_to_camera(quat, position)[..., None, :, :]
        got = pinhole.apply_transform(m, p.to(device)).cpu().numpy()
        rot, tr = m[..., :3, :3].cpu().numpy(), m[..., :3, 3].cpu().numpy()
        cands = {k: _add(v, tr) for k, v in candidates(rot, p.numpy()[:, None, :]).items()}
        res[f"points_{h}x{n}"] = matches(got, cands)
    d = (torch.randn(96, 128, 2, generator=g) * 30).to(device)
    got = torch.linalg.vector_norm(d, dim=-1).cpu().numpy()
    x = d.cpu().numpy()
    res["norm"] = matches(got, {
        name: np.sqrt(s.astype(F64)).astype(F32) for name, s in (
            ("unfused", _add(_mul(x[..., 0], x[..., 0]), _mul(x[..., 1], x[..., 1]))),
            ("fused", _fma(x[..., 1], x[..., 1], _mul(x[..., 0], x[..., 0]))))})
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("score_rounding: no CUDA device", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda)
    for name, found in probe(torch.device("cuda")).items():
        print(name, json.dumps(found))
    return 0


if __name__ == "__main__":
    sys.exit(main())
