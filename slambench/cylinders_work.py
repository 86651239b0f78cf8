"""What the step's cylinder stage needs on the card, for its roofline share
(``slambench/metrics/cylinders_roofline.py``).  Pure arithmetic from the
grid's size and the live region slots, so that the CPU tests hold it.

Frozen copies, from commit 155649a: :func:`cylinders_work` and its ``FLOPS_*``
constants of ``rgbd_slam_tpu_torch/ops/cylinders_cuda.py``, and the stage's
sizes of ``rgbd_slam_tpu_torch/features/primitives.py`` at the default
detection configuration (``REGIONS``: ``MAX_PLANES + MAX_CYLINDERS``;
``SUBSEGMENTS``: ``CYL_SUBSEGMENTS``; ``HYPOTHESES``: ``_msac_iterations``);
a test holds them equal to the program's.
"""

from __future__ import annotations

#: candidate regions of the stage, MSAC sub-segments a region and hypotheses a
#: round
REGIONS = 20
SUBSEGMENTS = 3
HYPOTHESES = 43
#: operations :func:`cylinders_work` counts: a (region, cell) pair of the
#: axis gate (six weighted products and the count), a region's eig3 and
#: score, and for each live slot: a cell's projection, a hypothesis's triplet
#: sums and LLS fit, a (hypothesis, cell) distance with its truncation and
#: weighted sum, and a cell's inlier test, refit sums and MSE term a round
FLOPS_AXIS_PAIR = 19
FLOPS_AXIS_REGION = 160
FLOPS_PROJECT_CELL = 30
FLOPS_HYPOTHESIS = 60
FLOPS_DISTANCE = 23
FLOPS_REFIT_CELL = 59


def cylinders_work(c: int, k: int, n_hyp: int, subsegments: int, live: int) -> dict:
    """What the stage needs, for the kernel's roofline bound: bytes (the
    normals, means, planar flags, region masks and candidate flags read once;
    every output written once) and float operations: the axis gate of all
    ``k`` regions over ``c`` cells, and for each of the ``live`` selected
    regions (the data's: a dead slot does no more) the projection of every
    cell and, each of ``subsegments`` rounds, ``n_hyp`` hypotheses scored
    against every cell and the inlier refit."""
    read = 12 * c + 12 * c + c + k * c + k
    written = 12 * k + k + k + 12 * k * subsegments + 4 * k * subsegments \
        + k * subsegments + 4 * k * subsegments + k * subsegments * c
    flops = k * (FLOPS_AXIS_PAIR * c + FLOPS_AXIS_REGION) + live * (
        FLOPS_PROJECT_CELL * c + subsegments * (
            FLOPS_HYPOTHESIS * n_hyp + FLOPS_DISTANCE * n_hyp * c + FLOPS_REFIT_CELL * c))
    return {"live": live, "bytes": read + written, "flops": flops}


def stage_work(h: int, w: int, patch: int, live: float) -> dict:
    """The stage's work on an H x W frame of ``patch`` px cells at the
    default sizes, with ``live`` region slots (a frame's mean may be a
    fraction)."""
    return cylinders_work((h // patch) * (w // patch), REGIONS, HYPOTHESES, SUBSEGMENTS, live)
