"""The plane extraction's per-cell pass (``ops.cells_cuda``) on the CPU: its
plain version ``cells_reference``, which ``find_primitives`` runs for a CPU
tensor, against the JAX functions the CUDA kernels replace
(``depth_to_cloud``, ``fit_cells``, ``_edge_maps``, ``_normal_bins`` and the
cloud at the cell centres) on the scenes of ``test_torch_primitives.py``;
``cells_work`` against hand counts; the wrapper raising, and never taking its
plain version, for a CUDA tensor whose library does not build.  The kernels
themselves run only on the card (``tests/test_torch_cuda.py``).

Tolerances, float32 on both sides, as at the head of
``test_torch_primitives.py``: discrete fields (count, planar, the edges, the
centres' valid flags) equal; the normal bins of planar cells equal but where
the JAX normal lies within the normals' 3e-5 of a bin edge (a normal facing
the camera has no azimuth: atan2 of its rounding noise picks its bin); normals of
planar cells 3e-5; d 1e-5 |d| + 1e-3 mm; the distance tolerance 1e-5 of
itself + 1e-4 mm; means 1e-6 of the largest + 1e-3 mm; second moments 1e-5
of the cell's largest diagonal entry (the same sums in the same layout);
the cell-centre points as the cloud, 1e-6 relative + 1e-3 mm.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbd_slam_tpu.features import primitives as j_prim
from rgbd_slam_tpu.ops import depth_cloud as j_depth_cloud
from rgbd_slam_tpu_torch import config as tcfg
from rgbd_slam_tpu_torch.ops import cells_cuda, nvcc
from test_primitives import CFG
from test_torch_primitives import SCENES, _scene_depth, _within

torch.set_num_threads(2)


def _jax_cells(depth, cam):
    """The JAX functions the kernels replace, on one depth map."""
    patch = CFG.depth_patch_size_px
    gh, gw = depth.shape[0] // patch, depth.shape[1] // patch
    cloud, valid = j_depth_cloud.depth_to_cloud(jnp.asarray(depth), cam)
    grid = j_prim.fit_cells(cloud, valid, CFG)
    edges = j_prim._edge_maps(grid, gh, gw, float(np.cos(np.radians(
        CFG.max_plane_merge_angle_d))))
    bins = j_prim._normal_bins(grid.normal)
    cy = np.arange(gh) * patch + patch // 2
    cx = np.arange(gw) * patch + patch // 2
    cloud, valid = np.asarray(cloud), np.asarray(valid)
    return ({k: np.asarray(v) for k, v in grid._asdict().items()}, np.asarray(edges),
            np.asarray(bins), cloud[cy[:, None], cx[None, :]], valid[cy[:, None], cx[None, :]])


@pytest.mark.parametrize("scene", list(SCENES))
def test_cells_reference_matches_jax(scene):
    depth, j_cam, t_cam = _scene_depth(scene)
    depth = np.asarray(depth, np.float32)
    jg, j_edges, j_bins, j_centers, j_cvalid = _jax_cells(depth, j_cam)
    t = cells_cuda.cell_pass(torch.from_numpy(depth), t_cam, tcfg.DetectionConfig())
    tg = {k: v.numpy() for k, v in t._asdict().items()}
    for f in ("count", "planar"):
        np.testing.assert_array_equal(tg[f], jg[f], err_msg=f)
    np.testing.assert_array_equal(tg["edges"], j_edges, err_msg="edges")
    assert tg["edges"].dtype == np.bool_ and tg["edges"].shape == j_edges.shape
    p = jg["planar"]
    differ = p & (tg["bins"] != j_bins)
    n = jg["normal"][differ].astype(np.float64)
    u = np.arccos(np.clip(-n[:, 2], -1, 1)) / np.pi * 20
    v = (np.arctan2(n[:, 0], n[:, 1]) + np.pi) / (2 * np.pi) * 20
    du = 1e-6 + 20 / np.pi * 3e-5 / np.sqrt(np.maximum(1 - n[:, 2] ** 2, 1e-30))
    dv = 1e-6 + 20 / (2 * np.pi) * 3e-5 / np.sqrt(np.maximum(n[:, 0] ** 2 + n[:, 1] ** 2,
                                                             1e-30))
    assert np.all((np.abs(u - np.round(u)) <= du) | (np.abs(v - np.round(v)) <= dv)), \
        ("bins", np.flatnonzero(differ))
    assert tg["bins"].dtype == np.int32
    np.testing.assert_array_equal(tg["centers_valid"], j_cvalid)
    np.testing.assert_allclose(tg["centers"], j_centers, rtol=1e-6, atol=1e-3)
    _within(tg["normal"][p], jg["normal"][p], 3e-5, "normal")
    _within(tg["d"][p], jg["d"][p], 1e-5 * np.abs(jg["d"][p]) + 1e-3, "d")
    _within(tg["distance_tol"], jg["distance_tol"], 1e-5 * jg["distance_tol"] + 1e-4, "tol")
    _within(tg["mean"], jg["mean"], 1e-6 * np.abs(jg["mean"]).max(initial=0) + 1e-3, "mean")
    diag = np.abs(np.diagonal(jg["m2"], axis1=-2, axis2=-1)).max(axis=-1)
    _within(tg["m2"], jg["m2"], 1e-5 * diag[:, None, None] + 1e-3, "m2")


def test_cells_reference_is_the_port_functions():
    """The plain version runs the port's ``fit_cells``, ``_edge_maps`` and
    ``_normal_bins`` on its ``depth_to_cloud``: the fields are theirs to the
    bit."""
    from rgbd_slam_tpu_torch.features import primitives
    from rgbd_slam_tpu_torch.ops.depth_cloud import depth_to_cloud

    depth, _, cam = _scene_depth("room")
    depth = torch.from_numpy(np.asarray(depth, np.float32))
    det = tcfg.DetectionConfig()
    got = cells_cuda.cells_reference(depth, cam, det)
    cloud, valid = depth_to_cloud(depth, cam)
    grid = primitives.fit_cells(cloud, valid, det)
    for name, want in grid._asdict().items():
        assert torch.equal(getattr(got, name), want), name
    assert torch.equal(got.edges, primitives._edge_maps(grid, 24, 32,
                                                        cells_cuda.merge_angle_cos(det)))
    assert torch.equal(got.bins, primitives._normal_bins(grid.normal))
    assert torch.equal(got.centers, cloud[10::20, 10::20])
    assert torch.equal(got.centers_valid, valid[10::20, 10::20])


def test_cells_work_at_640x480():
    """Hand counts at the main path's 640x480 with 20 px cells (768 cells):
    1,228,800 bytes of depth read and 102 bytes a cell written; 27 flops a
    pixel, 200 + 8 x 2 x 19 = 504 a cell and 2 x (640 + 480) for the rays."""
    work = cells_cuda.cells_work(480, 640, 20)
    assert work == {"cells": 768, "bytes": 1_228_800 + 78_336,
                    "flops": 8_294_400 + 387_072 + 2_240}
    assert work["flops"] == 8_683_712 and work["bytes"] == 1_307_136


class _CudaLooking(torch.Tensor):
    """A CPU tensor that says it lies on the card: the wrapper takes its CUDA
    path for it."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cells_wrapper_raises_and_never_falls_back(monkeypatch):
    """For a CUDA tensor the wrapper launches its kernels or raises: when the
    library does not build, the error reaches the caller and the plain
    version is never called; the main path's entry point raises the same."""
    from rgbd_slam_tpu_torch.features import primitives

    def refuse(*args, **kw):
        raise AssertionError("the plain version ran for a CUDA tensor")

    def no_nvcc(*args, **kw):
        raise RuntimeError("nvcc failed on cells.cu")

    monkeypatch.setattr(cells_cuda, "cells_reference", refuse)
    monkeypatch.setattr(cells_cuda.LIBRARY, "lib", None)
    monkeypatch.setattr(nvcc, "load_library", no_nvcc)
    depth = torch.full((480, 640), 2000.0).as_subclass(_CudaLooking)
    assert depth.device.type == "cuda"
    with pytest.raises(RuntimeError, match="nvcc failed on cells.cu"):
        cells_cuda.cell_pass(depth, tcfg.TUM_FR1, tcfg.DetectionConfig())
    with pytest.raises(RuntimeError, match="nvcc failed on cells.cu"):
        primitives.find_primitives(depth, tcfg.TUM_FR1, tcfg.DetectionConfig())
    # what the kernels do not take raises before any build
    with pytest.raises(ValueError, match="whole number"):
        cells_cuda.cell_pass(torch.zeros(470, 640).as_subclass(_CudaLooking), tcfg.TUM_FR1)
    with pytest.raises(ValueError, match="float32"):
        cells_cuda.cell_pass(torch.zeros(480, 640, dtype=torch.float64)
                             .as_subclass(_CudaLooking), tcfg.TUM_FR1)
    with pytest.raises(ValueError, match="unsupported device"):
        cells_cuda.cell_pass(torch.zeros(480, 640, device="meta"), tcfg.TUM_FR1)
