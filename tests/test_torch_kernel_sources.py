"""The CUDA sources of the port read as text, on the CPU: what ``chip_smoke.py``
and the wrappers say of the kernels must hold in ``rgbd_slam_tpu_torch/csrc``.

* Every kernel that ``chip_smoke.py`` names for a launch count (``FUSED_ONLY``
  with its ``LAUNCH_MARKS``, the start of the kernel's name that the profiler
  sees) is a ``__global__`` function of the source ``SOURCES`` gives for it.
* The shared memory of the plane extraction's kernels: the cylinder stage's
  dynamic part (``cylinders_cuda.smem_bytes``) beside its static arrays fits a
  Hopper CTA at the main path's 768 cells and 20 regions and at the largest
  grid the wrapper accepts, which refuses one cell more; the cell pass has
  only static arrays, which fit the 48 KB a CTA gets without an opt-in; the
  components kernel's bytes a cell are the wrapper's.
* ``chip_smoke.held_bits`` fails a kernel whose outputs moved on the first
  design's inputs, and compares nothing where the inputs moved.
* The text edits of ``tools/profile_plane_kernels.py`` (its ``clock64()``
  stamps, the cell pass without its edges launch, the design's variants) each
  find their text once in the tree's sources, so the tool runs on the tree.
* ``cells_work`` and ``cylinders_work`` at 640x480 give the counts the
  kernels' shares of their bound have been taken against: 1.307 MB and 8.68
  MFLOP for the cell pass; 82 kB and 2.74 MFLOP for the cylinder stage with
  one live region.
"""

import math
import os
import re

import pytest
import torch

import chip_smoke
from rgbd_slam_tpu_torch.ops import cells_cuda, components_cuda, cylinders_cuda, nvcc
from tools import profile_plane_kernels as plane_tool

#: a CTA's shared memory on Hopper, and what it gets without the opt-in
CTA_SMEM_BYTES = 232448
DEFAULT_SMEM_BYTES = 48 * 1024
_TYPE_BYTES = {"float": 4, "int": 4, "uint8_t": 1, "bool": 1}


def _source(name: str) -> str:
    with open(os.path.join(nvcc.CSRC, name)) as f:
        return f.read()


def _globals(text: str) -> set:
    """Names of the ``__global__`` functions of a CUDA source (attributes such
    as ``__launch_bounds__(...)`` between ``void`` and the name skipped)."""
    return set(re.findall(r"__global__\s+void\s+(?:__\w+__\s*\([^)]*\)\s*)*(\w+)\s*\(", text))


def _defines(text: str) -> dict:
    """The integer ``#define``s of a source, evaluated in order."""
    values = {}
    for name, expr in re.findall(r"^#define (\w+) (.+)$", text, flags=re.M):
        try:
            values[name] = int(eval(expr.split("//")[0], {}, dict(values)))
        except (NameError, SyntaxError, TypeError):
            continue
    return values


def _static_smem(text: str) -> int:
    """Bytes of a source's fixed-size ``__shared__`` arrays and scalars."""
    defs = _defines(text)
    total = 0
    for typ, dims in re.findall(r"__shared__ (?:__align__\(\d+\) )?(\w+) \w+((?:\[[^\]]+\])*);",
                                text):
        n = 1
        for dim in re.findall(r"\[([^\]]+)\]", dims):
            n *= int(eval(dim, {}, dict(defs)))
        total += _TYPE_BYTES[typ] * n
    return total


@pytest.mark.parametrize("count", sorted(chip_smoke.FUSED_ONLY))
def test_every_launch_mark_is_a_kernel_of_its_source(count):
    source = chip_smoke.SOURCES[count]
    assert source.startswith("rgbd_slam_tpu_torch/csrc/")
    kernels = _globals(_source(os.path.basename(source)))
    assert chip_smoke.LAUNCH_MARKS[count] in kernels, (count, sorted(kernels))


def test_the_sources_kernels_are_the_ones_chip_smoke_knows():
    """Each source's ``__global__`` functions, as the text reads: no mark is
    left of a kernel that went away, and none is missing."""
    assert _globals(_source("cells.cu")) == {"cells_fit_kernel", "cells_edges_kernel"}
    assert _globals(_source("cylinders.cu")) == {"cylinders_kernel", "cylinders_kernel_global"}
    assert _globals(_source("components.cu")) == {"components_kernel"}
    assert _globals(_source("lm.cu")) == {"lm_solve_kernel", "lm_solve_kernel_warp"}
    assert _globals(_source("line_grow.cu")) == {"line_grow_kernel"}
    assert _globals(_source("ransac_score.cu")) == {"ransac_score_kernel"}
    assert {"lk_fwd_bwd_kernel", "lk_pyramid_kernel", "lk_level_kernel"} \
        <= _globals(_source("lk.cu"))
    assert set(chip_smoke.LAUNCH_MARKS) == set(chip_smoke.FUSED_ONLY) \
        == set(chip_smoke.SOURCES) == set(nvcc.launch_counts())


def test_cylinder_limits_match_the_source():
    defs = _defines(_source("cylinders.cu"))
    assert defs["CYL_MAX_REGIONS"] == cylinders_cuda.MAX_REGIONS
    assert defs["CYL_MAX_HYP"] == cylinders_cuda.MAX_HYPOTHESES
    assert defs["CYL_MAX_SUBSEGMENTS"] == cylinders_cuda.MAX_SUBSEGMENTS
    assert defs["CYL_MAX_CELLS_GLOBAL"] == cylinders_cuda.MAX_CELLS
    # a warp a region in the gate: the cluster's warps cover the regions
    assert defs["CYL_CLUSTER"] * defs["CYL_WARPS"] >= defs["CYL_MAX_REGIONS"]


def test_cell_pass_limits_match_the_source():
    text = _source("cells.cu")
    defs = _defines(text)
    assert f"a.patch > {cells_cuda.MAX_PATCH}" in text
    # a lane's registers hold its share of the largest patch
    assert defs["CELLS_SLOTS"] == math.ceil(cells_cuda.MAX_PATCH ** 2 / 32)


@pytest.mark.parametrize("k", [20, cylinders_cuda.MAX_REGIONS])
def test_cylinder_shared_memory_fits_and_the_wrapper_refuses_more(k):
    static = _static_smem(_source("cylinders.cu"))
    assert 0 < static <= CTA_SMEM_BYTES - cylinders_cuda.MAX_SMEM_BYTES
    assert cylinders_cuda.smem_bytes(768, k) <= cylinders_cuda.MAX_SMEM_BYTES
    largest = max(c for c in range(1, 20_000)
                  if cylinders_cuda.smem_bytes(c, k) <= cylinders_cuda.MAX_SMEM_BYTES)
    assert largest >= 768 and largest < 20_000
    assert static + cylinders_cuda.smem_bytes(largest, k) <= CTA_SMEM_BYTES
    # the wrapper takes the largest grid on the shared-memory path, and one
    # cell more on the global-memory path
    cylinders_cuda.check_inputs(*_card_inputs(largest, k), 43, 3)
    assert cylinders_cuda.shared_path(largest, k)
    assert not cylinders_cuda.shared_path(largest + 1, k)
    cylinders_cuda.check_inputs(*_card_inputs(largest + 1, k), 43, 3)


def test_cylinder_shared_memory_at_the_main_path():
    """768 cells, 20 regions: normals and means 9,216 bytes each, two flags
    768 each, the compacted cells 3,072, 24 chunk masks 96, the candidate
    flags 32 (16-byte aligned) and the member rows' area 24,576 (the projected
    cells' two float4s a cell, more than 20 member bytes a cell)."""
    assert cylinders_cuda.smem_bytes(768, 20) == 2 * 9216 + 2 * 768 + 3072 + 96 + 32 + 24576


def test_components_shared_memory_matches_the_wrapper():
    """The source's bytes a cell are what ``check_grid`` charges, it has no
    static shared memory, and its dynamic part is sized by that budget."""
    text = _source("components.cu")
    assert _defines(text)["CC_SMEM_BYTES_PER_CELL"] == components_cuda.SMEM_BYTES_PER_CELL
    assert _static_smem(text) == 0
    assert "(size_t)gh * (size_t)gw * CC_SMEM_BYTES_PER_CELL" in text
    assert components_cuda.MAX_SMEM_BYTES == CTA_SMEM_BYTES


def test_cell_pass_static_shared_memory_needs_no_opt_in():
    assert 0 < _static_smem(_source("cells.cu")) <= DEFAULT_SMEM_BYTES


@pytest.mark.parametrize("source", ["cells.cu", "components.cu", "cylinders.cu"])
def test_the_split_stamps_apply_to_the_sources(source):
    text = _source(source)
    edits, phases = plane_tool.STAMPS[source]
    for old, _ in edits:
        assert text.count(old) == 1, old
    stamped = "".join(new for _, new in edits)
    # every phase is stamped, by its index in the names
    assert sorted({int(p) for p in re.findall(r"SPLIT(?:_COUNT)?\((\d+)\)", stamped)}) \
        == list(range(len(phases)))
    # a count's phase is counted, a time's phase is stamped
    for k, phase in enumerate(phases):
        assert (f"SPLIT_COUNT({k})" in stamped) == phase.endswith("_count"), phase
    assert len(phases) < 16   # a row of the device's table holds 15 phases and the count
    if source == "cells.cu":
        assert text.count(plane_tool._EDGES_LAUNCH) == 1


@pytest.mark.parametrize("name", sorted(plane_tool.VARIANTS))
def test_the_design_variants_apply_to_the_sources(name):
    source, edits = plane_tool.VARIANTS[name]
    for old, _ in edits:
        assert _source(source).count(old) == 1, old


@pytest.mark.parametrize("kind", sorted(chip_smoke.TIMED_FRAMES))
@pytest.mark.parametrize("kernel", ["cells", "cylinders"])
def test_held_bits_fail_only_where_the_inputs_stayed(kind, kernel):
    held = chip_smoke.HELD_BITS[kind]
    same_inputs, same_outputs = held[f"{kernel}_inputs"], held[kernel]
    assert chip_smoke.held_bits(kind, kernel, same_inputs, same_outputs) is True
    assert chip_smoke.held_bits(kind, kernel, "0" * 16, "0" * 16) is None
    with pytest.raises(RuntimeError, match="the bits moved"):
        chip_smoke.held_bits(kind, kernel, same_inputs, "0" * 16)


class _CudaLooking(torch.Tensor):
    """A CPU tensor that says it lies on the card, for ``check_inputs``."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _card_inputs(c: int, k: int):
    from rgbd_slam_tpu_torch.features.primitives import CellGrid

    def card(t):
        return t.as_subclass(_CudaLooking)

    z = torch.zeros(c)
    grid = CellGrid(count=z, mean=card(torch.zeros(c, 3)), m2=z, normal=card(torch.zeros(c, 3)),
                    d=z, mse=z, score=z, planar=card(torch.zeros(c, dtype=torch.bool)),
                    distance_tol=z)
    return (grid, card(torch.zeros(k, c, dtype=torch.bool)),
            card(torch.zeros(k, dtype=torch.bool)))


@pytest.mark.parametrize("what, got, want, digits", [
    ("cells MB", lambda: cells_cuda.cells_work(480, 640, 20)["bytes"] / 1e6, 1.307, 3),
    ("cells MFLOP", lambda: cells_cuda.cells_work(480, 640, 20)["flops"] / 1e6, 8.68, 2),
    ("cylinders kB, one live",
     lambda: cylinders_cuda.cylinders_work(768, 20, 43, 3, 1)["bytes"] / 1e3, 82.2, 1),
    ("cylinders MFLOP, one live",
     lambda: cylinders_cuda.cylinders_work(768, 20, 43, 3, 1)["flops"] / 1e6, 2.74, 2),
])
def test_work_counts_at_640x480(what, got, want, digits):
    assert round(got(), digits) == pytest.approx(want)
