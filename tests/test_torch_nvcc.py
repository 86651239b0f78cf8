"""The kernel libraries' registry (``ops/nvcc.py``), on the CPU.

* Every CUDA source of the package is loaded by exactly one registered
  library, and no two libraries count a kernel under the same name.
* ``Library.build`` builds once, and a build with more flags (the LK
  kernels' phase profile) takes the loaded one's place and stays.
* The launch bookkeeping of a CUDA graph's capture (``step_graph.capture``
  over ``nvcc.take_back``): the counts a capture added are taken back and
  returned, and ``nvcc.add_launches`` adds them again at each replay; here the
  capture is a plain call, since the CPU has no CUDA graph.
"""

import contextlib
import importlib
import os
import pkgutil

import pytest
import torch

import rgbd_slam_tpu_torch
from rgbd_slam_tpu_torch import step_graph
from rgbd_slam_tpu_torch.ops import line_grow_cuda, lk_cuda, nvcc

SOURCES = sorted(name for name in os.listdir(nvcc.CSRC) if name.endswith(".cu"))


def _import_the_package():
    for info in pkgutil.walk_packages(rgbd_slam_tpu_torch.__path__, "rgbd_slam_tpu_torch."):
        importlib.import_module(info.name)


@pytest.mark.parametrize("source", SOURCES)
def test_every_cuda_source_is_loaded_by_exactly_one_registered_library(source):
    _import_the_package()
    assert [library.source for library in nvcc.LIBRARIES].count(source) == 1


def test_every_registered_library_has_its_source_and_counts_its_own_kernels():
    _import_the_package()
    assert sorted(library.source for library in nvcc.LIBRARIES) == SOURCES
    names = [name for library in nvcc.LIBRARIES for name in library.launches]
    assert len(names) == len(set(names)) == len(nvcc.launch_counts())
    assert lk_cuda.LAUNCHES is lk_cuda.LIBRARY.launches


def test_a_build_with_more_flags_takes_the_loaded_ones_place_and_stays(monkeypatch):
    built = []

    def load_library(source, stem, flags):
        built.append((source, stem, tuple(flags)))
        return object(), f"log {len(built)}"

    monkeypatch.setattr(nvcc, "load_library", load_library)
    monkeypatch.setattr(nvcc, "LIBRARIES", [])
    bound = []
    library = nvcc.Library("fake.cu", bound.append, launches=("fake",),
                           extra_flags=("-fmad=false",))
    assert nvcc.LIBRARIES == [library] and library.stem == "fake"
    assert library.build() >= 0.0 and library.build() == 0.0
    assert built == [("fake.cu", "fake", ("-fmad=false",))] and bound == [library.lib]
    library.build(("-DPROFILE",))
    assert built[-1] == ("fake.cu", "fake", ("-fmad=false", "-DPROFILE"))
    assert library.flags == ("-DPROFILE",) and library.log == "log 2"
    assert library.build() == 0.0 and library.build(("-DPROFILE",)) == 0.0
    assert len(built) == 2 and len(bound) == 2


def test_a_capture_takes_back_the_launches_it_counted(monkeypatch):
    """What a fake capture launched is returned and taken off the counts; each
    replay adds it again, and the other kernels' counts never move."""
    _import_the_package()
    for name, n in nvcc.launch_counts().items():
        for library in nvcc.LIBRARIES:
            if name in library.launches:
                monkeypatch.setitem(library.launches, name, n)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph: contextlib.nullcontext())
    lk_cuda.LAUNCHES["lk_fwd_bwd"] += 4   # launched before the capture
    before = nvcc.launch_counts()

    def launches():
        lk_cuda.LAUNCHES["lk_fwd_bwd"] += 1
        line_grow_cuda.LAUNCHES["line_grow"] += 2
        return "outputs"

    out, added = step_graph.capture(None, launches)
    assert out == "outputs" and nvcc.launch_counts() == before
    for replays in (1, 2):
        nvcc.add_launches(added)
        after = nvcc.launch_counts()
        assert after["lk_fwd_bwd"] == before["lk_fwd_bwd"] + replays
        assert after["line_grow"] == before["line_grow"] + 2 * replays
        assert {k: v for k, v in after.items() if k not in ("lk_fwd_bwd", "line_grow")} \
            == {k: v for k, v in before.items() if k not in ("lk_fwd_bwd", "line_grow")}
    nvcc.reset_launches()
    assert set(nvcc.launch_counts().values()) == {0}
