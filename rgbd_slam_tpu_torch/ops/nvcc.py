"""The kernels' build: ``nvcc`` on first use, from a CUDA source of this
package into a shared library with a plain C interface under
``rgbd_slam_tpu_torch/_build/``, loaded with ctypes.

Each kernel wrapper makes one :class:`Library` of its source when it is
imported, and every library registers in :data:`LIBRARIES`: the helpers below
count, reset and take back the launches of every kernel through it, so that
no other module lists the kernels.

The library's name carries the hash of its source, of the headers beside it
(``csrc/*.cuh``) and of its flags, so an edited source or header is rebuilt and an unchanged one is loaded as it is.  What ``nvcc``
printed (``-Xptxas -v``: each kernel's registers, shared memory and spills) is
kept in a file beside the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "..", "csrc")
BUILD_DIR = os.path.join(_HERE, "..", "_build")
#: every kernel library made so far, in the order their wrappers were imported
LIBRARIES: list[Library] = []
#: Hopper with its architecture-specific features (``sm_90a``)
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def load_library(source: str, stem: str, extra_flags=()):
    """Compile ``csrc/<source>`` (unless a library of the same hash is there)
    and load it.  Returns (the ``ctypes.CDLL``, what nvcc printed)."""
    flags = [*FLAGS, *extra_flags]
    path = os.path.join(CSRC, source)
    digest = hashlib.sha256(" ".join(flags).encode())
    # the source and every header beside it, which a source may include
    headers = sorted(n for n in os.listdir(CSRC) if n.endswith(".cuh"))
    for name in [source, *headers]:
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")
    log_path = so_path + ".log"
    if not os.path.exists(so_path):
        tmp = f"{so_path}.{os.getpid()}.tmp"
        proc = subprocess.run([nvcc(), *flags, "-o", tmp, path], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} ({proc.returncode}):\n{proc.stderr}")
        with open(log_path, "w") as f:
            f.write(proc.stderr)
        os.replace(tmp, so_path)
    with open(log_path) as f:
        log = f.read()
    return ctypes.CDLL(so_path), log


class Library:
    """``csrc/<source>`` as a ctypes library, built on first use, and the
    launch counts of its kernels.  ``bind(lib)`` declares the argument and
    result types of the library's functions; ``launches`` names the kernels
    whose launches the wrapper counts (into :attr:`launches`); ``extra_flags``
    go to every build, beside ``FLAGS``.  Made once by its wrapper, at import,
    and registered in :data:`LIBRARIES`."""

    def __init__(self, source: str, bind, launches=(), extra_flags=()):
        self.source = source
        self.stem = os.path.splitext(source)[0]
        self.extra_flags = tuple(extra_flags)
        self._bind = bind
        #: the loaded ``ctypes.CDLL`` (None until :meth:`build`), the flags its
        #: build took beside ``FLAGS`` and ``extra_flags``, and what nvcc
        #: printed for it (``-Xptxas -v``: each kernel's registers, shared
        #: memory and spills)
        self.lib = None
        self.flags = ()
        self.log = ""
        #: launches of each kernel since import (or since :func:`reset_launches`)
        self.launches = dict.fromkeys(launches, 0)
        LIBRARIES.append(self)

    def build(self, extra_flags=()) -> float:
        """Compile and load the library (:func:`load_library`) unless one built
        with every flag of ``extra_flags`` is loaded: a build with more flags
        takes the loaded one's place and then stays.  Returns the seconds
        spent (0.0 when already loaded)."""
        if self.lib is not None and set(extra_flags) <= set(self.flags):
            return 0.0
        t0 = time.perf_counter()
        lib, log = load_library(self.source, self.stem, (*self.extra_flags, *extra_flags))
        self._bind(lib)
        self.lib, self.flags, self.log = lib, tuple(extra_flags), log
        return time.perf_counter() - t0


def launch_counts() -> dict:
    """{kernel: launches} over every library."""
    return {name: n for library in LIBRARIES for name, n in library.launches.items()}


def reset_launches():
    """Every kernel's launch count back to 0."""
    for library in LIBRARIES:
        for name in library.launches:
            library.launches[name] = 0


def take_back(fn):
    """``fn()``, with the launches it counted taken back off every library's
    counts: what a CUDA graph's capture needs, since a wrapper counts its
    launches when Python calls it and a replay calls none.  Returns (``fn``'s
    result, the launches taken back, for :func:`add_launches`)."""
    before = [(library, dict(library.launches)) for library in LIBRARIES]
    out = fn()
    added = [(library, {name: library.launches[name] - n for name, n in counts.items()})
             for library, counts in before]
    for library, counts in before:
        library.launches.update(counts)
    return out, added


def add_launches(added):
    """Add launches that :func:`take_back` took back: one replay's."""
    for library, counts in added:
        for name, n in counts.items():
            library.launches[name] += n
