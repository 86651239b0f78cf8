"""The kernels' build: ``nvcc`` on first use, from a CUDA source of this
package into a shared library with a plain C interface under
``rgbd_slam_tpu_torch/_build/``, loaded with ctypes.

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

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "..", "csrc")
BUILD_DIR = os.path.join(_HERE, "..", "_build")
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
