"""ctypes binding for the native C++ dataset loader (``native/png_loader.cpp``,
shared with the JAX package; port of ``rgbd_slam_tpu/io/native_loader.py``).

A prefetching RGB-D frame source: PNG decode, gray conversion and depth scaling
run in C++ worker threads ahead of the device pipeline.

The library is compiled from ``native/png_loader.cpp`` at first use into
``rgbd_slam_tpu_torch/_build/``, under a name that carries the hash of the
source and the flags, so an edited source is rebuilt.  Where there is no C++
compiler or no ``zlib.h``, a ``native/libpng_loader.so`` built beforehand (``make
-C native``) is loaded.  Where neither works, :func:`available` is False and
:class:`NativeFrameLoader` raises; callers then decode with PIL
(:mod:`rgbd_slam_tpu_torch.io.datasets`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_NATIVE_DIR = os.path.abspath(os.path.join(_HERE, "..", "..", "native"))
_SOURCE = os.path.join(_NATIVE_DIR, "png_loader.cpp")
_PREBUILT = os.path.join(_NATIVE_DIR, "libpng_loader.so")
_BUILD_DIR = os.path.abspath(os.path.join(_HERE, "..", "_build"))
_CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-shared"]
_CXX_LIBS = ["-lz", "-lpthread"]

_lib = None
#: how the loaded library was found: "built", "prebuilt" or, before the first
#: use and when nothing loads, None
LIBRARY_ORIGIN = None


def _build() -> str | None:
    """Compile the loader into the build directory if it is not there yet.
    Returns the library's path, or None without a compiler, the source or
    ``zlib.h`` (whatever made the compile fail)."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None or not os.path.exists(_SOURCE):
        return None
    digest = hashlib.sha256(" ".join([*_CXX_FLAGS, *_CXX_LIBS]).encode())
    with open(_SOURCE, "rb") as f:
        digest.update(f.read())
    so_path = os.path.join(_BUILD_DIR, f"libpng_loader_{digest.hexdigest()[:16]}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *_CXX_FLAGS, "-o", tmp, _SOURCE, *_CXX_LIBS],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        return None
    os.replace(tmp, so_path)
    return so_path


def _bind(path: str):
    lib = ctypes.CDLL(path)
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_float]
    lib.loader_get.restype = ctypes.c_int
    lib.loader_get.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int]
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    lib.decode_png_file.restype = ctypes.c_int
    lib.decode_png_file.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float]
    return lib


def _load_lib():
    global _lib, LIBRARY_ORIGIN
    if _lib is not None:
        return _lib
    for origin, path in (("built", _build()), ("prebuilt", _PREBUILT)):
        if path is None or not os.path.exists(path):
            continue
        try:
            _lib = _bind(path)
        except OSError:     # a library made for another machine
            continue
        LIBRARY_ORIGIN = origin
        return _lib
    return None


def available() -> bool:
    return _load_lib() is not None


def decode_png(path: str, height: int, width: int, to_gray: bool = True,
               scale: float = 1.0) -> np.ndarray | None:
    """Single-image decode through the native library; None on failure."""
    lib = _load_lib()
    if lib is None:
        return None
    out = np.empty((height, width), dtype=np.float32)
    ok = lib.decode_png_file(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        height, width, int(to_gray), ctypes.c_float(scale))
    return out if ok else None


class NativeFrameLoader:
    """Prefetching loader over (rgb_path, depth_path) pairs.

    Iterate with ``get(i) -> (gray, depth_mm)``; frames i+1..i+8 are decoded in
    background C++ threads while the device consumes frame i."""

    def __init__(self, rgb_paths, depth_paths, height: int, width: int,
                 depth_scale: float = 0.2, workers: int = 3):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native loader library not available: no C++ compiler with "
                               "zlib.h to build native/png_loader.cpp, and no prebuilt "
                               "native/libpng_loader.so (run make in native/)")
        self._lib = lib
        self._h, self._w = height, width
        n = len(rgb_paths)
        self._n = n
        rgb_arr = (ctypes.c_char_p * n)(*[p.encode() for p in rgb_paths])
        depth_arr = (ctypes.c_char_p * n)(*[p.encode() for p in depth_paths])
        self._handle = lib.loader_create(rgb_arr, depth_arr, n, workers,
                                         ctypes.c_float(depth_scale))

    def __len__(self):
        return self._n

    def get(self, idx: int):
        gray = np.empty((self._h, self._w), dtype=np.float32)
        depth = np.empty((self._h, self._w), dtype=np.float32)
        ok = self._lib.loader_get(
            self._handle, idx,
            gray.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._h, self._w)
        if not ok:
            raise IOError(f"native loader failed on frame {idx}")
        return gray, depth

    def __iter__(self):
        for i in range(self._n):
            yield self.get(i)

    def close(self):
        if self._handle:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
