"""ctypes bindings for the native host kernels (native/scl_native.cpp).

The port builds its own copy of the library with `g++`, once per content
hash of the source, into `build/native/` at the repository root
(gitignored), at first use. The build holds an exclusive `fcntl` lock on
`build/native/.lock`, writes to a temporary name and renames it into
place, so a process that loads the library (each pytest worker, say) finds
it either complete or absent, never half written. Every entry point has a
pure-numpy fallback, so the framework works without a toolchain; a library
that was built but does not load is logged, not passed over silently.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile

import numpy as np

from ..utils.log import log

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", ".."))
_SOURCE = os.path.join(_REPO_ROOT, "native", "scl_native.cpp")
BUILD_DIR = os.path.join(_REPO_ROOT, "build", "native")
_CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-shared"]

_lib = None
_tried = False


def library_path(build_dir=None):
    """The library built from the current source (named by its hash)."""
    build_dir = build_dir or BUILD_DIR
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(build_dir, f"libscl_native_{digest}.so")


def build():
    """Compile the library into BUILD_DIR unless it is there; -> its path,
    or None when the compiler is missing or fails. Safe across processes:
    the compile runs under an exclusive lock and the file appears by one
    rename."""
    path = library_path()
    if os.path.isfile(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.isfile(path):            # another process built it
                return path
            fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run([os.environ.get("CXX", "g++"), *_CXXFLAGS,
                                "-o", tmp, _SOURCE], check=True,
                               capture_output=True, timeout=300)
                os.replace(tmp, path)
            except (OSError, subprocess.SubprocessError) as e:
                log.warn(f"native library not built ({e}); the numpy "
                         "fallbacks run instead")
                return None
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return path


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    # installed (non-repo) layouts can point at a prebuilt library explicitly
    path = os.environ.get("SCL_NATIVE_LIB") or build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        log.warn(f"native library {path} did not load ({e}); the numpy "
                 "fallbacks run instead")
        return None
    lib.marching_tetrahedra.restype = ctypes.c_int
    lib.marching_tetrahedra.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_longlong)]
    lib.boundary_distance.restype = ctypes.c_int
    lib.boundary_distance.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float)]
    lib.scl_free.restype = None
    lib.scl_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available():
    return _load() is not None


def marching_tetrahedra(level, isovalue=0.0):
    """Native triangle-soup extraction; returns (vertices [V,3] float32) or
    None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    level = np.ascontiguousarray(level, dtype=np.float32)
    N = level.shape[0]
    out_ptr = ctypes.POINTER(ctypes.c_float)()
    out_n = ctypes.c_longlong(0)
    rc = lib.marching_tetrahedra(
        level.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), N,
        ctypes.c_float(isovalue), ctypes.byref(out_ptr), ctypes.byref(out_n))
    if rc != 0:
        return None
    n = out_n.value
    if n == 0:
        lib.scl_free(out_ptr)
        return np.zeros((0, 3), np.float32)
    verts = np.ctypeslib.as_array(out_ptr, shape=(n, 3)).copy()
    lib.scl_free(out_ptr)
    return verts


def boundary_distance(mask_binary):
    """Native exact EDT to the mask boundary; None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    mask = np.ascontiguousarray(
        np.asarray(mask_binary, dtype=bool), dtype=np.uint8)
    H, W = mask.shape
    out = np.empty((H, W), np.float32)
    rc = lib.boundary_distance(
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), H, W,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        return None
    return out
