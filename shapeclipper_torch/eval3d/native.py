"""ctypes bindings for the native host kernels (native/scl_native.cpp).

Build: `make -C native` (attempted automatically once per process). Every
entry point has a pure-numpy fallback, so the framework works without a
toolchain; the native path accelerates the host side of evaluation
(isosurface extraction, mask distance transforms).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", ".."))
# installed (non-repo) layouts can point at a prebuilt library explicitly
_LIB_PATH = os.environ.get(
    "SCL_NATIVE_LIB",
    os.path.join(_REPO_ROOT, "native", "build", "libscl_native.so"))

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH):
        if os.environ.get("SCL_NO_NATIVE"):
            return None
        try:
            subprocess.run(["make", "-C", os.path.join(_REPO_ROOT, "native")],
                           check=True, capture_output=True, timeout=120)
        except Exception:
            return None
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
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
