"""The wrapper of the Hopper kernels K6 and K7 (`csrc/isosurface.cu`):
marching tetrahedra to per-cell triangle areas, and area-weighted surface
sampling. Their plain PyTorch versions, and the functions that choose
between the two by the tensors' device, are in
`eval3d/device_isosurface.py`; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from .cuda_lib import BUILD_DIR, CSRC_DIR, CudaLibrary

_SOURCE = os.path.join(CSRC_DIR, "isosurface.cu")


def _check(name, x, dtype, dims, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, the level grid on "
                         f"{device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dim() != dims:
        raise ValueError(f"{name} must have {dims} dimensions, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


class IsosurfaceKernel(CudaLibrary):
    """The isosurface library (K6 `cell_area_kernel`, K7 `draw_kernel`).
    `launches` counts the launches of each ('area' = K6, 'draw' = K7); it is
    incremented where the kernel is launched and nowhere else."""

    stem = "scl_isosurface"
    source = _SOURCE

    def __init__(self, build_dir=BUILD_DIR):
        super().__init__(build_dir)
        self.launches = {"area": 0, "draw": 0}
        self._tables_on = set()

    def _bind(self, lib):
        lib.scl_iso_tables.argtypes = [ctypes.c_void_p] * 4
        lib.scl_iso_tables.restype = ctypes.c_int
        lib.scl_iso_cell_areas.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p]
        lib.scl_iso_cell_areas.restype = ctypes.c_int
        lib.scl_iso_draw.argtypes = [ctypes.c_void_p] * 7 + [
            ctypes.c_int] * 3 + [ctypes.c_float] * 3 + [ctypes.c_void_p]
        lib.scl_iso_draw.restype = ctypes.c_int

    def _ready(self, device):
        """Build, and write the case tables into the device's constant
        memory once."""
        lib = self.build()
        if device.index not in self._tables_on:
            from ..eval3d import device_isosurface as D
            tables = [np.ascontiguousarray(a, dtype=np.int32) for a in (
                D._TETS, D._EDGE_A, D._EDGE_B, D._VALID)]
            err = lib.scl_iso_tables(*(a.ctypes.data for a in tables))
            if err != 0:
                raise RuntimeError(f"isosurface tables: cudaError {err}")
            self._tables_on.add(device.index)
        return lib

    @staticmethod
    def _check_level(level):
        if level.device.type != "cuda":
            raise ValueError(f"no isosurface kernel for device {level.device}")
        _check("level", level, torch.float32, 4, level.device)
        M = level.shape[1]
        if level.shape[1:] != (M, M, M) or M < 2:
            raise ValueError(f"level must be [B, M, M, M] with M >= 2, got "
                             f"{tuple(level.shape)}")
        return level.shape[0], M

    def cell_areas(self, level, isovalue=0.0):
        """K6: level [B, M, M, M] float32 -> [B, (M-1)^3] float64, each
        cell's 12 slot areas summed."""
        B, M = self._check_level(level)
        dev = level.device
        with torch.cuda.device(dev):
            lib = self._ready(dev)
            sums = torch.empty(B, (M - 1) ** 3, device=dev,
                               dtype=torch.float64)
            err = lib.scl_iso_cell_areas(
                level.data_ptr(), sums.data_ptr(), B, M, float(isovalue),
                torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"isosurface area kernel launch failed: "
                               f"cudaError {err}")
        self.launches["area"] += 1
        return sums

    def draw(self, level, cdf, r, u, w, range_min, range_max, isovalue=0.0,
             with_faces=False):
        """K7: level [B, M, M, M] float32, cdf [B, (M-1)^3] float64, draws
        r [B, n], u / w [B, n, 1] float32 -> points [B, n, 3] float32, and
        with `with_faces` (points, faces [B, n] int64); without, the kernel
        stores no face."""
        B, M = self._check_level(level)
        dev = level.device
        n = r.shape[-1]
        _check("cdf", cdf, torch.float64, 2, dev)
        if cdf.shape != (B, (M - 1) ** 3):
            raise ValueError(f"cdf must be [{B}, {(M - 1) ** 3}], got "
                             f"{tuple(cdf.shape)}")
        for name, x, dims in (("r", r, 2), ("u", u, 3), ("w", w, 3)):
            _check(name, x, torch.float32, dims, dev)
            if x.shape[:2] != (B, n) or x.numel() != B * n:
                raise ValueError(f"{name} must be [{B}, {n}"
                                 f"{', 1' if dims == 3 else ''}], got "
                                 f"{tuple(x.shape)}")
        with torch.cuda.device(dev):
            lib = self._ready(dev)
            pts = torch.empty(B, n, 3, device=dev, dtype=torch.float32)
            face = (torch.empty(B, n, device=dev, dtype=torch.int64)
                    if with_faces else None)
            err = lib.scl_iso_draw(
                level.data_ptr(), cdf.data_ptr(), r.data_ptr(), u.data_ptr(),
                w.data_ptr(), pts.data_ptr(),
                face.data_ptr() if with_faces else None, B, M, n,
                float(isovalue), float(range_max - range_min),
                float(range_min), torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"isosurface draw kernel launch failed: "
                               f"cudaError {err}")
        self.launches["draw"] += 1
        return (pts, face) if with_faces else pts


KERNEL = IsosurfaceKernel()
