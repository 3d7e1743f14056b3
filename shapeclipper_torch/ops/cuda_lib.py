"""How the port's CUDA libraries are built: the `.cu` sources of a
library under `csrc/` compiled by one `nvcc` run for sm_90a into a shared
library with a plain C interface, in `build/` at the repository root
(gitignored), once per content hash, and loaded with ctypes. Nothing is
built at import; a library builds at its first launch, or all of them at
once through `build_kernels`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

from ..utils.log import log
from ..utils.trace import timed

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build")


def _find_nvcc():
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


class CudaLibrary:
    """A library's `.cu` sources built with nvcc (sm_90a, plain C interface)
    into `build/`, once per content hash, and loaded with ctypes. A subclass
    names `stem` and `source` (and any `extra_sources` linked into the same
    library, and the `headers` they include, which enter its content hash)
    and binds its C functions in `_bind`."""

    stem = None
    source = None
    extra_sources = ()
    headers = ()

    def __init__(self, build_dir=BUILD_DIR):
        self.build_dir = build_dir
        self.lib = None
        self.ptxas_log = None

    def sources(self):
        return (self.source, *self.extra_sources)

    def library_path(self):
        h = hashlib.sha1()
        for src in (*self.sources(), *self.headers):
            with open(src, "rb") as f:
                h.update(f.read())
        digest = h.hexdigest()[:12]
        return os.path.join(self.build_dir, f"lib{self.stem}_{digest}.so")

    def build(self, force=False):
        """Compile the source (once per content hash, or again when `force`)
        and load it, inside `timed("setup.kernels.<stem>")`; a compile logs
        one line (the library, nvcc's seconds), and `ptxas_log` holds nvcc's
        register report of a compile in this process."""
        if self.lib is not None:
            return self.lib
        with timed("setup.kernels." + self.stem):
            path = self.library_path()
            if force or not os.path.isfile(path):
                self._compile(path)
            lib = ctypes.CDLL(path)
            self._bind(lib)
        self.lib = lib
        return lib

    def _compile(self, path):
        t0 = time.perf_counter()
        os.makedirs(self.build_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=self.build_dir)
        os.close(fd)
        cmd = [_find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
               "-Xcompiler", "-fPIC", "-o", tmp, *self.sources()]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {self.sources()} "
                               f"({proc.returncode}):\n{proc.stdout}\n"
                               f"{proc.stderr}")
        self.ptxas_log = proc.stderr
        os.replace(tmp, path)
        log.info(f"nvcc built {os.path.basename(path)} in "
                 f"{time.perf_counter() - t0:.1f} s")

    def _bind(self, lib):
        raise NotImplementedError


def libraries():
    """Every CUDA library of the port, in build order."""
    from . import chamfer, fused_sdf, isosurface
    return (fused_sdf.KERNEL, fused_sdf.BACKWARD, fused_sdf.GENERIC,
            chamfer.KERNEL, isosurface.KERNEL)


def build_kernels(force=False):
    """Build every library, one thread (and so one nvcc run) each, all
    started together; `force` compiles even a library `build/` holds."""
    libs = libraries()
    with ThreadPoolExecutor(max_workers=len(libs)) as pool:
        for done in [pool.submit(lib.build, force) for lib in libs]:
            done.result()
