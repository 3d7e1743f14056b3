"""One complete native library (`native/scl_native.cpp`) for both packages
in a test process.

The JAX package's loader (`shapeclipper_tpu/eval3d/native.py:28-46`) runs an
unlocked `make -C native` when `native/build/libscl_native.so` is absent, as
on a fresh tree, and the Makefile links that file in place. Under several
pytest workers each one runs it while collecting `tests/test_native.py`
(whose `skipif` calls the loader); a worker that meets a half-written file
keeps `_lib = None` for its life and takes the numpy fallbacks, which order
the triangles of marching tetrahedra differently. The port's loader
(`shapeclipper_torch/eval3d/native.py`) builds the same source under a lock
and renames the library into place, so its file is complete or absent.
These helpers point the JAX loader at that file. They write nothing under
`native/`.
"""

import pytest

from shapeclipper_tpu.eval3d import native as jnative
from shapeclipper_torch.eval3d import native as tnative


def point_jax_loader_at_port_library(mp):
    """Through the MonkeyPatch `mp`: both loaders reset and the JAX one
    pointed at the port's library; then both must load it, so that a
    fallback fails here ("JAX loader fell back to numpy") and not later as a
    mismatch between the packages."""
    path = tnative.build()
    assert path is not None, "g++ could not build native/scl_native.cpp"
    mp.setattr(tnative, "_lib", None)
    mp.setattr(tnative, "_tried", False)
    mp.setattr(jnative, "_LIB_PATH", path)
    mp.setattr(jnative, "_lib", None)
    mp.setattr(jnative, "_tried", False)
    assert tnative.available(), "the port's loader fell back to numpy"
    assert jnative.available(), "JAX loader fell back to numpy"
    return path


@pytest.fixture
def one_native_library(monkeypatch):
    """Both packages on the same, complete native library: the port's
    locked build, which the JAX module's loader is pointed at, so the
    comparison never depends on which process built first."""
    return point_jax_loader_at_port_library(monkeypatch)


def repair_jax_loader():
    """For the rest of this process: a JAX loader that holds no library (it
    lost the build race, or has not loaded yet) is pointed at the port's
    complete one, so that it neither falls back to numpy nor runs `make`
    again. A loader that did load its own library keeps it."""
    path = tnative.build()
    if path is not None and jnative._lib is None:
        jnative._LIB_PATH = path
        jnative._tried = False
