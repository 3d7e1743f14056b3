"""The port's native-library loader (`shapeclipper_torch/eval3d/native.py`)
under concurrent first use: several processes call `available()` at once on
an empty build directory. Each must load the library, the compile must
happen under the lock, and no process may ever see a partial file under the
library's name.

Importing this module also repairs the JAX package's loader for the rest of
the process (`tests/torch_native_lib.py::repair_jax_loader`). That loader,
`shapeclipper_tpu/eval3d/native.py:28-46`, runs an unlocked `make -C native`
on a fresh tree, and under several pytest workers, each collecting
`tests/test_native.py` (whose `skipif` calls it), a worker can meet a
half-written `native/build/libscl_native.so` and keep the numpy fallbacks
for its life: the JAX side's meshes then differ from the port's
(`tests/test_device_isosurface.py`, `tests/test_torch_eval.py`). Every
worker imports every test file before any test runs, and this one sorts
after `tests/test_native.py`, so the repair is in place before the first
test; it cannot undo `tests/test_native.py`'s own `skipif`, which is fixed
when that file is collected.
"""

import os
import subprocess
import sys
import time

from shapeclipper_tpu.eval3d import native as jnative
from shapeclipper_torch.eval3d import native
from tests.torch_native_lib import repair_jax_loader

repair_jax_loader()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PROCS = 4

CHILD = """
import os, sys, time
from shapeclipper_torch.eval3d import native
native.BUILD_DIR = sys.argv[1]
while not os.path.exists(sys.argv[2]):      # start together
    time.sleep(0.005)
assert native.available(), "library did not load"
print(os.path.getsize(native.library_path()))
"""


def test_concurrent_first_use_loads_one_complete_library(tmp_path):
    build_dir = str(tmp_path / "native")
    go = str(tmp_path / "go")
    env = dict(os.environ)
    env.pop("SCL_NATIVE_LIB", None)
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, build_dir, go],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(N_PROCS)]
    final = native.library_path(build_dir)
    seen = set()
    time.sleep(1.0)                      # every child imported and waiting
    open(go, "w").close()
    while any(p.poll() is None for p in procs):
        if os.path.exists(final):        # whatever is visible is complete
            seen.add(os.path.getsize(final))
        time.sleep(0.001)
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    size = os.path.getsize(final)
    assert size > 0
    assert {int(out.split()[-1]) for out, _ in outs} == {size}
    assert seen <= {size}
    # one library, the lock file, and no temporary left behind
    assert sorted(os.listdir(build_dir)) == sorted(
        [".lock", os.path.basename(final)])


def test_jax_loader_is_native_on_the_port_source():
    """In this worker, after the repair at import, the JAX package's loader
    holds a native library built from `native/scl_native.cpp` as it stands:
    the port's (its name carries the source's hash), or the Makefile's when
    this worker's own `make` won, then no older than the source."""
    assert jnative.available(), "JAX loader fell back to numpy"
    path = os.path.realpath(jnative._LIB_PATH)
    if path != os.path.realpath(native.library_path()):
        assert path == os.path.realpath(os.path.join(
            REPO, "native", "build", "libscl_native.so")), path
        assert os.path.getmtime(path) >= os.path.getmtime(
            os.path.join(REPO, "native", "scl_native.cpp"))
