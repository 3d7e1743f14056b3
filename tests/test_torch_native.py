"""The port's native-library loader (`shapeclipper_torch/eval3d/native.py`)
under concurrent first use: several processes call `available()` at once on
an empty build directory. Each must load the library, the compile must
happen under the lock, and no process may ever see a partial file under the
library's name."""

import os
import subprocess
import sys
import time

from shapeclipper_torch.eval3d import native

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
