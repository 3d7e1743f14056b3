"""The command without a card, the check for JAX, and what the benchmark
and its reference import."""

import ast
import json
import os
import shutil
import subprocess
import sys

from benchmark.harness import spec

REPO = spec.REPO
RUN = os.path.join(REPO, "benchmark", "run.py")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "shapeclipper_tpu"}


def _run(cwd, script):
    return subprocess.run(
        [sys.executable, script, "--workload", "volsdf-8x256.infer-50view",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_fails_without_a_card():
    proc = _run(REPO, RUN)
    assert proc.returncode != 0
    assert not proc.stdout.strip()
    assert "CUDA" in proc.stderr


def test_fails_with_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path, str(tmp_path / "benchmark" / "run.py"))
    assert proc.returncode != 0 and not proc.stdout.strip()


def test_forbidden_modules_by_top_level_name(monkeypatch):
    sys.path.insert(0, os.path.dirname(RUN))
    try:
        import run
    finally:
        sys.path.pop(0)
    monkeypatch.setitem(sys.modules, "jaxtyping_like_name", object())
    monkeypatch.setitem(sys.modules, "shapeclipper_torch_extra", object())
    assert not set(run.forbidden_modules()) & {"jaxtyping_like_name"}
    monkeypatch.setitem(sys.modules, "flax.linen", object())
    assert "flax" in run.forbidden_modules()


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = _loaded(
        "import json, sys, glob, os\n"
        "from benchmark.harness import main, train, infer, trace, readers\n"
        "from benchmark.harness import spec\n"
        "for f in glob.glob('benchmark/metrics/*.py'):\n"
        "    spec.reader(os.path.basename(f)[:-3])\n"
        "import shapeclipper_torch.train.trainer, shapeclipper_torch.eval3d."
        "isosurface\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not names & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    names = _loaded(
        "import json, sys\n"
        "from benchmark.reference import model, step, mesh\n"
        "from benchmark import work\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not names & (FORBIDDEN | {"shapeclipper_torch"})
    for f in ("model.py", "step.py", "mesh.py", "__init__.py"):
        tree = ast.parse(open(os.path.join(REPO, "benchmark", "reference",
                                           f)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level == 0:
                assert node.module.split(".")[0] not in (
                    FORBIDDEN | {"shapeclipper_torch"})
            if isinstance(node, ast.Import):
                for a in node.names:
                    assert a.name.split(".")[0] not in (
                        FORBIDDEN | {"shapeclipper_torch"})
