"""Helpers of the benchmark's CPU tests: a cell cut to a size that a CPU
test holds (the shapes only; the harness, the program's CPU path and the
reference run as in a real run)."""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY = ["--batch_size=4", "--image_size=[64,64]", "--render.rand_sample=16",
        "--render.n_samples_uniform=8", "--eval.vox_res=8",
        "--eval.image_size=[8,8]"]
FLOAT32 = ["--tpu.encoder_dtype=float32", "--tpu.implicit_dtype=float32"]


# the training cell, kept as data and code beside the benchmark's cells
# (PERF.md says why it is not one of them), so that its loop is tested
TRAIN_CELL = {"name": "volsdf-8x256.train-b12", "config": "volsdf-8x256",
              "traffic": "train-b12", "chips": 1}


def bench():
    import json
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        b = json.load(f)
    b["workloads"].append(TRAIN_CELL)
    return b


def tiny_cell(name, extra=()):
    from benchmark.harness import spec
    return shrink(spec.Cell(name, bench()), extra)


def shrink(cell, extra=()):
    from benchmark.harness import spec
    cell.cfg = spec.apply_overrides(cell.cfg, TINY + list(extra))
    cell.traffic = dict(cell.traffic, pool_batches=3, profile_steps=1,
                        views=3, pool_images=2, warmup_requests=1,
                        compare_requests=2, compare_views=2,
                        profile_requests=1)
    return cell
