"""The reference against the program's CPU path at a tiny size, the
program in float32 (both `tpu.*_dtype` keys), so that the two compute the
same mathematics: one training step (loss, each leaf's gradient and
change) and a request (latents, pose, eval render, grid, mesh, turntable
views)."""

import time

import pytest

from benchmark.harness import infer, train
from conftest import FLOAT32, tiny_cell


def test_train_step_matches():
    cell = tiny_cell("volsdf-8x256.train-b12", FLOAT32)
    cell.traffic = dict(cell.traffic, compare_steps=1, warmup_steps=0)
    n = train.run(cell, 2 ** 31 + 101, 0.01, False, "cpu", time.time())
    numbers = n["numbers"]
    # float32 against float32: the program's one-pass BatchNorm variance
    # and the renderer's summation order, nothing more
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 5e-3
    assert numbers["grad_diff_median"] < 1e-3
    assert numbers["change_gap"] < 5e-3


@pytest.mark.parametrize("name", ["volsdf-8x256.infer-50view"])
def test_request_matches(name):
    cell = tiny_cell(name, FLOAT32)
    n = infer.run(cell, 2 ** 31 + 103, 0.01, False, "cpu", time.time())
    numbers = n["numbers"]
    assert numbers["latent_gap"] < 1e-4
    assert numbers["render_gap"] < 1e-4
    assert numbers["grid_gap"] < 1e-4
    assert numbers["mesh_stage_faces_gap"] == 0
    assert numbers["mesh_stage_gap"] < 1e-5
    assert numbers["mesh_gap"] < 1e-4
    assert numbers["view_gap"] < 1e-4
