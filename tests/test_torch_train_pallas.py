"""The port's training step, forward and render against the JAX package's
with `tpu.sdf_grad_mode = 'pallas'`: the JAX side runs its fused SDF
forward / backward Pallas pair (`fused_sdf_train`) in interpret mode. Set-up
and tolerances are those of tests/test_torch_train.py, whose helpers this
file uses; the two modes live in two files so that each stays near a
minute on one worker.
"""

import pytest

from tests.test_torch_train import (check_forward, check_render, check_step,
                                    jax_run)


@pytest.fixture(scope="module")
def run_pallas(base_opt, tmp_path_factory):
    return jax_run(base_opt, tmp_path_factory.mktemp("pallas"), "pallas")


@pytest.mark.parametrize("camera", [False, True], ids=["full", "camera"])
def test_train_step_matches_jax_pallas(run_pallas, camera):
    check_step(run_pallas, camera)


@pytest.mark.parametrize("camera", [False, True], ids=["full", "camera"])
def test_training_forward_matches_jax_pallas(run_pallas, camera):
    check_forward(run_pallas, camera)


def test_training_render_matches_jax_pallas(run_pallas):
    check_render(run_pallas)
