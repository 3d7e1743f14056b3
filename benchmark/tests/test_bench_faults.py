"""A run driven with the timed path broken underneath comes out not
correct: a step that leaves its state unchanged, a step over half of the
batch (the mean taken over the rest), a request whose answer is altered
where it is made. And the control, the reference put in the program's
place one precision below the configuration's (fp8 for bf16, TF32 for
float32), fails the cell's limits too. Each at a size a CPU test holds,
against the cell's own limits; the program runs in float32, so that a
sound run passes them."""

import time

import pytest

from benchmark import readings
from benchmark.harness import check, main
from conftest import FLOAT32, shrink, tiny_cell

TRAIN = "volsdf-8x256.train-b12"
INFER = "volsdf-8x256.infer-50view"


def run(name, hooks=None):
    cell = tiny_cell(name, FLOAT32)
    from benchmark.harness import infer, train
    kind = train if cell.traffic["kind"] == "train" else infer
    out = kind.run(cell, 2 ** 31 + 211, 0.01, False, "cpu", time.time(),
                   hooks)
    return check.judge(out["numbers"], cell.limits)[0]


@pytest.mark.parametrize("name", [TRAIN, INFER])
def test_sound_run_is_correct(name):
    assert run(name)


@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
def test_training_fault_is_not_correct(fault):
    assert not run(TRAIN, readings.FAULTS[fault]())


def test_altered_answer_is_not_correct():
    assert not run(INFER, readings.FAULTS["altered_answer"]())


@pytest.mark.parametrize("name", [TRAIN, INFER])
def test_control_is_not_correct(name):
    cell = tiny_cell(name)
    numbers = readings.control_numbers(cell, 2 ** 31 + 223, "cpu")
    assert not check.judge(numbers, cell.limits)[0]


def test_harness_entry_reports_checks_last():
    """`main.run` drives a cell end to end and puts `checks` last."""
    import benchmark.harness.spec as spec
    orig = spec.Cell

    def tiny(name, bench=None):
        return shrink(orig(name, bench), FLOAT32)
    spec.Cell = tiny
    try:
        result = main.run(INFER, 2 ** 31 + 227, 0.01, False, "cpu",
                          time.time())
    finally:
        spec.Cell = orig
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"infer_ms", "setup_s"}
    assert result["correct"] is True
