"""A run with its timed path broken underneath comes out not correct:
everything of a run but the look for a card and the timing (the build,
the checked train steps through ``RNaD.train_step``, the reference and
the judgement under the cell's limits) on the CPU at a tiny size, once
for each fault a one-chip training cell can have."""

import math

import pytest

from benchmark import check, faults, system
from benchmark.tests.helpers import FLAGSHIP, MLP, NOISYCONV, limits, small


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", [MLP, FLAGSHIP, NOISYCONV])
def test_fault_is_caught(name, fault):
    cell = small(name)
    driver = cell.driver
    sut = driver.build(cell, 5, device="cpu")
    with faults.planted(fault):
        got = driver.checked(sut, cell)
    inputs = sut.inputs
    system.free(sut)
    want = driver.reference(cell, inputs, got, "cpu")
    ok, table = check.judge(driver.numbers(cell, got, want, "cpu"),
                            limits(cell.name))
    assert not ok, check.lines(table)
    assert all(math.isfinite(v["value"]) for v in table.values()), table


def test_faults_restore_the_program():
    from rnad_tpu_torch.learn import rnad as rnad_lib

    before = (rnad_lib.apply_update, rnad_lib.learn_loss, rnad_lib.rollout)
    for fault in faults.FAULTS:
        with faults.planted(fault):
            pass
    assert before == (rnad_lib.apply_update, rnad_lib.learn_loss,
                      rnad_lib.rollout)
