"""The plain reference against the port at a tiny size on the CPU: the
same tree, weights and noise play the same episodes, and the check passes
under each cell's limits; the control (the reference in the precision
below the configuration's, in the program's place) fails them on a
number it reads."""

import math

import pytest
import torch

from benchmark import check, system
from benchmark.tests.helpers import FLAGSHIP, MLP, NOISYCONV, limits, small

LANES = 64


def _readings(name, seed, precision=None):
    cell = small(name)
    driver = cell.driver
    sut = driver.build(cell, seed, device="cpu")
    got = driver.checked(sut, cell)
    inputs = sut.inputs
    system.free(sut)
    want = driver.reference(cell, inputs, got, "cpu")
    if precision is not None:
        got = driver.reference(cell, inputs, want, "cpu", precision)
    return driver.numbers(cell, got, want, "cpu"), cell


@pytest.mark.parametrize("name", [MLP, FLAGSHIP, NOISYCONV])
def test_reference_agrees_with_port(name):
    values, cell = _readings(name, 2**31 + 7)
    ok, table = check.judge(values, limits(cell.name))
    assert ok, check.lines(table)
    assert values["lanes_diverged"] == 0.0
    assert values["obs_gap"] == 0.0


@pytest.mark.parametrize("name", [MLP, FLAGSHIP, NOISYCONV])
def test_control_fails(name):
    cell = small(name)
    control = check.CONTROL[cell.config["net"]["compute_dtype"]]
    values, cell = _readings(name, 11, control)
    ok, table = check.judge(values, limits(cell.name))
    assert not ok, check.lines(table)
    # every number compared is read, and one of them fails
    assert all(math.isfinite(v["value"]) for v in table.values()), table
    assert check.failed(table), table


def test_rounding_of_the_control():
    from benchmark.reference import nets

    x = torch.tensor([1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, -3.0001])
    assert nets._tf32(x).tolist() == [1.0, 1.0 + 2**-9, -3.0]
    y = nets._fp8(torch.linspace(-2, 2, 101))
    assert y.dtype == torch.bfloat16 and len(set(y.tolist())) < 101


def test_families_found_by_name():
    from benchmark.reference import nets

    for name in (MLP, FLAGSHIP, NOISYCONV):
        net = small(name).config["net"]
        assert nets.family(net).__name__.endswith(net["type"].lower())
    with pytest.raises(ValueError, match="families/gridnet.py"):
        nets.family({"type": "GridNet"})
