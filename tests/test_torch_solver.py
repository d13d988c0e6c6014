"""The port's exact solver (rnad_tpu_torch/env/solver.py and native.py)
against rnad_tpu's.

The batched simplex is the same C++ built with the same flags, so its
strategies and values must equal rnad_tpu's native solver's bitwise, on
random games and on degenerate integer games (ties everywhere), at ragged
active sizes up to A = 5.  The equilibrium selection, enumeration and
exploitability are copies of rnad_tpu's numpy code and must give equal
arrays on the same inputs.
"""

import numpy as np
import pytest

from rnad_tpu import native as jax_native
from rnad_tpu.env import solver as jax_solver
from rnad_tpu_torch import native as torch_native
from rnad_tpu_torch.env import solver as torch_solver


def _games(seed, n, A, integer):
    """n games of (A, A) payoffs with active sizes in [1, A]; integer games
    in {-1, 0, 1} are degenerate (tied payoffs, multiple equilibria)."""
    rng = np.random.default_rng(seed)
    if integer:
        payoff = rng.integers(-1, 2, size=(n, A, A)).astype(np.float64)
    else:
        payoff = rng.normal(size=(n, A, A))
    rows = rng.integers(1, A + 1, size=n).astype(np.int32)
    cols = rng.integers(1, A + 1, size=n).astype(np.int32)
    return payoff, rows, cols


CASES = [(0, 3, False), (1, 5, False), (2, 3, True), (3, 5, True),
         (4, 2, True)]


@pytest.mark.parametrize("seed,A,integer", CASES)
def test_native_batch_equals_rnad_tpu_native(seed, A, integer):
    payoff, rows, cols = _games(seed, 400, A, integer)
    want = jax_native.solve_zero_sum_batch_native(payoff, rows, cols)
    got = torch_solver.solve_zero_sum_batch(payoff, rows, cols)
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        np.testing.assert_array_equal(g, w)
    # and the plain numpy copy is rnad_tpu's numpy path
    plain = torch_solver._solve_batch_numpy(payoff, rows, cols)
    for g, w in zip(plain, jax_solver._solve_batch_numpy(payoff, rows,
                                                         cols)):
        np.testing.assert_array_equal(g, w)


def test_native_status_raises():
    """A game the simplex cannot read raises instead of falling back (a
    zero active size is outside every caller's range)."""
    payoff = np.zeros((1, 2, 2))
    with pytest.raises(RuntimeError, match="native solver"):
        torch_native.solve_zero_sum_batch_native(
            payoff, np.array([0], np.int32), np.array([2], np.int32))


@pytest.mark.parametrize("mode", ["pure", "mixed", "enummixed"])
@pytest.mark.parametrize("A", [3, 4])
def test_refine_equals_rnad_tpu(mode, A):
    payoff, rows, cols = _games(10 + A, 120, A, integer=True)
    x, y, v = jax_native.solve_zero_sum_batch_native(payoff, rows, cols)
    want = jax_solver.refine_equilibrium_batch(payoff, rows, cols, x, y, v,
                                               mode)
    got = torch_solver.refine_equilibrium_batch(payoff, rows, cols, x, y, v,
                                                mode)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[0] != x).any()  # some degenerate game was re-selected
    for s in range(payoff.shape[0]):
        r, c = int(rows[s]), int(cols[s])
        assert torch_solver.exploitability(payoff[s], got[0][s], got[1][s],
                                           r, c) < 1e-6


def test_enumerate_and_exploitability_equal_rnad_tpu():
    payoff, rows, cols = _games(20, 40, 4, integer=True)
    for s in range(payoff.shape[0]):
        r, c = int(rows[s]), int(cols[s])
        xs, ys, v = torch_solver.enumerate_equilibria(payoff[s], r, c)
        wxs, wys, wv = jax_solver.enumerate_equilibria(payoff[s], r, c)
        assert v == wv and len(xs) == len(wxs) and len(ys) == len(wys)
        for g, w in zip(xs + ys, wxs + wys):
            np.testing.assert_array_equal(g, w)
        for x in xs:
            for y in ys:
                got = torch_solver.exploitability(payoff[s], x, y, r, c)
                assert got == jax_solver.exploitability(payoff[s], x, y, r, c)
                assert got < 1e-6
    uniform = np.full(4, 0.25)
    assert (torch_solver.exploitability(payoff[0], uniform, uniform, 4, 4)
            == jax_solver.exploitability(payoff[0], uniform, uniform, 4, 4))
