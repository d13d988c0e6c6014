"""Exact zero-sum matrix-game solving, numpy simplex only.

Counterpart of ``rnad_tpu/env/solver.py``.  The JAX package's primary path
is a native C++ batched simplex; its numpy fallback mirrors that code pivot
for pivot, and this module is a copy of the fallback (``_solve_one_numpy``,
``_solve_batch_numpy``).  The native library, equilibrium refinement and
enumeration are not ported yet, so the port stores the simplex's optimal
vertex on degenerate games (``TreeConfig.equilibrium_selection="vertex"``).

Any pair of LP-optimal strategies of a zero-sum game is a Nash equilibrium
and its bilinear value is the game value, which makes the generator's stored
solution an exact oracle (NashConv == 0).
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-11
_BLAND_AFTER = 256
_MAX_ITERS = 4096


def _solve_one_numpy(payoff: np.ndarray, rows: int, cols: int,
                     need_dual: bool = True):
    """Single-game simplex (division-form pivot, transposed-game recovery
    for dual-degenerate optima), as in rnad_tpu's numpy path."""
    M = payoff[:rows, :cols].astype(np.float64)
    if rows == 1 and cols == 1:
        return np.array([1.0]), np.array([1.0]), float(M[0, 0])
    k = 1.0 - M.min()
    m, n = rows, cols
    T = np.zeros((m + 1, n + m + 1))
    T[:m, :n] = M + k
    T[:m, n:n + m] = np.eye(m)
    T[:m, -1] = 1.0
    T[m, :n] = -1.0
    basis = list(range(n, n + m))

    iters = 0
    while True:
        iters += 1
        if iters > _MAX_ITERS:
            raise RuntimeError("simplex iteration limit")
        obj = T[m, : n + m].copy()
        bland = iters > _BLAND_AFTER
        # Entering column + ratio test; numerically "unbounded" columns
        # (possible only through degeneracy) are skipped.
        enter = leave = -1
        while True:
            cand = np.nonzero(obj < -_EPS)[0]
            if cand.size == 0:
                enter = -1
                break
            enter = int(cand[0] if bland else cand[np.argmin(obj[cand])])
            col = T[:m, enter]
            pos = col > _EPS
            if pos.any():
                ratios = np.where(pos, T[:m, -1] / np.where(pos, col, 1.0),
                                  np.inf)
                best = ratios.min()
                ties = np.nonzero(ratios < best + _EPS)[0]
                leave = int(min(ties, key=lambda i: basis[i]))
                break
            obj[enter] = 0.0  # ban this column
        if enter < 0:
            break  # optimal
        piv = T[leave, enter]
        T[leave] /= piv
        for i in range(m + 1):
            if i != leave and T[i, enter] != 0.0:
                T[i] -= T[i, enter] * T[leave]
        basis[leave] = enter

    S = T[m, -1]
    if not S > _EPS:
        raise RuntimeError("degenerate game value")
    vprime = 1.0 / S
    y = np.zeros(cols)
    for i in range(m):
        if basis[i] < n:
            y[basis[i]] = T[i, -1] * vprime
    x = T[m, n:n + m] * vprime
    x = np.clip(x, 0.0, None)
    y = np.clip(y, 0.0, None)
    if y.sum() <= 0.0:
        raise RuntimeError("degenerate game value")
    y /= y.sum()
    if x.sum() <= 0.0:
        if need_dual:
            # Dual-degenerate optimum: read the row strategy as the primal
            # side of the transposed game.
            _, x, _ = _solve_one_numpy(
                np.ascontiguousarray(-M.T), cols, rows, need_dual=False)
        else:
            x = np.zeros(rows)
            x[0] = 1.0  # primal-only caller never reads this side
    x /= x.sum()
    v = float(x @ M @ y)
    return x, y, v


def _solve_batch_numpy(payoff, rows, cols):
    batch, max_r, max_c = payoff.shape
    row_strat = np.zeros((batch, max_r))
    col_strat = np.zeros((batch, max_c))
    values = np.zeros((batch,))
    for b in range(batch):
        x, y, v = _solve_one_numpy(payoff[b], int(rows[b]), int(cols[b]))
        row_strat[b, : x.size] = x
        col_strat[b, : y.size] = y
        values[b] = v
    return row_strat, col_strat, values


def solve_zero_sum_batch(payoff: np.ndarray, rows: np.ndarray,
                         cols: np.ndarray):
    """Solves a batch of zero-sum games exactly.

    Args:
      payoff: (batch, max_rows, max_cols) float array, row-player payoffs;
        entries beyond the active (rows[b], cols[b]) block are ignored.
      rows, cols: (batch,) int arrays of active sizes.

    Returns:
      (row_strat (batch, max_rows), col_strat (batch, max_cols),
       values (batch,)) as float64 arrays; strategies zero-padded.
    """
    payoff = np.asarray(payoff, dtype=np.float64)
    rows = np.asarray(rows, dtype=np.int32)
    cols = np.asarray(cols, dtype=np.int32)
    if payoff.ndim != 3:
        raise ValueError(f"payoff must be 3D, got {payoff.shape}")
    return _solve_batch_numpy(payoff, rows, cols)
