"""Exact zero-sum matrix-game solving (batched) and equilibrium selection.

Counterpart of ``rnad_tpu/env/solver.py``.  ``solve_zero_sum_batch`` runs
the native C++ batched simplex (``native.py``, ``csrc/solver.cpp``), as
``rnad_tpu``'s default does; a failed build raises instead of falling back,
because the numpy copy below rounds the game values otherwise in their last
bits and the content hash of a generated tree takes those bits.
``_solve_one_numpy`` and ``_solve_batch_numpy`` are a copy of
``rnad_tpu``'s numpy path, which mirrors the C++ pivot for pivot; they are
the plain version the tests hold against ``rnad_tpu``'s numpy path.

Any pair of LP-optimal strategies of a zero-sum game is a Nash equilibrium
and its bilinear value is the game value, which makes the generator's stored
solution an exact oracle (NashConv == 0).  On a degenerate game the simplex
stores one optimal vertex; ``refine_equilibrium_batch`` re-selects among the
optimal strategies (``TreeConfig.equilibrium_selection``): "pure" stores a
pure saddle point where one exists, "mixed" the maximal-support point of
the optimal face, and "enummixed" the reference's pick over all extreme
equilibria (``enumerate_equilibria``), purest first.  Each is an exact
equilibrium of the same value, so values, the hash and NashConv == 0 of the
stored solution are unchanged; the LPs of "mixed" run through
``scipy.optimize.linprog``.
"""

from __future__ import annotations

import itertools
import logging

import numpy as np

from .. import native

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
    """Solves a batch of zero-sum games exactly with the native simplex.

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
    return native.solve_zero_sum_batch_native(payoff, rows, cols)


def _face_lp(cost: np.ndarray, A_ub: np.ndarray, b_ub: np.ndarray):
    """min cost@z s.t. A_ub z <= b_ub, sum z = 1, z >= 0 (tiny, via HiGHS)."""
    from scipy.optimize import linprog  # only the selection modes need it

    n = cost.size
    res = linprog(cost, A_ub=A_ub, b_ub=b_ub,
                  A_eq=np.ones((1, n)), b_eq=[1.0],
                  bounds=[(0.0, 1.0)] * n, method="highs")
    return res.x if res.success else None


def _max_support_side(M: np.ndarray, v: float, x0: np.ndarray,
                      is_row: bool, tol: float) -> np.ndarray:
    """Maximal-support point of one player's optimal face.

    The row player's optimal face is {x >= 0, sum x = 1, x^T M >= v - tol};
    for each candidate support atom i, one LP maximizes x_i over the face,
    and the average of the maximizers (a convex combination, hence still in
    the face) carries the union of their supports — the maximal support
    attainable by any optimal strategy.
    """
    if is_row:
        A_ub, b_ub = -M.T, -np.full(M.shape[1], v - tol)
    else:
        A_ub, b_ub = M, np.full(M.shape[0], v + tol)
    n = x0.size
    points = [x0]
    for i in range(n):
        cost = np.zeros(n)
        cost[i] = -1.0
        z = _face_lp(cost, A_ub, b_ub)
        if z is not None and z[i] > tol:
            points.append(np.clip(z, 0.0, None))
    out = np.mean(points, axis=0)
    out[out < tol] = 0.0
    return out / out.sum()


def _optimal_vertices(M: np.ndarray, v: float, is_row: bool,
                      tol: float = 1e-8) -> list:
    """All extreme points of one player's optimal polytope.

    The row player's optimal set is X* = {x in the simplex : (x^T M)_j >=
    v for every column j}; a vertex of X* lies on the sum-to-one
    hyperplane with n-1 further constraints tight (from the nonnegativity
    and payoff rows), so for the small action counts of these games every
    (n-1)-subset is solved directly and feasibility-checked.  O(C(r+c,
    n-1)) tiny linear solves — the sizes pygambit's enummixed handles on
    the reference's trees (A <= 5) give a few hundred solves per node.
    """
    if is_row:
        n = M.shape[0]
        G = np.concatenate([-M.T, -np.eye(n)], axis=0)
        h = np.concatenate([-np.full(M.shape[1], v), np.zeros(n)])
    else:
        n = M.shape[1]
        G = np.concatenate([M, -np.eye(n)], axis=0)
        h = np.concatenate([np.full(M.shape[0], v), np.zeros(n)])
    if n == 1:
        return [np.ones(1)]
    verts, seen = [], set()
    for combo in itertools.combinations(range(G.shape[0]), n - 1):
        A_eq = np.vstack([np.ones((1, n)), G[list(combo)]])
        b_eq = np.concatenate([[1.0], h[list(combo)]])
        try:
            z = np.linalg.solve(A_eq, b_eq)
        except np.linalg.LinAlgError:
            continue
        if z.min() < -1e3 or not np.isfinite(z).all():
            continue
        if (G @ z <= h + tol).all() and z.min() >= -tol:
            z = np.clip(z, 0.0, None)
            z /= z.sum()
            key = tuple(np.round(z, 8))
            if key not in seen:
                seen.add(key)
                verts.append(z)
    return verts


def enumerate_equilibria(payoff: np.ndarray, rows: int | None = None,
                         cols: int | None = None, tol: float = 1e-8):
    """ALL extreme Nash equilibria of one zero-sum matrix game.

    The reference relies on pygambit's ``enummixed_solve`` for this
    (reference environment/tree.py:211-224) and picks from the sorted
    list.  For zero-sum games the equilibrium set is the product X* x Y*
    of the two players' optimal polytopes (exchangeability), so the
    extreme equilibria are ext(X*) x ext(Y*) — enumerated here by direct
    vertex enumeration, no Lemke-Howson needed.

    Returns ``(xs, ys, v)``: the lists of extreme optimal strategies of
    each player (every pairing is an exact equilibrium of value ``v``),
    each list sorted lexicographically for a deterministic order.
    """
    M = np.asarray(payoff, dtype=np.float64)
    r = rows if rows is not None else M.shape[0]
    c = cols if cols is not None else M.shape[1]
    M = M[:r, :c]
    x, y, v = _solve_one_numpy(M, r, c)
    xs = _optimal_vertices(M, v, True, tol)
    ys = _optimal_vertices(M, v, False, tol)
    if not xs:
        xs = [x]
    if not ys:
        ys = [y]
    order = lambda vs: sorted(vs, key=lambda z: tuple(np.round(z, 9)))
    return order(xs), order(ys), v


def _enummixed_pick(M: np.ndarray, v: float, x0: np.ndarray,
                    y0: np.ndarray, tol: float):
    """The reference's stored pick, reproduced over the full enumeration:
    sort the equilibrium list by the purity score ``-(x is pure) - (y is
    pure)`` (ascending — purest first: reference tree.py:226-234's sort)
    and store the first.  Ties break lexicographically (pygambit's own
    list order is not reproducible without pygambit; within a purity
    class every choice is an exact equilibrium of the same value)."""
    xs, ys, _ = enumerate_equilibria(M, tol=max(tol, 1e-9))
    pure = lambda z: float(z.max() > 1.0 - 1e-9)
    best = None
    for x in xs:
        for y in ys:
            score = (-pure(x) - pure(y), tuple(np.round(x, 9)),
                     tuple(np.round(y, 9)))
            if best is None or score < best[0]:
                best = (score, x, y)
    return best[1], best[2]


def refine_equilibrium_batch(payoff: np.ndarray, rows: np.ndarray,
                             cols: np.ndarray, x: np.ndarray, y: np.ndarray,
                             values: np.ndarray, mode: str,
                             tol: float = 1e-7):
    """Re-selects among each solved game's optimal strategies.

    Args mirror ``solve_zero_sum_batch``'s outputs; returns refined
    ``(x, y)`` (new arrays).  ``mode``:

      * ``"pure"``  — wherever a pure saddle point exists, store the first
        (lowest-index) one: the reference's sort places solutions containing
        a probability-1 entry first (tree.py:226-234), so its stored pick on
        such games is pure.  Vectorized, no LPs.
      * ``"mixed"`` — on nodes whose optimal face provably extends beyond
        the vertex's support (complementary slackness: any optimal x has
        support inside the tight set {i : (M y*)_i = v}), replace the vertex
        with the maximal-support face point (``_max_support_side``).
      * ``"enummixed"`` — the reference pipeline end to end: enumerate ALL
        extreme equilibria (``enumerate_equilibria``, replacing pygambit's
        enummixed_solve) on the degeneracy-flagged nodes, sort by the
        reference's purity score and store the first (``_enummixed_pick``).

    Every output is an optimal strategy of the same game (value unchanged);
    only which equilibrium is stored changes.
    """
    if mode not in ("pure", "mixed", "enummixed"):
        raise ValueError(f"unknown equilibrium selection mode {mode!r}")
    payoff = np.asarray(payoff, dtype=np.float64)
    S, max_r, max_c = payoff.shape
    x = np.array(x, dtype=np.float64, copy=True)
    y = np.array(y, dtype=np.float64, copy=True)
    values = np.asarray(values, dtype=np.float64)
    ridx = np.arange(max_r)
    cidx = np.arange(max_c)
    row_active = ridx[None, :] < np.asarray(rows)[:, None]  # (S, max_r)
    col_active = cidx[None, :] < np.asarray(cols)[:, None]  # (S, max_c)
    nontrivial = (np.asarray(rows) > 1) | (np.asarray(cols) > 1)

    if mode == "pure":
        # Row i is an optimal pure strategy iff min over active cols of
        # M[i, :] >= v; col j iff max over active rows of M[:, j] <= v.
        row_min = np.where(col_active[:, None, :], payoff, np.inf).min(2)
        col_max = np.where(row_active[:, :, None], payoff, -np.inf).max(1)
        rows_ok = row_active & (row_min >= values[:, None] - tol)
        cols_ok = col_active & (col_max <= values[:, None] + tol)
        saddle = nontrivial & rows_ok.any(1) & cols_ok.any(1)
        pick_r = rows_ok.argmax(1)  # first optimal pure row
        pick_c = cols_ok.argmax(1)
        x[saddle] = np.eye(max_r)[pick_r[saddle]]
        y[saddle] = np.eye(max_c)[pick_c[saddle]]
        return x, y

    # mixed/enummixed: prefilter — the face extends beyond the vertex only
    # if the tight set is strictly larger than the vertex support on
    # either side.
    payoff_masked = payoff * col_active[:, None, :]
    My = np.einsum("src,sc->sr", payoff_masked, y)
    xM = np.einsum("sr,src->sc", x, payoff * row_active[:, :, None])
    tight_r = row_active & (My >= values[:, None] - tol)
    tight_c = col_active & (xM <= values[:, None] + tol)
    grow_r = tight_r.sum(1) > (x > tol).sum(1)
    grow_c = tight_c.sum(1) > (y > tol).sum(1)
    flagged = np.nonzero(nontrivial & (grow_r | grow_c))[0]
    for s in flagged:
        r, c = int(rows[s]), int(cols[s])
        M = payoff[s, :r, :c]
        if mode == "enummixed":
            xs, ys = _enummixed_pick(M, values[s], x[s, :r], y[s, :c], tol)
            x[s, :r], x[s, r:] = xs, 0.0
            y[s, :c], y[s, c:] = ys, 0.0
            continue
        if grow_r[s]:
            x[s, :r] = _max_support_side(M, values[s], x[s, :r], True, tol)
            x[s, r:] = 0.0
        if grow_c[s]:
            y[s, :c] = _max_support_side(M, values[s], y[s, :c], False, tol)
            y[s, c:] = 0.0
    if flagged.size:
        logging.info("equilibrium selection (%s): refined %d/%d nodes",
                     mode, flagged.size, S)
    return x, y


def exploitability(payoff: np.ndarray, x: np.ndarray, y: np.ndarray,
                   rows: int, cols: int) -> float:
    """max_r (M y)_r - min_c (x M)_c : zero iff (x, y) is a Nash equilibrium."""
    M = np.asarray(payoff, dtype=np.float64)[:rows, :cols]
    return float((M @ y[:cols]).max() - (x[:rows] @ M).min())
