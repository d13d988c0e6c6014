// Frozen copy of rnad_tpu_torch/csrc/solver.cpp, kept with the benchmark so that
// a later change to the program cannot change the game trees it is measured on.
//
// Batched exact zero-sum matrix-game solver.
//
// TPU-native replacement for the reference's per-node pygambit C++ calls
// (reference environment/tree.py:199-234): during tree generation every
// internal node's expected-value matrix must be solved for an exact Nash
// equilibrium.  The reference calls pygambit's enummixed/lcp solvers one
// matrix at a time with an O(A^2) Python Decimal conversion per node; here we
// solve a whole level of the game tree in one batched call, parallelized with
// OpenMP, using the classic linear-programming formulation of zero-sum games:
//
//   value(M) = max_x min_y x^T M y,   x,y simplex-constrained.
//
// Shift M' = M + k so every entry >= 1, then solve the primal LP
//     max 1^T w   s.t.  M' w <= 1,  w >= 0
// with a dense tableau simplex (slack basis is feasible).  At the optimum,
// S = 1^T w = 1 / value(M'), the column strategy is y = w / S, and the row
// strategy is recovered from the duals (reduced costs on slack columns).
// Any pair of optimal strategies in a zero-sum game is a Nash equilibrium
// (equilibrium exchangeability), so solving one LP suffices.
//
// Determinism: Dantzig pivoting with lowest-index tie-breaks, switching to
// Bland's rule after an iteration threshold to guarantee termination on
// degenerate games.  All arithmetic in double precision.
//
// Build: g++ -O3 -fopenmp -shared -fPIC solver.cpp -o libsolver.so

#include <cmath>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr double kEps = 1e-11;
constexpr int kBlandAfter = 256;
constexpr int kMaxIters = 4096;

// Solve one (rows x cols) zero-sum game. Payoff is row-major with leading
// dimension ld_c (the padded max_cols of the batch tensor).
// Writes row strategy (length rows), col strategy (length cols), and value.
// need_dual: when false the caller only consumes the primal (column)
// strategy, so a dual-degenerate optimum is not an error.  On a
// dual-degenerate optimum with need_dual (all slack reduced costs clipped
// to zero, so the row strategy cannot be read off) we retry once via the
// transposed game, whose PRIMAL read-out yields our row strategy.
int solve_one(const double* payoff, int rows, int cols, int ld_c,
              double* row_strat, double* col_strat, double* value,
              bool need_dual = true) {
  // Trivial cases.
  if (rows <= 0 || cols <= 0) return 1;
  if (rows == 1 && cols == 1) {
    row_strat[0] = 1.0;
    col_strat[0] = 1.0;
    *value = payoff[0];
    return 0;
  }

  // Shift so that all entries >= 1 (keeps the LP value strictly positive).
  double mn = payoff[0];
  for (int r = 0; r < rows; ++r)
    for (int c = 0; c < cols; ++c) mn = std::min(mn, payoff[r * ld_c + c]);
  const double k = 1.0 - mn;

  // Tableau: m = rows constraints, n = cols variables, plus m slacks and RHS.
  const int m = rows, n = cols;
  const int width = n + m + 1;
  std::vector<double> T((m + 1) * width, 0.0);
  std::vector<int> basis(m);
  auto at = [&](int i, int j) -> double& { return T[i * width + j]; };

  for (int i = 0; i < m; ++i) {
    for (int j = 0; j < n; ++j) at(i, j) = payoff[i * ld_c + j] + k;
    at(i, n + i) = 1.0;
    at(i, n + m) = 1.0;  // RHS
    basis[i] = n + i;
  }
  for (int j = 0; j < n; ++j) at(m, j) = -1.0;  // objective: max sum(w)

  int iters = 0;
  std::vector<char> banned(n + m);
  for (;;) {
    if (++iters > kMaxIters) return 2;  // should be unreachable for small games
    const bool bland = iters > kBlandAfter;

    // Entering column + ratio test.  The LP is bounded (M' >= 1), so an
    // entering column without positive entries can only be a numerical
    // artifact on highly degenerate games (reduced cost ~ -eps); such
    // columns are skipped rather than declared unbounded.
    std::fill(banned.begin(), banned.end(), 0);
    int enter = -1, leave = -1;
    double best_ratio = 0.0;
    for (;;) {
      enter = -1;
      double best = -kEps;
      for (int j = 0; j < n + m; ++j) {
        if (banned[j]) continue;
        const double rc = at(m, j);
        if (rc < -kEps) {
          if (bland) {
            enter = j;
            break;
          }
          if (rc < best) {
            best = rc;
            enter = j;
          }
        }
      }
      if (enter < 0) break;  // optimal (no usable entering column)

      // Ratio test: global minimum first, then lowest basis index among
      // rows within eps of that minimum (two-pass, matching the numpy
      // fallback exactly so both paths pivot identically on degenerate
      // games and produce the same strategies).
      leave = -1;
      best_ratio = 0.0;
      for (int i = 0; i < m; ++i) {
        const double a = at(i, enter);
        if (a > kEps) {
          const double ratio = at(i, n + m) / a;
          if (leave < 0 || ratio < best_ratio) {
            best_ratio = ratio;
            leave = i;
          }
        }
      }
      if (leave >= 0) {
        for (int i = 0; i < m; ++i) {
          const double a = at(i, enter);
          if (a > kEps && at(i, n + m) / a < best_ratio + kEps &&
              basis[i] < basis[leave]) {
            leave = i;
          }
        }
        break;  // found a pivot
      }
      banned[enter] = 1;  // numerically unbounded column: skip it
    }
    if (enter < 0) break;  // optimal

    // Pivot.  Division (not multiply-by-reciprocal) so the arithmetic is
    // bit-identical to the numpy fallback's `T[leave] /= piv`: on highly
    // degenerate games a one-ulp difference can flip an eps comparison and
    // send the two implementations down different pivot paths.
    const double piv = at(leave, enter);
    for (int j = 0; j < width; ++j) at(leave, j) /= piv;
    at(leave, enter) = 1.0;
    for (int i = 0; i <= m; ++i) {
      if (i == leave) continue;
      const double f = at(i, enter);
      if (f != 0.0) {
        for (int j = 0; j < width; ++j) at(i, j) -= f * at(leave, j);
        at(i, enter) = 0.0;
      }
    }
    basis[leave] = enter;
  }

  const double S = at(m, n + m);  // optimal objective = 1 / value(M')
  if (!(S > kEps)) return 4;
  const double vprime = 1.0 / S;

  // Column strategy from basic variables.
  for (int c = 0; c < cols; ++c) col_strat[c] = 0.0;
  for (int i = 0; i < m; ++i)
    if (basis[i] < n) col_strat[basis[i]] = at(i, n + m) * vprime;
  // Row strategy from duals: reduced costs on slack columns.
  for (int r = 0; r < rows; ++r) row_strat[r] = at(m, n + r) * vprime;

  // Clean + renormalize to exact simplex membership.
  double sx = 0.0, sy = 0.0;
  for (int r = 0; r < rows; ++r) {
    if (row_strat[r] < 0.0) row_strat[r] = 0.0;
    sx += row_strat[r];
  }
  for (int c = 0; c < cols; ++c) {
    if (col_strat[c] < 0.0) col_strat[c] = 0.0;
    sy += col_strat[c];
  }
  if (sy <= 0.0) return 5;
  for (int c = 0; c < cols; ++c) col_strat[c] /= sy;
  if (sx <= 0.0 && need_dual) {
    // Dual-degenerate optimum: the duals are not readable off this tableau
    // but the primal (basic-variable) read-out is always well defined, so
    // solve the TRANSPOSED game, whose primal side is our row player:
    // in N = -M^T the row roles swap, and N's column strategy (basics)
    // is M's row strategy.  One level of recursion only.
    std::vector<double> nt(static_cast<size_t>(cols) * rows);
    for (int c = 0; c < cols; ++c)
      for (int r = 0; r < rows; ++r)
        nt[static_cast<size_t>(c) * rows + r] = -payoff[r * ld_c + c];
    std::vector<double> drop(cols);
    double v2 = 0.0;
    const int rc = solve_one(nt.data(), cols, rows, rows, drop.data(),
                             row_strat, &v2, /*need_dual=*/false);
    if (rc != 0) return 5;
    sx = 0.0;
    for (int r = 0; r < rows; ++r) sx += row_strat[r];
    if (sx <= 0.0) return 5;
  } else if (sx <= 0.0) {
    // primal-only caller: hand back a well-formed (if meaningless) vector
    for (int r = 0; r < rows; ++r) row_strat[r] = 0.0;
    sx = 1.0;
    row_strat[0] = 1.0;
  }
  for (int r = 0; r < rows; ++r) row_strat[r] /= sx;

  // Report the consistent bilinear value x^T M y (pre-shift payoff).
  double v = 0.0;
  for (int r = 0; r < rows; ++r) {
    if (row_strat[r] == 0.0) continue;
    double acc = 0.0;
    for (int c = 0; c < cols; ++c) acc += payoff[r * ld_c + c] * col_strat[c];
    v += row_strat[r] * acc;
  }
  (void)vprime;
  *value = v;
  return 0;
}

}  // namespace

extern "C" {

// payoff:    (batch, max_rows, max_cols) row-major, padded with anything
// rows/cols: per-game active sizes (1 <= rows <= max_rows etc.)
// row_strat: (batch, max_rows) output, zero-padded
// col_strat: (batch, max_cols) output, zero-padded
// values:    (batch,) output
// Returns 0 on success, otherwise the first nonzero per-game status code.
int solve_zero_sum_batch(const double* payoff, const int* rows, const int* cols,
                         int batch, int max_rows, int max_cols,
                         double* row_strat, double* col_strat, double* values) {
  int status = 0;
#pragma omp parallel for schedule(dynamic, 16)
  for (int b = 0; b < batch; ++b) {
    std::memset(row_strat + (size_t)b * max_rows, 0,
                sizeof(double) * max_rows);
    std::memset(col_strat + (size_t)b * max_cols, 0,
                sizeof(double) * max_cols);
    const int rc = solve_one(payoff + (size_t)b * max_rows * max_cols, rows[b],
                             cols[b], max_cols, row_strat + (size_t)b * max_rows,
                             col_strat + (size_t)b * max_cols, values + b);
    if (rc != 0) {
#pragma omp critical
      if (status == 0) status = rc;
    }
  }
  return status;
}

}  // extern "C"
