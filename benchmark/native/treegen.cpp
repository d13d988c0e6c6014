// Frozen copy of rnad_tpu_torch/csrc/treegen.cpp, kept with the benchmark so that
// a later change to the program cannot change the game trees it is measured on.
//
// Native level-synchronous game-tree generator.
//
// Fast path for generating large stochastic matrix-tree games (the Python
// generator in env/tree.py is numpy-bound at ~1M nodes/45s; this one does
// the whole build — topology, chance profiles, terminal values, bottom-up
// exact solving — in C++ with OpenMP, typically >10x faster).  The game
// semantics and tensor conventions are identical to env/tree.py (absorbing
// state 0, root 1, BFS ids, per-node exact NE solutions via the batched
// simplex in solver.cpp); the RNG stream is its own (seeded splitmix/PCG +
// Marsaglia-Tsang gamma for Dirichlet), so trees differ from the Python
// generator's for the same seed — trees are identified by content hash, not
// by seed.
//
// Build: g++ -O3 -fopenmp -shared -fPIC solver.cpp treegen.cpp -o libsolver.so

#include <algorithm>
#include <cstdio>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" int solve_zero_sum_batch(const double* payoff, const int* rows,
                                    const int* cols, int batch, int max_rows,
                                    int max_cols, double* row_strat,
                                    double* col_strat, double* values);

namespace {

// splitmix64 — tiny, seedable, good enough for game generation.
struct Rng {
  uint64_t s;
  explicit Rng(uint64_t seed) : s(seed + 0x9e3779b97f4a7c15ULL) {}
  uint64_t next() {
    uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  double uniform() {  // [0, 1)
    return (next() >> 11) * 0x1.0p-53;
  }
  double normal() {  // Box-Muller (one value per call; wasteful but simple)
    double u1 = std::max(uniform(), 1e-300), u2 = uniform();
    return std::sqrt(-2.0 * std::log(u1)) * std::cos(6.283185307179586 * u2);
  }
  // Marsaglia-Tsang gamma(alpha) for alpha possibly < 1.
  double gamma(double alpha) {
    if (alpha < 1.0) {
      double u = std::max(uniform(), 1e-300);
      return gamma(alpha + 1.0) * std::pow(u, 1.0 / alpha);
    }
    const double d = alpha - 1.0 / 3.0;
    const double c = 1.0 / std::sqrt(9.0 * d);
    for (;;) {
      double x = normal();
      double v = 1.0 + c * x;
      if (v <= 0.0) continue;
      v = v * v * v;
      double u = std::max(uniform(), 1e-300);
      if (u < 1.0 - 0.0331 * x * x * x * x) return d * v;
      if (std::log(u) < 0.5 * x * x + d * (1.0 - v + std::log(v))) return d * v;
    }
  }
};

struct Node {
  int32_t row_a, col_a, depth_bound;
};

struct Level {
  int64_t first_id;  // id of the level's first node
  int32_t count;
};

struct TreeBuf {
  int A = 0, T = 0;
  int64_t size = 0;  // including absorbing state 0
  std::vector<int32_t> index;    // (S, T, A, A)
  std::vector<float> value;      // (S, T, A, A)
  std::vector<float> chance;     // (S, T, A, A)
  std::vector<float> ev;         // (S, A, A)
  std::vector<float> legal;      // (S, A, A)
  std::vector<float> solution;   // (S, 2A)
  std::vector<float> root_value; // (S,)
  std::vector<int32_t> depth;    // (S,)
};

TreeBuf* g_buf = nullptr;

struct Rule {
  int delta, stoch_delta;
  double prob;
  int apply(int v, Rng& rng) const {
    int out = v + delta;
    if (prob > 0.0 && stoch_delta != 0 && rng.uniform() < prob)
      out += stoch_delta;
    return out;
  }
};

}  // namespace

extern "C" {

// Generates a tree; returns its size (including the absorbing state) or a
// negative error code.  Results are fetched with treegen_fetch and released
// with treegen_free.
int64_t treegen_generate(
    uint64_t seed, int max_actions, int max_transitions, int depth_bound,
    int root_row, int root_col, double threshold,
    const double* terminal_values, int n_terminal,
    // shaping rules: (delta, stoch_delta, prob) x (row, col, depth)
    int row_d, int row_sd, double row_p,
    int col_d, int col_sd, double col_p,
    int dep_d, int dep_sd, double dep_p,
    int64_t max_nodes) {
  const int A = max_actions, T = max_transitions;
  if (T < 1 || T > 64) return -4;  // fixed Dirichlet scratch is 64-wide
  if (A < 1 || n_terminal < 1) return -5;
  const int AA = A * A;
  const Rule rrow{row_d, row_sd, row_p}, rcol{col_d, col_sd, col_p},
      rdep{dep_d, dep_sd, dep_p};
  Rng rng(seed);

  delete g_buf;
  g_buf = new TreeBuf();
  TreeBuf& out = *g_buf;
  out.A = A;
  out.T = T;

  std::vector<Node> frontier{{int32_t(root_row), int32_t(root_col),
                              int32_t(depth_bound)}};
  std::vector<Node> nodes;  // all internal nodes in BFS order (id = i + 1)
  std::vector<Level> levels;
  nodes.push_back(frontier[0]);

  // chance/index/terminal-value tensors per node, filled level by level.
  // Node id i (1-based) lives at nodes[i-1].
  std::vector<float> chance;  // (N, T, A, A)
  std::vector<int32_t> index;  // (N, T, A, A)
  std::vector<float> tval;  // (N, T, A, A) terminal rewards at index==0 cells

  int64_t next_id = 2;
  int64_t level_first = 1;
  while (!frontier.empty()) {
    const int n = (int)frontier.size();
    levels.push_back({level_first, n});
    const size_t base = chance.size();
    chance.resize(base + (size_t)n * T * AA, 0.f);
    index.resize(index.size() + (size_t)n * T * AA, 0);
    tval.resize(tval.size() + (size_t)n * T * AA, 0.f);

    std::vector<Node> next;
    for (int i = 0; i < n; ++i) {
      const Node nd = frontier[i];
      float* ch = &chance[base + (size_t)i * T * AA];
      int32_t* ix = &index[base + (size_t)i * T * AA];
      float* tv = &tval[base + (size_t)i * T * AA];
      for (int r = 0; r < nd.row_a; ++r) {
        for (int c = 0; c < nd.col_a; ++c) {
          // Dirichlet(1/T) chance profile, thresholded + renormalized
          // (env/tree.py _sample_chance semantics).
          double p[64];
          double sum = 0.0;
          for (int t = 0; t < T; ++t) {
            p[t] = T == 1 ? 1.0 : rng.gamma(1.0 / T);
            sum += p[t];
          }
          // Normalize and find the argmax of the RAW draw before
          // thresholding (the fallback keeps the raw argmax when every
          // entry falls below the threshold, matching env/tree.py).
          int argmax = 0;
          for (int t = 0; t < T; ++t) {
            p[t] /= sum;
            if (p[t] > p[argmax]) argmax = t;
          }
          double kept = 0.0;
          for (int t = 0; t < T; ++t) {
            if (p[t] < threshold) p[t] = 0.0;
            kept += p[t];
          }
          if (kept <= 0.0) {
            p[argmax] = 1.0;
            kept = 1.0;
          }
          for (int t = 0; t < T; ++t) {
            if (p[t] <= 0.0) continue;
            const double prob = p[t] / kept;
            ch[(size_t)t * AA + r * A + c] = (float)prob;
            // child spec (env/tree.py child-decision semantics)
            const int cra = std::min(A, std::max(1, rrow.apply(nd.row_a, rng)));
            const int cca = std::min(A, std::max(1, rcol.apply(nd.col_a, rng)));
            const int cdb = std::max(0, rdep.apply(nd.depth_bound, rng));
            if (cdb > 0) {
              if (next_id > max_nodes) return -2;  // capacity exceeded
              ix[(size_t)t * AA + r * A + c] = (int32_t)next_id++;
              next.push_back({(int32_t)cra, (int32_t)cca, (int32_t)cdb});
              nodes.push_back(next.back());
            } else {
              tv[(size_t)t * AA + r * A + c] =
                  (float)terminal_values[rng.next() % n_terminal];
            }
          }
        }
      }
    }
    level_first += n;
    frontier.swap(next);
  }

  const int64_t N = (int64_t)nodes.size();
  const int64_t S = N + 1;
  out.size = S;
  out.index.assign((size_t)S * T * AA, 0);
  out.value.assign((size_t)S * T * AA, 0.f);
  out.chance.assign((size_t)S * T * AA, 0.f);
  out.ev.assign((size_t)S * AA, 0.f);
  out.legal.assign((size_t)S * AA, 0.f);
  out.solution.assign((size_t)S * 2 * A, 0.f);
  out.root_value.assign((size_t)S, 0.f);
  out.depth.assign((size_t)S, 0);

  std::memcpy(&out.index[(size_t)T * AA], index.data(),
              sizeof(int32_t) * N * T * AA);
  std::memcpy(&out.chance[(size_t)T * AA], chance.data(),
              sizeof(float) * N * T * AA);
  // absorbing state: one certain self-loop cell
  out.chance[0] = 1.0f;
  out.legal[0] = 1.0f;

  std::vector<double> node_value((size_t)S, 0.0);

  // Bottom-up: one batched LP per level.
  for (int li = (int)levels.size() - 1; li >= 0; --li) {
    const Level lv = levels[li];
    const int n = lv.count;
    std::vector<double> evmat((size_t)n * AA, 0.0);
    std::vector<int> rows(n), cols(n);

#pragma omp parallel for schedule(static)
    for (int i = 0; i < n; ++i) {
      const int64_t id = lv.first_id + i;
      const Node nd = nodes[id - 1];
      rows[i] = nd.row_a;
      cols[i] = nd.col_a;
      float* lgl = &out.legal[(size_t)id * AA];
      for (int r = 0; r < nd.row_a; ++r)
        for (int c = 0; c < nd.col_a; ++c) lgl[r * A + c] = 1.0f;

      const float* ch = &out.chance[(size_t)id * T * AA];
      const int32_t* ix = &out.index[(size_t)id * T * AA];
      const float* tv = &tval[((size_t)id - 1) * T * AA];
      float* val = &out.value[(size_t)id * T * AA];
      int32_t dmax = 0;
      for (int t = 0; t < T; ++t) {
        for (int cell = 0; cell < AA; ++cell) {
          const size_t k = (size_t)t * AA + cell;
          if (ch[k] <= 0.f) continue;
          const int32_t child = ix[k];
          double v;
          if (child == 0) {
            v = tv[k];
          } else {
            v = node_value[child];
            dmax = std::max(dmax, out.depth[child]);
          }
          val[k] = (float)v;
          evmat[(size_t)i * AA + cell] += ch[k] * v;
        }
      }
      out.depth[id] = dmax + 1;
      float* ev = &out.ev[(size_t)id * AA];
      for (int cell = 0; cell < AA; ++cell)
        ev[cell] = (float)evmat[(size_t)i * AA + cell];
    }

    std::vector<double> xs((size_t)n * A), ys((size_t)n * A), vs(n);
    const int rc = solve_zero_sum_batch(evmat.data(), rows.data(),
                                        cols.data(), n, A, A, xs.data(),
                                        ys.data(), vs.data());
    if (rc != 0) {
      // Find and report the first offending matrix for diagnosis.
      for (int i = 0; i < n; ++i) {
        const int rc1 = solve_zero_sum_batch(
            &evmat[(size_t)i * AA], &rows[i], &cols[i], 1, A, A,
            &xs[(size_t)i * A], &ys[(size_t)i * A], &vs[i]);
        if (rc1 != 0) {
          std::fprintf(stderr,
                       "[treegen] solver status %d at level %d node %d "
                       "(%dx%d):\n", rc1, li, i, rows[i], cols[i]);
          for (int r = 0; r < rows[i]; ++r) {
            for (int c = 0; c < cols[i]; ++c)
              std::fprintf(stderr, " % .17g", evmat[(size_t)i * AA + r * A + c]);
            std::fprintf(stderr, "\n");
          }
          return -3;
        }
      }
      return -3;  // transient? all nodes solved individually
    }

#pragma omp parallel for schedule(static)
    for (int i = 0; i < n; ++i) {
      const int64_t id = lv.first_id + i;
      node_value[id] = vs[i];
      out.root_value[id] = (float)vs[i];
      for (int a = 0; a < A; ++a) {
        out.solution[(size_t)id * 2 * A + a] = (float)xs[(size_t)i * A + a];
        out.solution[(size_t)id * 2 * A + A + a] =
            (float)ys[(size_t)i * A + a];
      }
    }
  }
  return S;
}

// Copies the generated tensors into caller-allocated buffers.
int treegen_fetch(int32_t* index, float* value, float* chance, float* ev,
                  float* legal, float* solution, float* root_value,
                  int32_t* depth) {
  if (!g_buf) return 1;
  const TreeBuf& b = *g_buf;
  std::memcpy(index, b.index.data(), sizeof(int32_t) * b.index.size());
  std::memcpy(value, b.value.data(), sizeof(float) * b.value.size());
  std::memcpy(chance, b.chance.data(), sizeof(float) * b.chance.size());
  std::memcpy(ev, b.ev.data(), sizeof(float) * b.ev.size());
  std::memcpy(legal, b.legal.data(), sizeof(float) * b.legal.size());
  std::memcpy(solution, b.solution.data(), sizeof(float) * b.solution.size());
  std::memcpy(root_value, b.root_value.data(),
              sizeof(float) * b.root_value.size());
  std::memcpy(depth, b.depth.data(), sizeof(int32_t) * b.depth.size());
  return 0;
}

void treegen_free() {
  delete g_buf;
  g_buf = nullptr;
}

}  // extern "C"
