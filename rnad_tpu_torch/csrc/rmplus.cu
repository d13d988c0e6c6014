// Batched alternating RM+ (CFR+) for zero-sum matrix games, batch-minor.
//
// Replaces: rnad_tpu/ops/pallas_rmplus.py, `_kernel` (called by `rmplus`),
// whose body is rnad_tpu/env/solver_device.py::rmplus_core.  Inputs are
// M (R, C, B) payoffs with illegal cells zeroed, lr (R, B) and lc (C, B)
// {0, 1} legality masks; outputs are the linear-averaged strategies x (R, B),
// y (C, B) and their bilinear value v (B,), all float32.
//
// Bound on the H100: operations.  A game's loop needs about
// 4RC + 10R + 11C + 3 operations per iteration (ops/rmplus.py::operations
// counts them) on a constant (R, C) block, so at A = 5 and 128 iterations
// the learner's 327,680 games are ~8.7 GFLOP against ~60 MB of traffic.
// What the card can issue bounds it, so the design counts instructions.
//
// Design: one thread per game.  The payoff block (R and C padded to the
// template size N, with zero payoffs and zero legality, which adds only
// exact +0 terms) and the carries stay in registers for the whole loop, so
// device memory sees one read of M and the masks and one write of x, y and
// v, whatever `iters` is.  Thread b reads element b of every batch-minor
// row, so each warp's loads and stores are coalesced.  Every sum runs in
// index order.  The strategy that normalize(qc, lc) gives at the top of an
// iteration is the one the previous iteration ended with, so it is carried
// instead of recomputed; likewise normalize(qr, lr).
//
// The instruction count per game-iteration was cut in three steps (PERF.md
// has each step's SASS count and time):
//  1. Exact cuts where a game's masks hold only 0 and 1, as every caller's
//     do: a regret on an illegal action starts at +0 and its update adds
//     (u - v) * 0, so it stays +0, and normalize's q * legal is q.  The
//     regret update is one FMA with the mask (q + d * 1 = q + d and
//     q + d * 0 = q, both exact).  The uniform strategies are the masks
//     times 1 / count, computed once.  A game with any other mask value
//     takes the same loop with normalize's product by the mask kept
//     (Binary = false), so every mask gets the plain version's function.
//  2. One IEEE reciprocal per normalization, then N products, instead of N
//     divisions (changes rounding: ops/rmplus.py holds it to `agreement`).
//  3. FMA contraction of the utilities, the values and the running averages
//     (changes rounding the same way; sums stay in index order).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
// c + a * b, rounded once
__device__ __forceinline__ float madd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

template <int N>
struct Game {
  float m[N][N], lr[N], lc[N];  // payoffs and masks, zero-padded
  float inv_nr, inv_nc;         // 1 / max(sum of each seat's mask, 1)
  float qr[N], qc[N], xsum[N], ysum[N], x[N], y[N];
};

// rmplus_core's normalize: q * legal / max(sum, 1e-30) where the sum is
// positive, else the uniform strategy legal / count.
template <int N, bool Binary>
__device__ __forceinline__ void normalize(const float (&q)[N],
                                          const float (&legal)[N],
                                          float inv_n, float (&out)[N]) {
  if (Binary) {
    // q is +0 on illegal actions (step 1), so q * legal is q.  s > 0:
    // q * (1/d) + legal * 0; else every q is +0 and the sum is
    // q * (1/d) = +0 plus legal / count: both exact selections
    float s = q[0];
#pragma unroll
    for (int i = 1; i < N; ++i) s = add(s, q[i]);
    const float inv = __frcp_rn(fmaxf(s, 1e-30f));
    const float c = s > 0.f ? 0.f : inv_n;
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = __fmaf_rn(legal[i], c, mul(q[i], inv));
  } else {
    float ql[N];
#pragma unroll
    for (int i = 0; i < N; ++i) ql[i] = mul(q[i], legal[i]);
    float s = ql[0];
#pragma unroll
    for (int i = 1; i < N; ++i) s = add(s, ql[i]);
    const float inv = __frcp_rn(fmaxf(s, 1e-30f));
#pragma unroll
    for (int i = 0; i < N; ++i)
      out[i] = s > 0.f ? mul(ql[i], inv) : mul(legal[i], inv_n);
  }
}

// Loads game b (b < B); returns whether its masks hold only 0 and 1.
template <int N>
__device__ __forceinline__ bool load(Game<N>& g, const float* __restrict__ M,
                                     const float* __restrict__ lr,
                                     const float* __restrict__ lc, int64_t B,
                                     int64_t b, int R, int C) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    g.lr[r] = r < R ? lr[r * B + b] : 0.f;
#pragma unroll
    for (int c = 0; c < N; ++c)
      g.m[r][c] = r < R && c < C ? M[((int64_t)r * C + c) * B + b] : 0.f;
  }
#pragma unroll
  for (int c = 0; c < N; ++c) g.lc[c] = c < C ? lc[c * B + b] : 0.f;
  float nr = g.lr[0], nc = g.lc[0];
#pragma unroll
  for (int i = 1; i < N; ++i) {
    nr = add(nr, g.lr[i]);
    nc = add(nc, g.lc[i]);
  }
  g.inv_nr = __frcp_rn(fmaxf(nr, 1.f));
  g.inv_nc = __frcp_rn(fmaxf(nc, 1.f));
  bool binary = true;
  // zero regrets normalize to the uniform strategies
#pragma unroll
  for (int i = 0; i < N; ++i) {
    g.qr[i] = g.qc[i] = g.xsum[i] = g.ysum[i] = 0.f;
    g.x[i] = mul(g.lr[i], g.inv_nr);
    g.y[i] = mul(g.lc[i], g.inv_nc);
    binary &= (g.lr[i] == 0.f || g.lr[i] == 1.f) &&
              (g.lc[i] == 0.f || g.lc[i] == 1.f);
  }
  return binary;
}

// One alternating iteration with averaging weight w.
template <int N, bool Binary>
__device__ __forceinline__ void iterate(Game<N>& g, float w) {
  // the row seat answers y
  float u[N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    float acc = mul(g.m[r][0], g.y[0]);
#pragma unroll
    for (int c = 1; c < N; ++c) acc = madd(g.m[r][c], g.y[c], acc);
    u[r] = acc;
  }
  float v = mul(g.x[0], u[0]);
#pragma unroll
  for (int r = 1; r < N; ++r) v = madd(g.x[r], u[r], v);
#pragma unroll
  for (int r = 0; r < N; ++r)
    g.qr[r] = fmaxf(__fmaf_rn(sub(u[r], v), g.lr[r], g.qr[r]), 0.f);
  normalize<N, Binary>(g.qr, g.lr, g.inv_nr, g.x);
  // the column seat answers the row seat's updated x
#pragma unroll
  for (int c = 0; c < N; ++c) {
    float acc = mul(g.m[0][c], g.x[0]);
#pragma unroll
    for (int r = 1; r < N; ++r) acc = madd(g.m[r][c], g.x[r], acc);
    u[c] = -acc;
  }
  v = mul(g.y[0], u[0]);
#pragma unroll
  for (int c = 1; c < N; ++c) v = madd(g.y[c], u[c], v);
#pragma unroll
  for (int c = 0; c < N; ++c)
    g.qc[c] = fmaxf(__fmaf_rn(sub(u[c], v), g.lc[c], g.qc[c]), 0.f);
  normalize<N, Binary>(g.qc, g.lc, g.inv_nc, g.y);
#pragma unroll
  for (int i = 0; i < N; ++i) {  // linear averaging
    g.xsum[i] = madd(w, g.x[i], g.xsum[i]);
    g.ysum[i] = madd(w, g.y[i], g.ysum[i]);
  }
}

// The loop, the averages' normalization and the value, written out.
template <int N, bool Binary>
__device__ __forceinline__ void solve(Game<N>& g, int iters,
                                      float* __restrict__ x_out,
                                      float* __restrict__ y_out,
                                      float* __restrict__ v_out, int64_t B,
                                      int64_t b, int R, int C) {
#pragma unroll 1
  for (int it = 0; it < iters; ++it) iterate<N, Binary>(g, (float)(it + 1));
  normalize<N, Binary>(g.xsum, g.lr, g.inv_nr, g.x);
  normalize<N, Binary>(g.ysum, g.lc, g.inv_nc, g.y);
  float val = mul(mul(g.x[0], g.m[0][0]), g.y[0]);
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int c = r == 0 ? 1 : 0; c < N; ++c)
      val = madd(mul(g.x[r], g.m[r][c]), g.y[c], val);
#pragma unroll
  for (int r = 0; r < N; ++r)
    if (r < R) x_out[r * B + b] = g.x[r];
#pragma unroll
  for (int c = 0; c < N; ++c)
    if (c < C) y_out[c * B + b] = g.y[c];
  v_out[b] = val;
}

template <int N>
__global__ void __launch_bounds__(kThreads)
rmplus_kernel(const float* __restrict__ M, const float* __restrict__ lr,
              const float* __restrict__ lc, float* __restrict__ x_out,
              float* __restrict__ y_out, float* __restrict__ v_out, int64_t B,
              int R, int C, int iters) {
  const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  Game<N> g;
  if (load(g, M, lr, lc, B, b, R, C))
    solve<N, true>(g, iters, x_out, y_out, v_out, B, b, R, C);
  else
    solve<N, false>(g, iters, x_out, y_out, v_out, B, b, R, C);
}

template <int N>
cudaError_t launch(const float* M, const float* lr, const float* lc, float* x,
                   float* y, float* v, int64_t B, int R, int C, int iters,
                   cudaStream_t stream) {
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  rmplus_kernel<N><<<(unsigned)blocks, kThreads, 0, stream>>>(
      M, lr, lc, x, y, v, B, R, C, iters);
  return cudaGetLastError();
}

}  // namespace

// Returns a CUDA error code (0 on success); cudaErrorInvalidValue when R or
// C is outside [1, 16] (the wrapper checks this first).
extern "C" int rnad_rmplus(const void* M, const void* lr, const void* lc,
                           void* x, void* y, void* v, int64_t B, int32_t R,
                           int32_t C, int32_t iters, void* stream) {
  if (B == 0) return 0;
  const int n = R > C ? R : C;
  const float* m_ = (const float*)M;
  const float* lr_ = (const float*)lr;
  const float* lc_ = (const float*)lc;
  float* x_ = (float*)x;
  float* y_ = (float*)y;
  float* v_ = (float*)v;
  cudaStream_t s = (cudaStream_t)stream;
  if (R < 1 || C < 1) return (int)cudaErrorInvalidValue;
  switch (n) {
#define RNAD_RMPLUS_CASE(K) \
  case K:                   \
    return (int)launch<K>(m_, lr_, lc_, x_, y_, v_, B, R, C, iters, s);
    RNAD_RMPLUS_CASE(1)
    RNAD_RMPLUS_CASE(2)
    RNAD_RMPLUS_CASE(3)
    RNAD_RMPLUS_CASE(4)
    RNAD_RMPLUS_CASE(5)
    RNAD_RMPLUS_CASE(6)
    RNAD_RMPLUS_CASE(7)
    RNAD_RMPLUS_CASE(8)
    RNAD_RMPLUS_CASE(9)
    RNAD_RMPLUS_CASE(10)
    RNAD_RMPLUS_CASE(11)
    RNAD_RMPLUS_CASE(12)
    RNAD_RMPLUS_CASE(13)
    RNAD_RMPLUS_CASE(14)
    RNAD_RMPLUS_CASE(15)
    RNAD_RMPLUS_CASE(16)
#undef RNAD_RMPLUS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* rnad_rmplus_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
