// Batched alternating RM+ (CFR+) for zero-sum matrix games, batch-minor.
//
// Replaces: rnad_tpu/ops/pallas_rmplus.py, `_kernel` (called by `rmplus`),
// whose body is rnad_tpu/env/solver_device.py::rmplus_core.  Inputs are
// M (R, C, B) payoffs with illegal cells zeroed, lr (R, B) and lc (C, B)
// legality masks; outputs are the linear-averaged strategies x (R, B),
// y (C, B) and their bilinear value v (B,), all float32.
//
// Bound on the H100: operations.  A game's loop does about
// 4RC + 12R + 13C + 3 operations per iteration (ops/rmplus.py::operations
// counts them) on a constant (R, C) block, so at A = 5 and 128 iterations
// the learner's 327,680 games are ~9.6 GFLOP against ~60 MB of traffic.
//
// Design: one thread per game.  The payoff block (R and C padded to the
// template size N, with zero payoffs and zero legality, which adds only
// exact +0 terms) and the four carries qr, qc, xsum, ysum stay in registers
// for the whole loop, so device memory sees one read of M and the masks and
// one write of x, y and v, whatever `iters` is.  Thread b reads element b of
// every batch-minor row, so each warp's loads and stores are coalesced.
// Every dot product is summed in index order, and products and sums are
// rounded one by one (__fmul_rn / __fadd_rn: no FMA contraction), so the
// kernel follows its plain version's arithmetic closely.  The strategy that
// `normalize(qc, lc)` gives at the top of an iteration is the one the
// previous iteration ended with (qc has not changed in between), so it is
// carried instead of recomputed; likewise normalize(qr, lr).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// rmplus_core's normalize: q * legal / max(sum, 1e-30) where the sum is
// positive, else the uniform strategy over the legal actions.
template <int N>
__device__ __forceinline__ void normalize(const float (&q)[N],
                                          const float (&legal)[N],
                                          const float (&uniform)[N],
                                          float (&out)[N]) {
  float ql[N];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    ql[i] = mul(q[i], legal[i]);
    s = add(s, ql[i]);
  }
  const float d = fmaxf(s, 1e-30f);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = s > 0.f ? __fdiv_rn(ql[i], d) : uniform[i];
}

template <int N>
__device__ __forceinline__ void uniform_of(const float (&legal)[N],
                                           float (&out)[N]) {
  float n = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) n = add(n, legal[i]);
  const float d = fmaxf(n, 1.f);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = __fdiv_rn(legal[i], d);
}

template <int N>
__global__ void __launch_bounds__(128)
rmplus_kernel(const float* __restrict__ M, const float* __restrict__ lr_in,
              const float* __restrict__ lc_in, float* __restrict__ x_out,
              float* __restrict__ y_out, float* __restrict__ v_out, int64_t B,
              int R, int C, int iters) {
  const int64_t b = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (b >= B) return;

  float m[N][N], lr[N], lc[N];
#pragma unroll
  for (int r = 0; r < N; ++r) {
    lr[r] = r < R ? lr_in[r * B + b] : 0.f;
#pragma unroll
    for (int c = 0; c < N; ++c)
      m[r][c] = (r < R && c < C) ? M[((int64_t)r * C + c) * B + b] : 0.f;
  }
#pragma unroll
  for (int c = 0; c < N; ++c) lc[c] = c < C ? lc_in[c * B + b] : 0.f;

  float unif_r[N], unif_c[N];
  uniform_of(lr, unif_r);
  uniform_of(lc, unif_c);
  // zero regrets normalize to the uniform strategies
  float qr[N], qc[N], xsum[N], ysum[N], x[N], y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    qr[i] = qc[i] = xsum[i] = ysum[i] = 0.f;
    x[i] = unif_r[i];
    y[i] = unif_c[i];
  }

  for (int it = 0; it < iters; ++it) {
    // the row seat answers y
    float u[N];
#pragma unroll
    for (int r = 0; r < N; ++r) {
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < N; ++c) acc = add(acc, mul(m[r][c], y[c]));
      u[r] = acc;
    }
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < N; ++r) v = add(v, mul(x[r], u[r]));
#pragma unroll
    for (int r = 0; r < N; ++r)
      qr[r] = fmaxf(add(qr[r], mul(sub(u[r], v), lr[r])), 0.f);
    normalize(qr, lr, unif_r, x);
    // the column seat answers the row seat's updated x
#pragma unroll
    for (int c = 0; c < N; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < N; ++r) acc = add(acc, mul(m[r][c], x[r]));
      u[c] = -acc;
    }
    v = 0.f;
#pragma unroll
    for (int c = 0; c < N; ++c) v = add(v, mul(y[c], u[c]));
#pragma unroll
    for (int c = 0; c < N; ++c)
      qc[c] = fmaxf(add(qc[c], mul(sub(u[c], v), lc[c])), 0.f);
    normalize(qc, lc, unif_c, y);
    const float w = (float)(it + 1);  // linear averaging
#pragma unroll
    for (int i = 0; i < N; ++i) {
      xsum[i] = add(xsum[i], mul(w, x[i]));
      ysum[i] = add(ysum[i], mul(w, y[i]));
    }
  }

  normalize(xsum, lr, unif_r, x);
  normalize(ysum, lc, unif_c, y);
  float val = 0.f;
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int c = 0; c < N; ++c) val = add(val, mul(mul(x[r], m[r][c]), y[c]));
#pragma unroll
  for (int r = 0; r < N; ++r)
    if (r < R) x_out[r * B + b] = x[r];
#pragma unroll
  for (int c = 0; c < N; ++c)
    if (c < C) y_out[c * B + b] = y[c];
  v_out[b] = val;
}

template <int N>
cudaError_t launch(const float* M, const float* lr, const float* lc, float* x,
                   float* y, float* v, int64_t B, int R, int C, int iters,
                   cudaStream_t stream) {
  const int threads = 128;
  const int64_t blocks = (B + threads - 1) / threads;
  rmplus_kernel<N><<<(unsigned)blocks, threads, 0, stream>>>(
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
