// One whole rollout turn for every lane, fused into one kernel.
//
// Replaces: rnad_tpu/ops/pallas_turn.py, `_turn_kernel` (called by
// `fused_turn`, driven by `rollout_fused`).  Per lane: read the lane's row
// of the packed state table; for each seat run the fused two-head MLP
// (W0 (din, H) -> +b0 -> ReLU -> W1 (H, A+1) -> +b1, din = 2A^2, H = 2W),
// the masked softmax (illegal logits -1e30) and the Gumbel-max action; then
// select the chosen joint cell's [log_chance | child | value] triple, draw
// the chance outcome by Gumbel-max, decode the child id from its f32 lane
// (exact, S < 2^24) and emit the reward only on entering state 0.  The
// Gumbel noise is an input, as it is for the TPU kernel.  Argmax ties go to
// the lowest index (an upward scan with a strict `>`), as jnp.argmax does.
//
// The TPU kernel's one-hot MXU row lookup and its comb matmul for the cell
// select existed only because a TPU core cannot gather; here the row is
// read directly and the cell is indexed directly.
//
// Bound on the H100: operations.  Each (lane, seat) does din*H + H*(A+1)
// FMAs (11264 at A=3, W=256), against a few hundred bytes of row, noise and
// outputs, so the f32 CUDA-core rate bounds it, not memory.
//
// Design (simple first): the weights live in shared memory (W1 stored
// transposed so that neighbouring lanes read neighbouring words), loaded
// once per block; blocks stay resident and stride over the lanes.  One warp
// serves one (lane, seat): its 32 threads split the H hidden units, each
// accumulates its share of the A+1 outputs with plain f32 FMAs, and a
// shuffle butterfly sums them.  The two warps of a lane meet in shared
// memory for the transition.  Every shared-memory weight read feeds one
// FMA, so shared-memory bandwidth, a quarter of the FMA rate, is what this
// design will hit first; reusing each weight read for several lanes is the
// next step.  No tensor cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxA = 8;
constexpr int kMaxT = 8;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;

__host__ __device__ inline size_t smem_floats(int A, int H) {
  const int din = 2 * A * A;
  const int nout = A + 1;
  return (size_t)din * H + H + (size_t)nout * H + nout + (size_t)kWarps * din +
         kWarps;
}

__global__ void __launch_bounds__(kThreads)
fused_turn_kernel(const float* __restrict__ table, int32_t S, int32_t D,
                  const int32_t* __restrict__ idx,
                  const float* __restrict__ w0, const float* __restrict__ b0,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ g_act,
                  const float* __restrict__ g_ch, int32_t* __restrict__ new_idx,
                  float* __restrict__ policy, int32_t* __restrict__ actions,
                  float* __restrict__ rewards, float* __restrict__ values,
                  int32_t B, int32_t A, int32_t T, int32_t H) {
  extern __shared__ float smem[];
  const int din = 2 * A * A;
  const int nout = A + 1;
  const int mask_off = 2 * din;
  const int trans_off = mask_off + 2 * A;
  float* s_w0 = smem;                       // (din, H)
  float* s_b0 = s_w0 + (size_t)din * H;     // (H,)
  float* s_w1t = s_b0 + H;                  // (A+1, H), W1 transposed
  float* s_b1 = s_w1t + (size_t)nout * H;   // (A+1,)
  float* s_obs = s_b1 + nout;               // (warps, din)
  int* s_act = (int*)(s_obs + kWarps * din);  // (warps,)

  for (int i = threadIdx.x; i < din * H; i += blockDim.x) s_w0[i] = w0[i];
  for (int i = threadIdx.x; i < H; i += blockDim.x) s_b0[i] = b0[i];
  for (int i = threadIdx.x; i < H * nout; i += blockDim.x) {
    const int u = i / nout, o = i - u * nout;
    s_w1t[o * H + u] = w1[i];
  }
  for (int i = threadIdx.x; i < nout; i += blockDim.x) s_b1[i] = b1[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int seat = warp & 1;
  const int lanes_per_block = kWarps / 2;
  float* obs = s_obs + warp * din;

  for (int base = blockIdx.x * lanes_per_block; base < B;
       base += gridDim.x * lanes_per_block) {
    const int b = base + (warp >> 1);
    const bool active = b < B;
    const float* row = nullptr;
    if (active) {
      int s = idx[b];
      s = s < 0 ? 0 : (s >= S ? S - 1 : s);
      row = table + (int64_t)s * D;
      for (int k = lane; k < din; k += 32) obs[k] = row[seat * din + k];
      __syncwarp();

      float part[kMaxA + 1];
#pragma unroll
      for (int o = 0; o <= kMaxA; ++o) part[o] = 0.f;
      for (int u = lane; u < H; u += 32) {
        float h = 0.f;
        for (int k = 0; k < din; ++k) h = fmaf(obs[k], s_w0[k * H + u], h);
        h = fmaxf(h + s_b0[u], 0.f);
#pragma unroll
        for (int o = 0; o <= kMaxA; ++o)
          if (o < nout) part[o] = fmaf(h, s_w1t[o * H + u], part[o]);
      }
#pragma unroll
      for (int o = 0; o <= kMaxA; ++o) {
        if (o < nout) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            part[o] += __shfl_xor_sync(0xffffffffu, part[o], off);
        }
      }

      if (lane == 0) {
        const int slot = seat * B + b;
        float ml[kMaxA];
        float mx = kNeg;
        bool legal[kMaxA];
#pragma unroll
        for (int a = 0; a < kMaxA; ++a) {
          if (a < A) {
            legal[a] = row[mask_off + seat * A + a] > 0.f;
            ml[a] = legal[a] ? part[a] + s_b1[a] : kNeg;
            mx = fmaxf(mx, ml[a]);
          }
        }
        float e[kMaxA];
        float sum = 0.f;
#pragma unroll
        for (int a = 0; a < kMaxA; ++a) {
          if (a < A) {
            e[a] = expf(ml[a] - mx);
            sum += e[a];
          }
        }
        int best = 0;
        float best_score = ml[0] + g_act[(int64_t)slot * A];
#pragma unroll
        for (int a = 0; a < kMaxA; ++a) {
          if (a < A) {
            policy[(int64_t)slot * A + a] = legal[a] ? e[a] / sum : 0.f;
            if (a > 0) {
              const float score = ml[a] + g_act[(int64_t)slot * A + a];
              if (score > best_score) {
                best_score = score;
                best = a;
              }
            }
          }
        }
        actions[slot] = best;
        values[slot] = part[A] + s_b1[A];
        s_act[warp] = best;
      }
    }
    __syncthreads();
    if (active && seat == 0 && lane == 0) {
      const int cell = s_act[warp] * A + s_act[warp + 1];
      const float* trip = row + trans_off + cell * 3 * T;
      int tc = 0;
      float best_score = trip[0] + g_ch[(int64_t)b * T];
      for (int t = 1; t < T; ++t) {
        const float score = trip[t] + g_ch[(int64_t)b * T + t];
        if (score > best_score) {
          best_score = score;
          tc = t;
        }
      }
      const int child = (int)trip[T + tc];
      new_idx[b] = child;
      rewards[b] = child == 0 ? trip[2 * T + tc] : 0.f;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" size_t rnad_fused_turn_smem_bytes(int32_t A, int32_t H) {
  return smem_floats(A, H) * sizeof(float);
}

extern "C" int rnad_fused_turn(const void* table, int32_t S, int32_t D,
                               const void* idx, const void* w0,
                               const void* b0, const void* w1, const void* b1,
                               const void* g_act, const void* g_ch,
                               void* new_idx, void* policy, void* actions,
                               void* rewards, void* values, int32_t B,
                               int32_t A, int32_t T, int32_t H, void* stream) {
  if (A < 1 || A > kMaxA || T < 1 || T > kMaxT || H < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = rnad_fused_turn_smem_bytes(A, H);
  cudaError_t err = cudaFuncSetAttribute(
      fused_turn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_turn_kernel, kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int lanes_per_block = kWarps / 2;
  int64_t blocks = ((int64_t)B + lanes_per_block - 1) / lanes_per_block;
  if (blocks > (int64_t)sms * per_sm) blocks = (int64_t)sms * per_sm;
  fused_turn_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)table, S, D, (const int32_t*)idx, (const float*)w0,
      (const float*)b0, (const float*)w1, (const float*)b1,
      (const float*)g_act, (const float*)g_ch, (int32_t*)new_idx,
      (float*)policy, (int32_t*)actions, (float*)rewards, (float*)values, B,
      A, T, H);
  return (int)cudaGetLastError();
}

extern "C" const char* rnad_fused_turn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
