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
// Bound on the H100: operations.  Each (lane, seat) row needs din*H FMAs
// for the first layer and W*(A+1) for the second (W1 is block-diagonal:
// the policy half feeds the A logits, the value half the value), 10240 at
// A=3, W=256, against a few hundred bytes of row, noise and outputs, so the
// f32 CUDA-core rate bounds it.  The kernel computes the full W1 product,
// zeros included, as the TPU kernel does (ops/fused_turn.py::operations).
//
// Design: register tiling on the f32 CUDA cores.  Blocks of 256 threads
// stay resident and hold the weights in shared memory (zero-padded to whole
// unit blocks, which adds only exact zeros; W1 transposed), copied in with
// cp.async, all at once.  A block takes a tile of 32 lanes = 64 (lane,
// seat) rows and stages the tile's observations in shared memory, k-major,
// with its Gumbel noise and legality masks, by cp.async into one of two
// buffers: the next tile's copies are in flight while this tile reduces,
// runs its epilogue and its transition.  Each thread computes a register
// tile of 8 rows x 8 hidden units: one k step is 4 float4 shared-memory
// loads for 64 FMAs.  A warp's lanes are 4 row groups x 8 unit groups.
// Each hidden unit's sum over k runs in index order with fmaf, then +b0 and
// ReLU, in registers.  The second layer forms each thread's partial (8 rows
// x (A+1)) over its units.  A warp first sums its 8 unit groups' partials
// with shuffles (a fixed tree), so shared memory holds 4 partials an
// output, one per warp along the units, which each output then sums in a
// fixed order (no atomics: two runs are bitwise equal).
// The epilogue gives one thread to each row (mask, softmax, Gumbel-max,
// writes), then one thread to each lane (the transition); everything after
// the logits is exact, as before.  No tensor cores: TF32 would round the
// logits by ~1e-3, far outside the near-tie band that keeps episodes equal.
// The shared-memory attribute is set once per (device, A, operand type),
// to the most a block may opt in to, and the grid once per (device, A, H,
// operand type).
//
// The bf16-operand variant (the operand type W = __nv_bfloat16, a template
// parameter) computes what rnad_tpu's rows-actor does with
// compute_dtype=bfloat16 (rnad_tpu/env/engine.py::make_mlp_rows_actor): W0
// and W1 arrive cast to bf16 once, the gathered f32 row and the hidden
// activation are rounded to bf16 (round to nearest even), both products
// accumulate in f32 and the biases are added in f32.  W0 and W1 stay bf16
// in shared memory, half the bytes of the f32 variant, so wider nets fit;
// each thread rounds the row elements it staged once they land, and the
// k loop widens 4 bf16 weights a load to f32.  A product of two bf16
// values is exact in f32, so fmaf in index order leaves only the summation
// order between this and rnad_tpu (XLA's dot).  That is the design taken:
// mma.sync.m16n8k16 would reach the tensor cores, but its adds round in an
// order of the hardware's choosing, and it is left for a redesign that
// holds the same near-tie band.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <set>
#include <tuple>
#include <utility>

namespace {

constexpr int kMaxA = 8;
constexpr int kMaxT = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 64;              // (lane, seat) rows of a tile
constexpr int kTileLanes = kTileRows / 2;  // seat 0 rows, then seat 1
// A thread computes 8 rows x 8 hidden units.  A warp's lanes form
// kRowGroups groups of 8 rows times kUnitGroups groups of 8 units, so one
// k step reads kRowGroups distinct float4 pairs of observations and
// kUnitGroups of W0 (each unit group's two float4 columns kHalf apart).
constexpr int kRowGroups = 4;
constexpr int kUnitGroups = 32 / kRowGroups;
constexpr int kWarpRows = 8 * kRowGroups;
constexpr int kRowBlocks = kTileRows / kWarpRows;  // warps along the rows
constexpr int kUnitBlocks = kWarps / kRowBlocks;   // warps along the units
constexpr int kBlockUnits = 8 * kUnitGroups;       // a warp's units a pass
constexpr int kHalf = 4 * kUnitGroups;
constexpr int kUnitsPerPass = kUnitBlocks * kBlockUnits;
constexpr int kObsStride = kTileRows + 4;  // k-major, 16-byte rows
constexpr int kContrib = kUnitBlocks;  // partials of an output in s_red
constexpr float kNeg = -1e30f;

static_assert(kRowGroups * kUnitGroups == 32 && kUnitGroups == 8,
              "a warp's unit groups are lanes 4 apart: shuffles 16, 8, 4");
static_assert(kThreads == 4 * kTileRows, "4 threads stage each row");

// H rounded up to whole warp unit blocks (zero weights: exact +0 terms).
__host__ __device__ inline int padded_units(int H) {
  return (H + kBlockUnits - 1) / kBlockUnits * kBlockUnits;
}

__host__ __device__ inline int up4(int n) { return (n + 3) / 4 * 4; }

// Shared-memory layout in floats; every region starts 16-byte aligned.  A
// tile's staged inputs (observations, Gumbel noise, masks) have two
// buffers: the next tile's are copied in while this one finishes.  The
// weights take wbytes (4 for f32, 2 for bf16) an element; Hp is a multiple
// of 64, so their regions stay whole, aligned floats.
struct Layout {
  int w0, b0, w1t, b1, obs, red, out, gact, mask, act, total;
  int obs_size, rows_size;  // one buffer of s_obs; of s_gact and s_mask
  __host__ __device__ Layout(int A, int H, int wbytes) {
    const int din = 2 * A * A, nout = A + 1, Hp = padded_units(H);
    obs_size = up4(din * kObsStride);
    rows_size = up4(kTileRows * A);
    w0 = 0;                                   // (din, Hp) weights
    b0 = w0 + din * Hp * wbytes / 4;          // (Hp,) f32
    w1t = b0 + Hp;                            // (A+1, Hp) weights
    b1 = w1t + nout * Hp * wbytes / 4;        // (A+1,) f32
    obs = b1 + up4(nout);                     // 2 x (din, kObsStride)
    red = obs + 2 * obs_size;                 // (4, (A+1) x 64 + 1)
    out = red + up4(kContrib * (nout * kTileRows + 1));
    gact = out + up4(kTileRows * nout);       // (rows, A+1) logits, value
    mask = gact + 2 * rows_size;              // 2 x (rows, A)
    act = mask + 2 * rows_size;               // (rows,) int
    total = act + kTileRows;
  }
};

// One 4-byte asynchronous copy from device to shared memory (no register
// holds the value); copies_done() waits for all of this thread's copies.
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The operand type's helpers: a weight staged into shared memory (f32 by
// cp.async, bf16 by a plain load), zero, widened to f32, 4 widened at a
// time (16 or 8 aligned bytes), and an f32 value rounded to the operand
// type and back (the identity for f32).
__device__ __forceinline__ void stage_weight(float* dst, const float* src) {
  copy4(dst, src);
}
__device__ __forceinline__ void stage_weight(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src) {
  *dst = *src;
}
template <typename W>
__device__ __forceinline__ W zero_weight();
template <>
__device__ __forceinline__ float zero_weight<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero_weight<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float4 widen4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 widen4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);  // p[0] in v.x low
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}
template <typename W>
__device__ __forceinline__ float round_operand(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_operand<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <int A, typename W>
__global__ void __launch_bounds__(kThreads, A <= 4 ? 2 : 1)
fused_turn_kernel(const float* __restrict__ table, int32_t S, int32_t D,
                  const int32_t* __restrict__ idx,
                  const W* __restrict__ w0, const float* __restrict__ b0,
                  const W* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ g_act,
                  const float* __restrict__ g_ch, int32_t* __restrict__ new_idx,
                  float* __restrict__ policy, int32_t* __restrict__ actions,
                  float* __restrict__ rewards, float* __restrict__ values,
                  int32_t B, int32_t T, int32_t H) {
  constexpr int din = 2 * A * A;
  constexpr int nout = A + 1;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr bool kRound = sizeof(W) != sizeof(float);
  const Layout L(A, H, sizeof(W));
  const int Hp = padded_units(H);
  const int mask_off = 2 * din;
  const int trans_off = mask_off + 2 * A;
  W* s_w0 = reinterpret_cast<W*>(smem + L.w0);
  float* s_b0 = smem + L.b0;
  W* s_w1t = reinterpret_cast<W*>(smem + L.w1t);
  float* s_b1 = smem + L.b1;
  float* s_obs = smem + L.obs;
  float* s_out = smem + L.out;
  float* s_gact = smem + L.gact;
  float* s_mask = smem + L.mask;
  int* s_act = reinterpret_cast<int*>(smem + L.act);
  const int tid = threadIdx.x;

  // weights, zero-padded to Hp units, all copies in flight at once
  for (int k = 0; k < din; ++k)
    for (int u = tid; u < Hp; u += kThreads) {
      if (u < H) stage_weight(s_w0 + k * Hp + u, w0 + (int64_t)k * H + u);
      else s_w0[k * Hp + u] = zero_weight<W>();
    }
  for (int o = 0; o < nout; ++o)
    for (int u = tid; u < Hp; u += kThreads) {
      if (u < H) stage_weight(s_w1t + o * Hp + u, w1 + (int64_t)u * nout + o);
      else s_w1t[o * Hp + u] = zero_weight<W>();
    }
  for (int u = tid; u < Hp; u += kThreads) {
    if (u < H) copy4(s_b0 + u, b0 + u);
    else s_b0[u] = 0.f;
  }
  if (tid < nout) copy4(s_b1 + tid, b1 + tid);

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rg = lane % kRowGroups, ug = lane / kRowGroups;
  const int row0 = (warp % kRowBlocks) * kWarpRows + rg * 8;
  const int ublock = (warp / kRowBlocks) * kBlockUnits;
  const int contrib = warp / kRowBlocks;  // the warp's unit block
  constexpr int nred = nout * kTileRows;  // outputs of a tile
  float* s_red = smem + L.red;
  const int tiles = (B + kTileLanes - 1) / kTileLanes;

  // Staging: 4 threads copy each (lane, seat) row of a tile.  A thread's
  // row is the same in every tile, so it reads one state id per tile.
  const int srow = tid / 4, sq = tid % 4;
  const int sseat = srow / kTileLanes, slane = srow % kTileLanes;
  const auto state = [&](int b) {  // lane b's state id, clamped to [0, S)
    const int s = __ldg(idx + b);
    return s < 0 ? 0 : (s >= S ? S - 1 : s);
  };
  const auto state_of = [&](int tile) {  // -1: no such lane
    const int b = tile * kTileLanes + slane;
    return tile >= tiles || b >= B ? -1 : state(b);
  };
  const auto stage = [&](int tile, int buf, int s) {
    float* obs = s_obs + buf * L.obs_size;
    float* gact = s_gact + buf * L.rows_size;
    float* mask = s_mask + buf * L.rows_size;
    if (s < 0) {
      for (int k = sq; k < din; k += 4) obs[k * kObsStride + srow] = 0.f;
      for (int a = sq; a < A; a += 4) gact[srow * A + a] = mask[srow * A + a] = 0.f;
      return;
    }
    const int b = tile * kTileLanes + slane;
    const float* row = table + (int64_t)s * D;
    for (int k = sq; k < din; k += 4)
      copy4(obs + k * kObsStride + srow, row + sseat * din + k);
    for (int a = sq; a < A; a += 4) {
      copy4(gact + srow * A + a, g_act + ((int64_t)sseat * B + b) * A + a);
      copy4(mask + srow * A + a, row + mask_off + sseat * A + a);
    }
  };

  int buf = 0;
  stage(blockIdx.x, 0, state_of(blockIdx.x));
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, buf ^= 1) {
    const int lane0 = tile * kTileLanes;
    const int next_state = state_of(tile + gridDim.x);  // in flight meanwhile
    copies_done();
    if (kRound) {  // the row elements this thread staged, rounded
      float* obs = s_obs + buf * L.obs_size;
      for (int k = sq; k < din; k += 4)
        obs[k * kObsStride + srow] =
            round_operand<W>(obs[k * kObsStride + srow]);
    }
    __syncthreads();  // this tile's inputs (and the weights) have landed
    const float* t_obs = s_obs + buf * L.obs_size;
    const float* t_gact = s_gact + buf * L.rows_size;
    const float* t_mask = s_mask + buf * L.rows_size;

    // -- both layers on a register tile of 8 rows x 8 units --------------
    float part[8][nout];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int o = 0; o < nout; ++o) part[r][o] = 0.f;
    for (int base = ublock; base < Hp; base += kUnitsPerPass) {
      const int u0 = base + ug * 4;  // units u0..u0+3, u0+kHalf..u0+kHalf+3
      float acc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
#pragma unroll 6
      for (int k = 0; k < din; ++k) {
        const float* ok = t_obs + k * kObsStride + row0;
        const float4 oa = *reinterpret_cast<const float4*>(ok);
        const float4 ob = *reinterpret_cast<const float4*>(ok + 4);
        const W* wk = s_w0 + k * Hp + u0;
        const float4 wa = widen4(wk);
        const float4 wb = widen4(wk + kHalf);
        const float o[8] = {oa.x, oa.y, oa.z, oa.w, ob.x, ob.y, ob.z, ob.w};
        const float w[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(o[r], w[j], acc[r][j]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int u = u0 + (j < 4 ? j : kHalf + j - 4);
        const float bias = s_b0[u];
        float w1u[nout];
#pragma unroll
        for (int o = 0; o < nout; ++o) w1u[o] = widen(s_w1t[o * Hp + u]);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float h = round_operand<W>(fmaxf(acc[r][j] + bias, 0.f));
#pragma unroll
          for (int o = 0; o < nout; ++o) part[r][o] = fmaf(h, w1u[o], part[r][o]);
        }
      }
    }
    // the next tile's inputs go to the other buffers, whose last readers
    // (the previous tile's compute and epilogue) are past the barrier above
    stage(tile + gridDim.x, buf ^ 1, next_state);
    // the warp's 8 unit groups (lanes 4 apart) sum by shuffles, then each
    // output sums the 4 warps' partials in unit-block order (no atomics,
    // the same order every run)
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int o = 0; o < nout; ++o) {
        float v = part[r][o];
#pragma unroll
        for (int off = 16; off >= 4; off >>= 1)
          v += __shfl_down_sync(0xffffffffu, v, off);
        if (ug == 0) s_red[contrib * (nred + 1) + o * kTileRows + row0 + r] = v;
      }
    __syncthreads();
    for (int p = tid; p < nred; p += kThreads) {
      float sum = s_red[p];
#pragma unroll
      for (int c = 1; c < kContrib; ++c) sum += s_red[c * (nred + 1) + p];
      const int o = p / kTileRows, r = p - o * kTileRows;
      s_out[r * nout + o] = sum + s_b1[o];
    }
    __syncthreads();

    // -- epilogue: one thread per (lane, seat) row ------------------------
    if (tid < kTileRows) {
      const int r = tid, seat = r / kTileLanes;
      const int b = lane0 + r % kTileLanes;
      if (b < B) {
        const int slot = seat * B + b;
        const float* out = s_out + r * nout;
        float ml[A];
        bool legal[A];
        float mx = kNeg;
#pragma unroll
        for (int a = 0; a < A; ++a) {
          legal[a] = t_mask[r * A + a] > 0.f;
          ml[a] = legal[a] ? out[a] : kNeg;
          mx = fmaxf(mx, ml[a]);
        }
        float e[A];
        float sum = 0.f;
#pragma unroll
        for (int a = 0; a < A; ++a) {
          e[a] = expf(ml[a] - mx);
          sum += e[a];
        }
        int best = 0;
        float best_score = ml[0] + t_gact[r * A];
#pragma unroll
        for (int a = 0; a < A; ++a) {
          policy[(int64_t)slot * A + a] = legal[a] ? e[a] / sum : 0.f;
          if (a > 0) {
            const float score = ml[a] + t_gact[r * A + a];
            if (score > best_score) {
              best_score = score;
              best = a;
            }
          }
        }
        actions[slot] = best;
        values[slot] = out[A];
        s_act[r] = best;
      }
    }
    __syncthreads();
    // -- transition: one thread per lane ----------------------------------
    if (tid < kTileLanes) {
      const int b = lane0 + tid;
      if (b < B) {
        const int cell = s_act[tid] * A + s_act[tid + kTileLanes];
        const float* trip =
            table + (int64_t)state(b) * D + trans_off + cell * 3 * T;
        const float* g = g_ch + (int64_t)b * T;
        int tc = 0;
        float best_score = trip[0] + g[0];
        for (int t = 1; t < T; ++t) {
          const float score = trip[t] + g[t];
          if (score > best_score) {
            best_score = score;
            tc = t;
          }
        }
        const int child = (int)trip[T + tc];
        new_idx[b] = child;
        rewards[b] = child == 0 ? trip[2 * T + tc] : 0.f;
      }
    }
    // The next tile rewrites s_red and s_out only after its first barrier,
    // which this tile's readers of them have passed, and s_act after three.
  }
}

// Launch settings, set once: the shared-memory attribute of
// fused_turn_kernel<A, W> on a device at the most a block may opt in to (it
// belongs to the kernel, whatever H), and the grid of each (device, A, H,
// W).
std::mutex cache_mutex;
std::set<std::tuple<int, int, int>> smem_set;
std::map<std::tuple<int, int, int, int>, int> grid_cache;

template <int A, typename W>
cudaError_t launch(const float* table, int32_t S, int32_t D,
                   const int32_t* idx, const W* w0, const float* b0,
                   const W* w1, const float* b1, const float* g_act,
                   const float* g_ch, int32_t* new_idx, float* policy,
                   int32_t* actions, float* rewards, float* values, int32_t B,
                   int32_t T, int32_t H, cudaStream_t stream) {
  const int wbytes = (int)sizeof(W);
  const size_t smem = (size_t)Layout(A, H, wbytes).total * sizeof(float);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  {
    std::lock_guard<std::mutex> lock(cache_mutex);
    if (!smem_set.count(std::make_tuple(device, A, wbytes))) {
      int optin = 0;
      if ((err = cudaDeviceGetAttribute(
               &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
          cudaSuccess)
        return err;
      if ((err = cudaFuncSetAttribute(
               fused_turn_kernel<A, W>,
               cudaFuncAttributeMaxDynamicSharedMemorySize, optin)) !=
          cudaSuccess)
        return err;
      smem_set.insert(std::make_tuple(device, A, wbytes));
    }
    const auto key = std::make_tuple(device, A, H, wbytes);
    auto found = grid_cache.find(key);
    if (found != grid_cache.end()) {
      blocks = found->second;
    } else {
      int sms = 0, per_sm = 0;
      if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        device)) != cudaSuccess)
        return err;
      if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, fused_turn_kernel<A, W>, kThreads, smem)) !=
          cudaSuccess)
        return err;
      if (per_sm < 1) return cudaErrorInvalidConfiguration;
      blocks = sms * per_sm;
      grid_cache[key] = blocks;
    }
  }
  const int64_t tiles = ((int64_t)B + kTileLanes - 1) / kTileLanes;
  const unsigned grid = (unsigned)(tiles < blocks ? tiles : blocks);
  fused_turn_kernel<A, W><<<grid, kThreads, smem, stream>>>(
      table, S, D, idx, w0, b0, w1, b1, g_act, g_ch, new_idx, policy, actions,
      rewards, values, B, T, H);
  return cudaGetLastError();
}

}  // namespace

// bf16: 0 for f32 weights, 1 for bf16 weights (the bf16-operand variant).
extern "C" size_t rnad_fused_turn_smem_bytes(int32_t A, int32_t H,
                                             int32_t bf16) {
  return (size_t)Layout(A, H, bf16 ? 2 : 4).total * sizeof(float);
}

extern "C" int rnad_fused_turn(const void* table, int32_t S, int32_t D,
                               const void* idx, const void* w0,
                               const void* b0, const void* w1, const void* b1,
                               const void* g_act, const void* g_ch,
                               void* new_idx, void* policy, void* actions,
                               void* rewards, void* values, int32_t B,
                               int32_t A, int32_t T, int32_t H, int32_t bf16,
                               void* stream) {
  if (A < 1 || A > kMaxA || T < 1 || T > kMaxT || H < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  switch (A) {
#define RNAD_FUSED_TURN_LAUNCH(K, W)                                        \
  launch<K, W>((const float*)table, S, D, (const int32_t*)idx,              \
               (const W*)w0, (const float*)b0, (const W*)w1,                \
               (const float*)b1, (const float*)g_act, (const float*)g_ch,   \
               (int32_t*)new_idx, (float*)policy, (int32_t*)actions,        \
               (float*)rewards, (float*)values, B, T, H,                    \
               (cudaStream_t)stream)
#define RNAD_FUSED_TURN_CASE(K)                                             \
  case K:                                                                   \
    return (int)(bf16 ? RNAD_FUSED_TURN_LAUNCH(K, __nv_bfloat16)            \
                      : RNAD_FUSED_TURN_LAUNCH(K, float));
    RNAD_FUSED_TURN_CASE(1)
    RNAD_FUSED_TURN_CASE(2)
    RNAD_FUSED_TURN_CASE(3)
    RNAD_FUSED_TURN_CASE(4)
    RNAD_FUSED_TURN_CASE(5)
    RNAD_FUSED_TURN_CASE(6)
    RNAD_FUSED_TURN_CASE(7)
    RNAD_FUSED_TURN_CASE(8)
#undef RNAD_FUSED_TURN_CASE
#undef RNAD_FUSED_TURN_LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* rnad_fused_turn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
