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
// The stored observations (rnad_tpu's rollout with store_obs=True, where the
// rows-actor stores the mover's views "where the rows are already in
// registers"): an optional output obs (2, B, din) f32, seat-major, each
// lane's two seat views rows[0:din] and rows[din:2 din] of its packed row.
// Both variants write it from the tile's shared-memory stage right after
// the barrier that says the stage has landed, before that buffer is staged
// again two tiles later; a plain copy, so it is bitwise the packed row.  A
// null pointer skips it, and the launch then computes what it did without
// the output.  It adds 8 din bytes a lane to the bytes the turn must move.
//
// The bf16-operand variant, fused_turn_bf16_kernel, computes what
// rnad_tpu's rows-actor does with compute_dtype=bfloat16
// (rnad_tpu/env/engine.py::make_mlp_rows_actor): W0 and W1 arrive cast to
// bf16 once, the gathered f32 row and the hidden activation are rounded to
// bf16 (round to nearest even), both products accumulate in f32 from 0 and
// the biases are added in f32 after the sums.  Its bound is the tensor
// cores' bf16 rate, so its first layer runs on them: mma.sync.m16n8k16
// (bf16 operands, f32 accumulators) rather than wgmma.  The whole product
// of a tile is 64 x Kp x Hp with Kp = din rounded up to 16 (32 at A = 3, 64
// at A = 5): about 2 us of work at the dense bf16 rate for a whole turn
// at 32768 lanes (A = 3), less than a launch takes, so wgmma's asynchrony and its
// descriptors buy nothing that mma.sync cannot reach, and mma.sync keeps
// the accumulators in the per-thread layout the second layer reads.
// The weights are copied into shared memory by cp.async, all at once, as
// the f32 variant's are: W0 in its own (k, unit) layout, rows zero-padded
// to Kp (and to whole 32-unit blocks), each row 16 bytes longer than its
// units so that ldmatrix.trans, which turns eight (k, 8 units) rows into
// the k-major B fragments, reads them without a bank conflict; W1 as
// (unit, A+1).  Each tile's row, staged in f32 by cp.async into one of
// two buffers as in the f32 variant, is rounded to bf16 pairs by the
// threads that staged it and written in A-fragment order (one 16-byte
// load a lane an instruction), with explicit zeros for k >= din (the
// columns after din in the packed row are the other seat's observation
// and the masks, never read).  A warp takes 32 rows (2 m-tiles) and 32
// units (4 n-tiles) a pass, Kp / 16 mma steps deep.  The second layer
// stays on the CUDA cores in a fixed order: each thread takes the 8 units
// its accumulator fragments hold, adds b0, applies ReLU and rounds to bf16
// (one cvt.rn.relu.bf16x2 a pair) and multiplies into its 4 rows' (A+1)
// partials (the whole W1, zeros included, so any W1 is right); lanes that
// share rows sum by two xor shuffles and the 4 warps along the units by
// the f32 variant's fixed shared-memory order.  The epilogue and the
// transition are the f32 variant's.  The first layer's sums round as the
// tensor cores round, which NVIDIA does not document: ops/fused_turn.py::
// bf16_band states the model taken and holds the kernel to it.

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
// The bf16 variant: a warp takes 32 rows (2 m-tiles of 16) and 32 units (4
// n-tiles of 8) a pass, so the warps stand as in the f32 variant, kRowBlocks
// along the rows and kUnitBlocks (kContrib) along the units.
constexpr int kMmaK = 16;     // mma.sync.m16n8k16
constexpr int kWarpUnits = 32;
constexpr int kMmaUnitsPerPass = kUnitBlocks * kWarpUnits;

static_assert(kRowGroups * kUnitGroups == 32 && kUnitGroups == 8,
              "a warp's unit groups are lanes 4 apart: shuffles 16, 8, 4");
static_assert(kThreads == 4 * kTileRows, "4 threads stage each row");
static_assert(kRowBlocks * 32 == kTileRows, "a bf16 warp takes 32 rows");

// H rounded up to whole warp unit blocks (zero weights: exact +0 terms).
__host__ __device__ inline int padded_units(int H) {
  return (H + kBlockUnits - 1) / kBlockUnits * kBlockUnits;
}

__host__ __device__ inline int up4(int n) { return (n + 3) / 4 * 4; }

// Shared-memory layout in floats; every region starts 16-byte aligned.  A
// tile's staged inputs (observations, Gumbel noise, masks) have two
// buffers: the next tile's are copied in while this one finishes.
struct Layout {
  int w0, b0, w1t, b1, obs, red, out, gact, mask, act, total;
  int obs_size, rows_size;  // one buffer of s_obs; of s_gact and s_mask
  __host__ __device__ Layout(int A, int H) {
    const int din = 2 * A * A, nout = A + 1, Hp = padded_units(H);
    obs_size = up4(din * kObsStride);
    rows_size = up4(kTileRows * A);
    w0 = 0;                                   // (din, Hp)
    b0 = w0 + din * Hp;                       // (Hp,)
    w1t = b0 + Hp;                            // (A+1, Hp)
    b1 = w1t + nout * Hp;                     // (A+1,)
    obs = b1 + up4(nout);                     // 2 x (din, kObsStride)
    red = obs + 2 * obs_size;                 // (4, (A+1) x 64 + 1)
    out = red + up4(kContrib * (nout * kTileRows + 1));
    gact = out + up4(kTileRows * nout);       // (rows, A+1) logits, value
    mask = gact + 2 * rows_size;              // 2 x (rows, A)
    act = mask + 2 * rows_size;               // (rows,) int
    total = act + kTileRows;
  }
};

// The bf16 variant: din rounded up to the mma's depth, H to whole 32-unit
// warp blocks (zero weights: exact +0 terms).
__host__ __device__ inline int padded_depth(int din) {
  return (din + kMmaK - 1) / kMmaK * kMmaK;
}
__host__ __device__ inline int padded_units_mma(int H) {
  return (H + kWarpUnits - 1) / kWarpUnits * kWarpUnits;
}

// The bf16 variant's layout in 4-byte words, every region 16-byte
// aligned.  W0 keeps its own layout, (k, unit) rows of Hp + 8 bf16 (the 8
// shift each row by 16 bytes, so ldmatrix's 8 rows hit 8 different bank
// groups), Kp rows; W1 its own (unit, A+1).  The row tile is bf16 pairs in
// A-fragment order.  The f32 staging of the rows has two buffers, the
// bf16 row tile one (it is rewritten only after the barrier that ends the
// previous tile's products).
struct LayoutBf16 {
  int w0, w1, b0, b1, xs, obs, red, out, gact, mask, act, total;
  int w0_row, obs_size, rows_size;
  __host__ __device__ LayoutBf16(int A, int H) {
    const int din = 2 * A * A, nout = A + 1, Hp = padded_units_mma(H);
    const int Kp = padded_depth(din);
    w0_row = Hp / 2 + 4;
    obs_size = up4(kTileRows * din);
    rows_size = up4(kTileRows * A);
    w0 = 0;                                 // (Kp, Hp + 8) bf16
    w1 = w0 + Kp * w0_row;                  // (Hp, A+1) bf16
    b0 = w1 + up4(Hp * nout / 2);           // (Hp,) f32
    b1 = b0 + Hp;                           // (A+1,) f32
    xs = b1 + up4(nout);                    // (4, Kp/16, 32, 4) A frags
    obs = xs + kTileRows * Kp / 2;          // 2 x (rows, din) f32
    red = obs + 2 * obs_size;               // (4, (A+1) x 64 + 1)
    out = red + up4(kContrib * (nout * kTileRows + 1));
    gact = out + up4(kTileRows * nout);
    mask = gact + 2 * rows_size;
    act = mask + 2 * rows_size;
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

// lane b's state id, clamped to [0, S)
__device__ __forceinline__ int clamped_state(const int32_t* idx, int b,
                                             int32_t S) {
  const int s = __ldg(idx + b);
  return s < 0 ? 0 : (s >= S ? S - 1 : s);
}

// Two bf16 values as one mma operand register, lo in the low half (the
// lower k index).
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// The B fragments of two neighbouring 16 x 8 tiles of a row-major (k, n)
// bf16 matrix in shared memory, transposed on the way: lane l gives the
// address of row k0 + l % 16, columns n0 + 8 (l / 16) .. + 7; b[0], b[1]
// are the tile at n0, b[2], b[3] the tile at n0 + 8.
__device__ __forceinline__ void load_b_pair(uint32_t (&b)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(a));
}

// d += a b for one 16 x 8 tile: a (16 x 16, row-major A fragment), b (16 x 8,
// B fragment), d (16 x 8 f32 accumulator fragment).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// relu(hi), relu(lo) rounded to bf16 (to nearest even) and packed, hi in
// the high half; round and relu commute.
__device__ __forceinline__ uint32_t relu_bf16x2(float hi, float lo) {
  uint32_t d;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// W1's row of unit u, (A+1) bf16 values, widened to f32.
template <int nout>
__device__ __forceinline__ void w1_row(float (&w)[nout],
                                       const __nv_bfloat16* s_w1, int u) {
  if (nout % 2 == 0) {  // u nout is even: whole 4-byte pairs
    const uint32_t* p = reinterpret_cast<const uint32_t*>(s_w1 + u * nout);
#pragma unroll
    for (int o = 0; o < nout; o += 2) {
      const uint32_t v = p[o / 2];
      w[o] = __uint_as_float(v << 16);
      w[o + 1] = __uint_as_float(v & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int o = 0; o < nout; ++o) w[o] = __bfloat162float(s_w1[u * nout + o]);
  }
}

// The end of a tile, the same in both variants.  Each output sums the
// kContrib partials in s_red in unit-block order (no atomics, the same
// order every run) and adds b1; then one thread per (lane, seat) row
// (mask, softmax, Gumbel-max, writes) and one per lane (the transition).
// Everything after the logits is exact.
template <int A>
__device__ __forceinline__ void finish_tile(
    const float* s_red, float* s_out, const float* s_b1, const float* t_gact,
    const float* t_mask, int* s_act, const float* __restrict__ table,
    int32_t S, int32_t D, const int32_t* __restrict__ idx,
    const float* __restrict__ g_ch, int32_t* __restrict__ new_idx,
    float* __restrict__ policy, int32_t* __restrict__ actions,
    float* __restrict__ rewards, float* __restrict__ values, int32_t B,
    int32_t T, int lane0) {
  constexpr int din = 2 * A * A;
  constexpr int nout = A + 1;
  constexpr int nred = nout * kTileRows;  // outputs of a tile
  const int trans_off = 2 * din + 2 * A;
  const int tid = threadIdx.x;
  for (int p = tid; p < nred; p += kThreads) {
    float sum = s_red[p];
#pragma unroll
    for (int c = 1; c < kContrib; ++c) sum += s_red[c * (nred + 1) + p];
    const int o = p / kTileRows, r = p - o * kTileRows;
    s_out[r * nout + o] = sum + s_b1[o];
  }
  __syncthreads();

  // -- epilogue: one thread per (lane, seat) row --------------------------
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
  // -- transition: one thread per lane ------------------------------------
  if (tid < kTileLanes) {
    const int b = lane0 + tid;
    if (b < B) {
      const int cell = s_act[tid] * A + s_act[tid + kTileLanes];
      const float* trip = table + (int64_t)clamped_state(idx, b, S) * D +
                          trans_off + cell * 3 * T;
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
}

template <int A>
__global__ void __launch_bounds__(kThreads, A <= 4 ? 2 : 1)
fused_turn_kernel(const float* __restrict__ table, int32_t S, int32_t D,
                  const int32_t* __restrict__ idx,
                  const float* __restrict__ w0, const float* __restrict__ b0,
                  const float* __restrict__ w1, const float* __restrict__ b1,
                  const float* __restrict__ g_act,
                  const float* __restrict__ g_ch, int32_t* __restrict__ new_idx,
                  float* __restrict__ policy, int32_t* __restrict__ actions,
                  float* __restrict__ rewards, float* __restrict__ values,
                  float* __restrict__ obs_out, int32_t B, int32_t T,
                  int32_t H) {
  constexpr int din = 2 * A * A;
  constexpr int nout = A + 1;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L(A, H);
  const int Hp = padded_units(H);
  const int mask_off = 2 * din;
  float* s_w0 = smem + L.w0;
  float* s_b0 = smem + L.b0;
  float* s_w1t = smem + L.w1t;
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
      if (u < H) copy4(s_w0 + k * Hp + u, w0 + (int64_t)k * H + u);
      else s_w0[k * Hp + u] = 0.f;
    }
  for (int o = 0; o < nout; ++o)
    for (int u = tid; u < Hp; u += kThreads) {
      if (u < H) copy4(s_w1t + o * Hp + u, w1 + (int64_t)u * nout + o);
      else s_w1t[o * Hp + u] = 0.f;
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
  const auto state_of = [&](int tile) {  // -1: no such lane
    const int b = tile * kTileLanes + slane;
    return tile >= tiles || b >= B ? -1 : clamped_state(idx, b, S);
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
    __syncthreads();  // this tile's inputs (and the weights) have landed
    const float* t_obs = s_obs + buf * L.obs_size;
    const float* t_gact = s_gact + buf * L.rows_size;
    const float* t_mask = s_mask + buf * L.rows_size;
    if (obs_out != nullptr)  // the stage is k-major: (k, row) at k * stride
      for (int p = tid; p < kTileRows * din; p += kThreads) {
        const int r = p / din, k = p - r * din;
        const int b = lane0 + r % kTileLanes;
        if (b < B)
          obs_out[((int64_t)(r / kTileLanes) * B + b) * din + k] =
              t_obs[k * kObsStride + r];
      }

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
        const float* wk = s_w0 + k * Hp + u0;
        const float4 wa = *reinterpret_cast<const float4*>(wk);
        const float4 wb = *reinterpret_cast<const float4*>(wk + kHalf);
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
        for (int o = 0; o < nout; ++o) w1u[o] = s_w1t[o * Hp + u];
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float h = fmaxf(acc[r][j] + bias, 0.f);
#pragma unroll
          for (int o = 0; o < nout; ++o) part[r][o] = fmaf(h, w1u[o], part[r][o]);
        }
      }
    }
    // the next tile's inputs go to the other buffers, whose last readers
    // (the previous tile's compute and epilogue) are past the barrier above
    stage(tile + gridDim.x, buf ^ 1, next_state);
    // the warp's 8 unit groups (lanes 4 apart) sum by shuffles, then each
    // output sums the 4 warps' partials in unit-block order
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
    finish_tile<A>(s_red, s_out, s_b1, t_gact, t_mask, s_act, table, S, D,
                   idx, g_ch, new_idx, policy, actions, rewards, values, B, T,
                   lane0);
    // The next tile rewrites s_red and s_out only after its first barrier,
    // which this tile's readers of them have passed, and s_act after three.
  }
}

template <int A>
__global__ void __launch_bounds__(kThreads, 2)
fused_turn_bf16_kernel(const float* __restrict__ table, int32_t S, int32_t D,
                       const int32_t* __restrict__ idx,
                       const __nv_bfloat16* __restrict__ w0,
                       const float* __restrict__ b0,
                       const __nv_bfloat16* __restrict__ w1,
                       const float* __restrict__ b1,
                       const float* __restrict__ g_act,
                       const float* __restrict__ g_ch,
                       int32_t* __restrict__ new_idx,
                       float* __restrict__ policy,
                       int32_t* __restrict__ actions,
                       float* __restrict__ rewards,
                       float* __restrict__ values,
                       float* __restrict__ obs_out, int32_t B, int32_t T,
                       int32_t H) {
  constexpr int din = 2 * A * A;
  constexpr int nout = A + 1;
  constexpr int Kp = (din + kMmaK - 1) / kMmaK * kMmaK;
  constexpr int KS = Kp / kMmaK;  // mma steps along k
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const LayoutBf16 L(A, H);
  const int Hp = padded_units_mma(H);
  const int mask_off = 2 * din;
  const __nv_bfloat16* s_w0 =
      reinterpret_cast<const __nv_bfloat16*>(smem + L.w0);
  const __nv_bfloat16* s_w1 =
      reinterpret_cast<const __nv_bfloat16*>(smem + L.w1);
  float* s_b0 = smem + L.b0;
  float* s_b1 = smem + L.b1;
  uint32_t* s_xs = reinterpret_cast<uint32_t*>(smem + L.xs);
  float* s_obs = smem + L.obs;
  float* s_red = smem + L.red;
  float* s_out = smem + L.out;
  float* s_gact = smem + L.gact;
  float* s_mask = smem + L.mask;
  int* s_act = reinterpret_cast<int*>(smem + L.act);
  const int tid = threadIdx.x;
  const int tiles = (B + kTileLanes - 1) / kTileLanes;

  // Staging: 4 threads copy each (lane, seat) row of a tile, thread sq the
  // pairs (k, k+1) with k = 2 sq + 8 i, which it later rounds itself.
  const int srow = tid / 4, sq = tid % 4;
  const int sseat = srow / kTileLanes, slane = srow % kTileLanes;
  const auto state_of = [&](int tile) {  // -1: no such lane
    const int b = tile * kTileLanes + slane;
    return tile >= tiles || b >= B ? -1 : clamped_state(idx, b, S);
  };
  const auto stage = [&](int tile, int buf, int s) {
    float* obs = s_obs + buf * L.obs_size + srow * din;
    float* gact = s_gact + buf * L.rows_size;
    float* mask = s_mask + buf * L.rows_size;
    if (s < 0) {
      for (int k = 2 * sq; k < din; k += 8) obs[k] = obs[k + 1] = 0.f;
      for (int a = sq; a < A; a += 4) gact[srow * A + a] = mask[srow * A + a] = 0.f;
      return;
    }
    const int b = tile * kTileLanes + slane;
    const float* row = table + (int64_t)s * D + sseat * din;
    for (int k = 2 * sq; k < din; k += 8) {
      copy4(obs + k, row + k);
      copy4(obs + k + 1, row + k + 1);
    }
    for (int a = sq; a < A; a += 4) {
      copy4(gact + srow * A + a, g_act + ((int64_t)sseat * B + b) * A + a);
      copy4(mask + srow * A + a,
            table + (int64_t)s * D + mask_off + sseat * A + a);
    }
  };

  // the first tile's inputs in flight while the weights are staged: W0
  // and W1 in their own layouts by 4-byte copies (2W is even), all in
  // flight at once, zeros past din and past H
  int buf = 0;
  stage(blockIdx.x, 0, state_of(blockIdx.x));
  const int hw = H / 2;  // 4-byte words of a row of W0
  for (int w = tid; w < Kp * L.w0_row; w += kThreads) {
    const int k = w / L.w0_row, i = w - k * L.w0_row;
    float* dst = smem + L.w0 + w;
    if (k < din && i < hw)
      copy4(dst, reinterpret_cast<const float*>(w0 + (int64_t)k * H) + i);
    else
      *dst = 0.f;
  }
  for (int w = tid; w < Hp * nout / 2; w += kThreads) {
    if (w < hw * nout)
      copy4(smem + L.w1 + w, reinterpret_cast<const float*>(w1) + w);
    else
      smem[L.w1 + w] = 0.f;
  }
  for (int u = tid; u < Hp; u += kThreads) {
    if (u < H) copy4(s_b0 + u, b0 + u);
    else s_b0[u] = 0.f;
  }
  if (tid < nout) copy4(s_b1 + tid, b1 + tid);

  // mma fragments: lane = 4 g + tig holds rows g and g + 8 of an m-tile and
  // units 2 tig, 2 tig + 1 of an n-tile; its ldmatrix row of W0
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int mt0 = (warp % kRowBlocks) * 2;  // the warp's two m-tiles
  const int row0 = mt0 * 16 + g;  // its rows row0 + {0, 8, 16, 24}
  const int contrib = warp / kRowBlocks;  // the warp's unit block
  const __nv_bfloat16* b_row =
      s_w0 + (lane % 16) * (2 * L.w0_row) + lane / 16 * 8;
  constexpr int nred = nout * kTileRows;
  // where the staging thread's pairs go in the A fragments
  const int xs_mt = srow / 16, xs_lane = srow % 8 * 4 + sq;
  const int xs_reg = srow % 16 / 8;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, buf ^= 1) {
    const int lane0 = tile * kTileLanes;
    const int next_state = state_of(tile + gridDim.x);  // in flight meanwhile
    copies_done();
    {  // this thread's staged pairs, rounded to bf16, zeros from din to Kp
      const float* obs = s_obs + buf * L.obs_size + srow * din;
#pragma unroll
      for (int k = 2 * sq; k < Kp; k += 8) {
        const uint32_t v = k < din ? pack_bf16(__float2bfloat16_rn(obs[k]),
                                               __float2bfloat16_rn(obs[k + 1]))
                                   : 0u;
        s_xs[((xs_mt * KS + k / kMmaK) * 32 + xs_lane) * 4 + xs_reg +
             k % kMmaK / 8 * 2] = v;
      }
    }
    __syncthreads();  // this tile's inputs (and the weights) have landed
    const float* t_gact = s_gact + buf * L.rows_size;
    const float* t_mask = s_mask + buf * L.rows_size;
    if (obs_out != nullptr) {  // the f32 stage is row-major: (row, k)
      const float* t_obs = s_obs + buf * L.obs_size;
      for (int p = tid; p < kTileRows * din; p += kThreads) {
        const int r = p / din;
        const int b = lane0 + r % kTileLanes;
        if (b < B)
          obs_out[((int64_t)(r / kTileLanes) * B + b) * din + p - r * din] =
              t_obs[p];
      }
    }

    // -- the first layer on the tensor cores, the second on the CUDA cores
    float part[4][nout];  // rows row0 + 8 r
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int o = 0; o < nout; ++o) part[r][o] = 0.f;
    for (int base = contrib * kWarpUnits; base < Hp;
         base += kMmaUnitsPerPass) {
      float acc[2][4][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][nt][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint4 a[2];
#pragma unroll
        for (int m = 0; m < 2; ++m)
          a[m] = reinterpret_cast<const uint4*>(
              s_xs)[((mt0 + m) * KS + ks) * 32 + lane];
#pragma unroll
        for (int nt = 0; nt < 4; nt += 2) {
          uint32_t b[4];
          load_b_pair(b, b_row + ks * kMmaK * (2 * L.w0_row) + base + nt * 8);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma_bf16(acc[m][nt], a[m], b[0], b[1]);
            mma_bf16(acc[m][nt + 1], a[m], b[2], b[3]);
          }
        }
      }
      // +b0, ReLU and the bf16 rounding of units u and u + 1, then their
      // products with W1 in unit order
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int u = base + nt * 8 + tig * 2;
        const float2 bias = *reinterpret_cast<const float2*>(s_b0 + u);
        float w1a[nout], w1b[nout];
        w1_row<nout>(w1a, s_w1, u);
        w1_row<nout>(w1b, s_w1, u + 1);
#pragma unroll
        for (int r = 0; r < 4; ++r) {  // m-tile r / 2, row half r % 2
          const float* c = acc[r / 2][nt] + r % 2 * 2;
          const uint32_t h = relu_bf16x2(c[1] + bias.y, c[0] + bias.x);
          const float h0 = __uint_as_float(h << 16);
          const float h1 = __uint_as_float(h & 0xffff0000u);
#pragma unroll
          for (int o = 0; o < nout; ++o) part[r][o] = fmaf(h0, w1a[o], part[r][o]);
#pragma unroll
          for (int o = 0; o < nout; ++o) part[r][o] = fmaf(h1, w1b[o], part[r][o]);
        }
      }
    }
    // the next tile's inputs go to the other buffers, whose last readers
    // (the previous tile's rounding pass and epilogue) are past the barrier
    // above
    stage(tile + gridDim.x, buf ^ 1, next_state);
    // the 4 lanes that hold the same rows sum by two xor shuffles, then
    // each output sums the 4 warps' partials in unit-block order
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int o = 0; o < nout; ++o) {
        float v = part[r][o];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (tig == 0) s_red[contrib * (nred + 1) + o * kTileRows + row0 + 8 * r] = v;
      }
    __syncthreads();
    finish_tile<A>(s_red, s_out, s_b1, t_gact, t_mask, s_act, table, S, D,
                   idx, g_ch, new_idx, policy, actions, rewards, values, B, T,
                   lane0);
  }
}

// Launch settings, set once: the shared-memory attribute of a kernel on a
// device at the most a block may opt in to (it belongs to the kernel,
// whatever H), and the grid of each (device, A, H, variant).
std::mutex cache_mutex;
std::set<std::tuple<int, int, int>> smem_set;
std::map<std::tuple<int, int, int, int>, int> grid_cache;

template <typename Kernel>
cudaError_t blocks_of(Kernel kernel, int A, int H, int bf16, size_t smem,
                      int* blocks) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(cache_mutex);
  if (!smem_set.count(std::make_tuple(device, A, bf16))) {
    int optin = 0;
    if ((err = cudaDeviceGetAttribute(
             &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
        cudaSuccess)
      return err;
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin)) !=
        cudaSuccess)
      return err;
    smem_set.insert(std::make_tuple(device, A, bf16));
  }
  const auto key = std::make_tuple(device, A, H, bf16);
  auto found = grid_cache.find(key);
  if (found != grid_cache.end()) {
    *blocks = found->second;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = grid_cache[key] = sms * per_sm;
  return cudaSuccess;
}

size_t smem_of(int A, int H, int bf16) {
  return (size_t)(bf16 ? LayoutBf16(A, H).total : Layout(A, H).total) *
         sizeof(float);
}

template <int A>
cudaError_t launch(const float* table, int32_t S, int32_t D,
                   const int32_t* idx, const void* w0, const float* b0,
                   const void* w1, const float* b1, const float* g_act,
                   const float* g_ch, int32_t* new_idx, float* policy,
                   int32_t* actions, float* rewards, float* values,
                   float* obs, int32_t B, int32_t T, int32_t H, int bf16,
                   cudaStream_t stream) {
  const size_t smem = smem_of(A, H, bf16);
  int blocks = 0;
  cudaError_t err =
      bf16 ? blocks_of(fused_turn_bf16_kernel<A>, A, H, 1, smem, &blocks)
           : blocks_of(fused_turn_kernel<A>, A, H, 0, smem, &blocks);
  if (err != cudaSuccess) return err;
  const int64_t tiles = ((int64_t)B + kTileLanes - 1) / kTileLanes;
  const unsigned grid = (unsigned)(tiles < blocks ? tiles : blocks);
  if (bf16)
    fused_turn_bf16_kernel<A><<<grid, kThreads, smem, stream>>>(
        table, S, D, idx, (const __nv_bfloat16*)w0, b0,
        (const __nv_bfloat16*)w1, b1, g_act, g_ch, new_idx, policy, actions,
        rewards, values, obs, B, T, H);
  else
    fused_turn_kernel<A><<<grid, kThreads, smem, stream>>>(
        table, S, D, idx, (const float*)w0, b0, (const float*)w1, b1, g_act,
        g_ch, new_idx, policy, actions, rewards, values, obs, B, T, H);
  return cudaGetLastError();
}

}  // namespace

// bf16: 0 for f32 weights, 1 for bf16 weights (the bf16-operand variant).
// obs: the (2, B, 2A^2) stored observations, or null for none.
extern "C" size_t rnad_fused_turn_smem_bytes(int32_t A, int32_t H,
                                             int32_t bf16) {
  return smem_of(A, H, bf16);
}

extern "C" int rnad_fused_turn(const void* table, int32_t S, int32_t D,
                               const void* idx, const void* w0,
                               const void* b0, const void* w1, const void* b1,
                               const void* g_act, const void* g_ch,
                               void* new_idx, void* policy, void* actions,
                               void* rewards, void* values, void* obs,
                               int32_t B, int32_t A, int32_t T, int32_t H,
                               int32_t bf16, void* stream) {
  if (A < 1 || A > kMaxA || T < 1 || T > kMaxT || H < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  switch (A) {
#define RNAD_FUSED_TURN_CASE(K)                                             \
  case K:                                                                   \
    return (int)launch<K>((const float*)table, S, D, (const int32_t*)idx,   \
                          w0, (const float*)b0, w1, (const float*)b1,       \
                          (const float*)g_act, (const float*)g_ch,          \
                          (int32_t*)new_idx, (float*)policy,                \
                          (int32_t*)actions, (float*)rewards,               \
                          (float*)values, (float*)obs, B, T, H, bf16 != 0,  \
                          (cudaStream_t)stream);
    RNAD_FUSED_TURN_CASE(1)
    RNAD_FUSED_TURN_CASE(2)
    RNAD_FUSED_TURN_CASE(3)
    RNAD_FUSED_TURN_CASE(4)
    RNAD_FUSED_TURN_CASE(5)
    RNAD_FUSED_TURN_CASE(6)
    RNAD_FUSED_TURN_CASE(7)
    RNAD_FUSED_TURN_CASE(8)
#undef RNAD_FUSED_TURN_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* rnad_fused_turn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
