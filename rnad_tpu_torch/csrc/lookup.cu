// Packed-row lookup: out[b, :] = table[idx[b], :], bit-exact.
//
// Replaces: rnad_tpu/ops/pallas_lookup.py, `_kernel` (called by
// `onehot_lookup`).  On the TPU the row read was a one-hot (tile, S) x (S, D)
// matmul at HIGHEST precision so that the f32-encoded child ids survived; on
// the GPU a row is read directly, which is exact by construction.
//
// Bound on the H100: bytes.  The function reads N int32 ids, the distinct
// rows they name, and writes N * D floats; it does no arithmetic.  The
// learner's regather has N = 131072 and D = 128 (64 MiB written).
//
// Design: one thread per 16-byte chunk of an output row.  Neighbouring
// threads read neighbouring float4 chunks of one table row and write
// neighbouring chunks of one output row, so every warp moves whole 512-byte
// rows with 16-byte accesses.  D must be a multiple of 4 (make_packed_tables
// pads it to 128).  The table is read from device memory; L2 keeps a small
// table resident.  Ids are clamped to [0, S) so a bad id can never read
// outside the table (XLA's gather clamps the same way).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void lookup_kernel(const float4* __restrict__ table,
                              const int32_t* __restrict__ idx,
                              float4* __restrict__ out, int64_t n_rows,
                              int32_t n_table, int32_t chunks) {
  const int64_t total = n_rows * chunks;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t row = i / chunks;
    const int32_t chunk = (int32_t)(i - row * chunks);
    int32_t s = idx[row];
    s = s < 0 ? 0 : (s >= n_table ? n_table - 1 : s);
    out[i] = table[(int64_t)s * chunks + chunk];
  }
}

}  // namespace

extern "C" int rnad_lookup(const void* table, const void* idx, void* out,
                           int64_t n_rows, int32_t n_table, int32_t d,
                           void* stream) {
  if (n_rows == 0) return 0;
  const int32_t chunks = d / 4;
  const int threads = 256;
  const int64_t total = n_rows * chunks;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 65535 * 8) blocks = 65535 * 8;
  lookup_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float4*)table, (const int32_t*)idx, (float4*)out, n_rows,
      n_table, chunks);
  return (int)cudaGetLastError();
}

extern "C" const char* rnad_lookup_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
