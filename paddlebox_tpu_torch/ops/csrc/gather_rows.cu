// Row gather over the pass working-set table: out[i, :] = table[rows[i], :].
//
// Replaces the TPU kernel pull_rows_pallas (the JAX package's ops/pallas_kernels.py,
// body _gather_kernel), which scalar-prefetches the row ids and issues 8
// concurrent per-row HBM DMAs per grid step. On Hopper the same function is a
// plain memory-bound copy: every output element is read once from the table
// and written once, so the bound is (2 * U * W * 4 + U * sizeof(row id)) bytes
// over the HBM rate. No arithmetic to speak of.
//
// Design: the output is treated as one flat array of U * W floats and each
// thread copies elements of it in a grid-stride loop. Neighbouring threads
// write neighbouring addresses (fully coalesced stores) and read neighbouring
// columns of one table row (coalesced within a row), whatever W is. That
// handles the serving width W = 21 (84-byte rows, not 16-byte aligned, so no
// float4 loads) as well as W = 1 or W = 128, and any U including 0. Offsets
// are 64-bit: training tables pass 2^31 elements. A row id outside [0, R)
// yields NaN in its output row rather than a read of foreign memory.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface,
// loaded by paddlebox_tpu_torch/ops/cuda_kernels.py through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// OffT is the type of the flat output index: 32-bit while U * W fits, so
// the per-element division by W is a cheap 32-bit one; 64-bit past that.
template <typename IdxT, typename OffT>
__global__ void gather_rows_kernel(const float* __restrict__ table, int64_t R,
                                   OffT W, const IdxT* __restrict__ rows,
                                   OffT total, float* __restrict__ out) {
  const OffT stride = (OffT)gridDim.x * blockDim.x;
  for (OffT e = (OffT)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const OffT i = e / W;
    const OffT c = e - i * W;
    const int64_t r = (int64_t)__ldg(rows + i);
    out[e] = (r >= 0 && r < R) ? __ldg(table + r * W + c) : __int_as_float(0x7fc00000);
  }
}

template <typename IdxT>
void launch(const float* table, int64_t R, int64_t W, const IdxT* rows,
            int64_t total, float* out, unsigned blocks, int threads,
            cudaStream_t stream) {
  // total + stride must not wrap the 32-bit index in the grid-stride loop
  if (total + (int64_t)blocks * threads < ((int64_t)1 << 31)) {
    gather_rows_kernel<IdxT, int32_t><<<blocks, threads, 0, stream>>>(
        table, R, (int32_t)W, rows, (int32_t)total, out);
  } else {
    gather_rows_kernel<IdxT, int64_t><<<blocks, threads, 0, stream>>>(
        table, R, W, rows, total, out);
  }
}

}  // namespace

extern "C" int pbx_gather_rows_f32(const float* table, long long R, int W,
                                   const void* rows, int rows_is_64,
                                   long long U, float* out,
                                   cudaStream_t stream) {
  const int64_t total = (int64_t)U * (int64_t)W;
  if (total <= 0) return (int)cudaSuccess;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  // a grid-stride loop covers the rest: 132 SMs hold 8 resident blocks of
  // 256 threads each, so this cap is 8 full waves of the card
  const int64_t max_blocks = 132 * 64;
  if (blocks > max_blocks) blocks = max_blocks;
  if (rows_is_64) {
    launch<int64_t>(table, (int64_t)R, (int64_t)W, (const int64_t*)rows, total,
                    out, (unsigned)blocks, threads, stream);
  } else {
    launch<int32_t>(table, (int64_t)R, (int64_t)W, (const int32_t*)rows, total,
                    out, (unsigned)blocks, threads, stream);
  }
  return (int)cudaGetLastError();
}
