// In-place row set over the pass working-set table:
//     table[rows[i], :] = new_rows[i, :]   for i in [0, U)
//
// Replaces the TPU kernel write_rows_pallas (the JAX package's
// ops/pallas_kernels.py, body _writeback_kernel), which scalar-prefetches the
// row ids and issues 8 concurrent per-row VMEM->HBM DMAs per grid step into a
// table aliased input->output, so untouched rows never move. On Hopper the
// same function is a plain memory-bound scatter: every element of new_rows is
// read once and written once into the table, so the bound is
// (2 * U * W * 4 + U * sizeof(row id)) bytes over the HBM rate. No arithmetic
// to speak of.
//
// Design: new_rows is treated as one flat array of U * W floats and each
// thread copies elements of it in a grid-stride loop. Neighbouring threads
// read neighbouring floats of new_rows (coalesced loads) and write
// neighbouring columns of one table row (coalesced within a row), whatever W
// is. That handles the training width W = 21 (84-byte rows, not 16-byte
// aligned, so no float4 stores) as well as W = 1 or W = 128, and any U
// including 0. The flat index is 32-bit while U * W fits (a cheap division
// by W), 64-bit past that; table offsets are always 64-bit.
//
// Duplicates: the push writes rows that are unique except for repeats of the
// padding row, and those repeats carry byte-identical contents. Racing
// stores of identical bytes leave those same bytes, so no atomics and no
// ordering are needed. Rows that repeat with different contents are not a
// supported input (one of the stores wins).
//
// A row id outside [0, R) writes nothing: its elements are skipped, so no
// store ever lands outside the table, and every other row of the table keeps
// its bytes.
//
// The kernel writes into `table` in place, launches on the caller's stream
// and does not synchronise. Built with nvcc for sm_90a into a shared library
// with a plain C interface, loaded by paddlebox_tpu_torch/ops/cuda_kernels.py
// through ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename IdxT, typename OffT>
__global__ void write_rows_kernel(float* __restrict__ table, int64_t R, OffT W,
                                  const IdxT* __restrict__ rows,
                                  const float* __restrict__ new_rows,
                                  OffT total) {
  const OffT stride = (OffT)gridDim.x * blockDim.x;
  for (OffT e = (OffT)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const OffT i = e / W;
    const OffT c = e - i * W;
    const int64_t r = (int64_t)__ldg(rows + i);
    if (r >= 0 && r < R) {
      table[r * (int64_t)W + (int64_t)c] = __ldg(new_rows + e);
    }
  }
}

template <typename IdxT>
void launch(float* table, int64_t R, int64_t W, const IdxT* rows,
            const float* new_rows, int64_t total, unsigned blocks, int threads,
            cudaStream_t stream) {
  // total + stride must not wrap the 32-bit index in the grid-stride loop
  if (total + (int64_t)blocks * threads < ((int64_t)1 << 31)) {
    write_rows_kernel<IdxT, int32_t><<<blocks, threads, 0, stream>>>(
        table, R, (int32_t)W, rows, new_rows, (int32_t)total);
  } else {
    write_rows_kernel<IdxT, int64_t><<<blocks, threads, 0, stream>>>(
        table, R, W, rows, new_rows, total);
  }
}

}  // namespace

extern "C" int pbx_write_rows_f32(float* table, long long R, int W,
                                  const void* rows, int rows_is_64,
                                  long long U, const float* new_rows,
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
    launch<int64_t>(table, (int64_t)R, (int64_t)W, (const int64_t*)rows,
                    new_rows, total, (unsigned)blocks, threads, stream);
  } else {
    launch<int32_t>(table, (int64_t)R, (int64_t)W, (const int32_t*)rows,
                    new_rows, total, (unsigned)blocks, threads, stream);
  }
  return (int)cudaGetLastError();
}
