// In-place row set over the pass working-set table:
//     table[rows[i], :] = new_rows[i, :]   for i in [0, U)
//
// Replaces the TPU kernel write_rows_pallas (the JAX package's
// ops/pallas_kernels.py, body _writeback_kernel), which scalar-prefetches the
// row ids and keeps 8 per-row VMEM->HBM DMAs in flight per grid step into a
// table aliased input->output, so untouched rows never move.
//
// What bounds it on the H100: bytes. Each element of new_rows is read once
// and written once into the table, so the byte bound is (2 * U * W * 4 +
// U * id bytes) over 3.35 TB/s: 6.31 us at the training shape (U = 122,880,
// W = 21). The 84-byte rows raise the real floor: a row at a random row id
// touches 3.5 sectors of 32 bytes on average, 1.75 of them only in part, and
// the L2 must read a partly written sector from memory before it writes it
// back. Counting those reads, the sector floor is about 31.4 MB, 9.4 us, at
// that shape. No design that keeps the table's layout writes less.
//
// Design, one block per tile of tile_rows rows (row_tile.cuh):
// - The row ids are loaded once per tile, coalesced, into shared memory and
//   range-checked there; an id outside [0, R) writes nothing. No thread
//   loads a row id from device memory per element.
// - The tile of new_rows (contiguous) is copied into shared memory with
//   cp.async, all in flight before any store: 16-byte copies when new_rows
//   is 16-byte aligned (tile_rows % 4 == 0 keeps every tile so), 4-byte
//   copies when it is not, as a view may be. Both are branches of this
//   kernel.
// - The stores are scattered one warp per row: neighbouring lanes write
//   neighbouring columns of one table row, so each row's sectors are
//   written by one request per 32 columns.
// - The caller sizes the tile to about 16 KB of floats (192 rows at
//   W = 21), so U = 122,880 is 640 blocks of 256 threads: one wave of the
//   132 SMs, no grid-stride loop and no tail of small waves.
// Table offsets are 64-bit; int32 and int64 row ids both work, any W >= 1.
//
// Duplicates: the push writes rows that are unique except for repeats of the
// padding row, and those repeats carry byte-identical contents. Racing
// stores of identical bytes leave those same bytes, so no atomics and no
// ordering are needed. Rows that repeat with different contents are not a
// supported input (one of the stores wins).
//
// The kernel writes into `table` in place, launches on the caller's stream
// and does not synchronise. Built with nvcc for sm_90a into a shared library
// with a plain C interface, loaded by paddlebox_tpu_torch/ops/cuda_kernels.py
// through ctypes, which also computes the launch geometry (tile_geometry).

#include "row_tile.cuh"

namespace {

template <typename IdxT>
__global__ void write_rows_kernel(float* __restrict__ table, int64_t R, int W,
                                  const IdxT* __restrict__ rows, int64_t U, int tile_rows,
                                  int tile_cols, const float* __restrict__ new_rows,
                                  bool aligned16) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* s_rows = reinterpret_cast<int64_t*>(smem);
  float* s_tile = reinterpret_cast<float*>(smem + (size_t)tile_rows * sizeof(int64_t));

  const int64_t t0 = (int64_t)blockIdx.x * tile_rows;
  const int n_rows = U - t0 < tile_rows ? (int)(U - t0) : tile_rows;
  const int c0 = blockIdx.y * tile_cols;
  const int cols = min(tile_cols, W - c0);

  pbx::stage_row_ids(rows, t0, n_rows, R, s_rows);

  const float* src = new_rows + t0 * W + c0;
  if (aligned16 && cols == W) {  // the tile is one 16-byte-aligned run
    const int n = n_rows * W;
    const int n4 = n >> 2;
    for (int k = threadIdx.x; k < n4; k += blockDim.x) {
      pbx::cp_async16(s_tile + 4 * k, src + 4 * k);
    }
    for (int e = (n4 << 2) + threadIdx.x; e < n; e += blockDim.x) {
      pbx::cp_async4(s_tile + e, src + e);
    }
  } else {  // a misaligned view, or a slab of rows wider than the tile budget
    pbx::for_each_element(n_rows, cols, [&](int e, int i, int c) {
      pbx::cp_async4(s_tile + e, src + (int64_t)i * W + c);
    });
  }
  pbx::cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  for (int i = threadIdx.x >> 5; i < n_rows; i += n_warps) {
    const int64_t r = s_rows[i];
    if (r < 0) continue;
    float* dst = table + r * W + c0;
    const float* row = s_tile + i * cols;
    for (int c = lane; c < cols; c += 32) dst[c] = row[c];
  }
}

}  // namespace

// grid_rows x grid_cols blocks of `threads` threads (a multiple of 32) with
// smem_bytes of dynamic shared memory (at most 48 KB), as tile_geometry
// computes them.
extern "C" int pbx_write_rows_f32(float* table, long long R, int W, const void* rows,
                                  int rows_is_64, long long U, const float* new_rows,
                                  int tile_rows, int tile_cols, long long grid_rows,
                                  int grid_cols, int threads, int smem_bytes,
                                  cudaStream_t stream) {
  if (U <= 0 || W <= 0 || grid_rows <= 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)grid_rows, (unsigned)grid_cols);
  const bool aligned16 = (reinterpret_cast<uintptr_t>(new_rows) & 15) == 0;
  if (rows_is_64) {
    write_rows_kernel<int64_t><<<grid, threads, smem_bytes, stream>>>(
        table, (int64_t)R, W, (const int64_t*)rows, (int64_t)U, tile_rows, tile_cols, new_rows,
        aligned16);
  } else {
    write_rows_kernel<int32_t><<<grid, threads, smem_bytes, stream>>>(
        table, (int64_t)R, W, (const int32_t*)rows, (int64_t)U, tile_rows, tile_cols, new_rows,
        aligned16);
  }
  return (int)cudaGetLastError();
}
