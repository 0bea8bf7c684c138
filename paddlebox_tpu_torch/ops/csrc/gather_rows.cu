// Row gather over the pass working-set table: out[i, :] = table[rows[i], :].
//
// Replaces the TPU kernel pull_rows_pallas (the JAX package's
// ops/pallas_kernels.py, body _gather_kernel), which scalar-prefetches the
// row ids and keeps 8 per-row HBM DMAs in flight per grid step.
//
// What bounds it on the H100: bytes. Each output element is read once from
// the table and written once, so the byte bound is (2 * U * W * 4 + U * id
// bytes) over 3.35 TB/s: 6.31 us at the training shape (U = 122,880,
// W = 21). The 84-byte rows raise the real floor: a row at a random row id
// starts at one of 8 offsets mod 32 and touches 3.5 sectors of 32 bytes on
// average, 112 bytes read for 84 used, so the sector floor is about 24.6 MB,
// 7.3 us, at that shape. No design that keeps the table's layout reads less.
//
// Design, one block per tile of tile_rows rows (row_tile.cuh):
// - The row ids are loaded once per tile, coalesced, into shared memory and
//   range-checked there; an id outside [0, R) gives a NaN row. No thread
//   loads a row id from device memory per element, and the (row, column)
//   walk steps without a division, so no table read waits on an id load.
// - Every table read of the tile is issued as a 4-byte cp.async into shared
//   memory before any store: an SM holds the reads of all its resident
//   tiles in flight (tens of KB), not one 4-byte load per thread.
// - The tile is then stored to `out` from shared memory with coalesced
//   16-byte stores: out's tile is contiguous and starts 16-byte aligned
//   (tile_rows % 4 == 0, out from torch.empty). A last partial tile ends
//   with scalar stores. Only the reads pay the rows' partial sectors.
// - The caller sizes the tile to about 16 KB of floats (192 rows at
//   W = 21), so U = 122,880 is 640 blocks of 256 threads: one wave of the
//   132 SMs, no grid-stride loop and no tail of small waves.
// Table offsets are 64-bit; int32 and int64 row ids both work, any W >= 1.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface,
// loaded by paddlebox_tpu_torch/ops/cuda_kernels.py through ctypes, which
// also computes the launch geometry (tile_geometry there).

#include "row_tile.cuh"

namespace {

template <typename IdxT>
__global__ void gather_rows_kernel(const float* __restrict__ table, int64_t R, int W,
                                   const IdxT* __restrict__ rows, int64_t U, int tile_rows,
                                   int tile_cols, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* s_rows = reinterpret_cast<int64_t*>(smem);
  float* s_tile = reinterpret_cast<float*>(smem + (size_t)tile_rows * sizeof(int64_t));

  const int64_t t0 = (int64_t)blockIdx.x * tile_rows;
  const int n_rows = U - t0 < tile_rows ? (int)(U - t0) : tile_rows;
  const int c0 = blockIdx.y * tile_cols;
  const int cols = min(tile_cols, W - c0);

  pbx::stage_row_ids(rows, t0, n_rows, R, s_rows);
  __syncthreads();

  pbx::for_each_element(n_rows, cols, [&](int e, int i, int c) {
    const int64_t r = s_rows[i];
    if (r >= 0) {
      pbx::cp_async4(s_tile + e, table + r * W + c0 + c);
    } else {
      s_tile[e] = __int_as_float(0x7fc00000);
    }
  });
  pbx::cp_async_wait_all();
  __syncthreads();

  float* dst = out + t0 * W + c0;
  if (cols == W) {  // the whole rows: out's tile is one contiguous run
    const int n = n_rows * W;
    const int n4 = n >> 2;
    float4* dst4 = reinterpret_cast<float4*>(dst);
    const float4* src4 = reinterpret_cast<const float4*>(s_tile);
    for (int k = threadIdx.x; k < n4; k += blockDim.x) dst4[k] = src4[k];
    for (int e = (n4 << 2) + threadIdx.x; e < n; e += blockDim.x) dst[e] = s_tile[e];
  } else {  // a slab of rows wider than the tile budget
    pbx::for_each_element(n_rows, cols, [&](int e, int i, int c) {
      dst[(int64_t)i * W + c] = s_tile[e];
    });
  }
}

}  // namespace

// grid_rows x grid_cols blocks of `threads` threads with smem_bytes of
// dynamic shared memory (at most 48 KB), as tile_geometry computes them.
extern "C" int pbx_gather_rows_f32(const float* table, long long R, int W, const void* rows,
                                   int rows_is_64, long long U, float* out, int tile_rows,
                                   int tile_cols, long long grid_rows, int grid_cols,
                                   int threads, int smem_bytes, cudaStream_t stream) {
  if (U <= 0 || W <= 0 || grid_rows <= 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)grid_rows, (unsigned)grid_cols);
  if (rows_is_64) {
    gather_rows_kernel<int64_t><<<grid, threads, smem_bytes, stream>>>(
        table, (int64_t)R, W, (const int64_t*)rows, (int64_t)U, tile_rows, tile_cols, out);
  } else {
    gather_rows_kernel<int32_t><<<grid, threads, smem_bytes, stream>>>(
        table, (int64_t)R, W, (const int32_t*)rows, (int64_t)U, tile_rows, tile_cols, out);
  }
  return (int)cudaGetLastError();
}
