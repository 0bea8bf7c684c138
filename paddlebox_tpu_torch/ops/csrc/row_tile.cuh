// What the row gather (gather_rows.cu) and the row writeback (write_rows.cu)
// share: a block owns a tile of rows of the [U, W] side of the copy, stages
// the tile's row ids in shared memory once, and moves the tile between
// device memory and shared memory with cp.async.
//
// Shared memory of a block (dynamic, sized by the launcher's caller, at most
// 48 KB): tile_rows int64 row ids, then the tile of tile_rows x tile_cols
// floats, row-major. tile_rows is a multiple of 4, so the tile starts
// 16-byte aligned. A block covers rows [blockIdx.x * tile_rows, + n_rows)
// and columns [blockIdx.y * tile_cols, + cols); only rows wider than the
// tile budget have more than one block along the columns.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pbx {

// 4-byte global -> shared copy, in flight until cp_async_wait_all(). The
// 4-byte form must be .ca (.cg takes only 16 bytes).
__device__ __forceinline__ void cp_async4(float* smem_dst, const float* gmem_src) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem_src)
               : "memory");
}

// 16-byte global -> shared copy; both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* smem_dst, const float* gmem_src) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src)
               : "memory");
}

// Commit this thread's copies and wait for all of them. The caller then
// __syncthreads() so every thread sees every thread's copies.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The tile's row ids, read once from device memory with coalesced loads
// and range-checked here: an id outside [0, R) is staged as -1.
template <typename IdxT>
__device__ __forceinline__ void stage_row_ids(const IdxT* __restrict__ rows, int64_t t0,
                                              int n_rows, int64_t R, int64_t* s_rows) {
  for (int i = threadIdx.x; i < n_rows; i += blockDim.x) {
    const int64_t r = (int64_t)__ldg(rows + t0 + i);
    s_rows[i] = (r >= 0 && r < R) ? r : -1;
  }
}

// Calls f(e, i, c) for every element e = i * cols + c of an n_rows x cols
// tile, the block's threads on consecutive elements. (i, c) steps by
// blockDim.x elements with one carry, so there is one division per thread,
// not one per element.
template <typename F>
__device__ __forceinline__ void for_each_element(int n_rows, int cols, F f) {
  const int n = n_rows * cols;
  const int step_i = (int)blockDim.x / cols;
  const int step_c = (int)blockDim.x % cols;
  int i = (int)threadIdx.x / cols;
  int c = (int)threadIdx.x % cols;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    f(e, i, c);
    i += step_i;
    c += step_c;
    if (c >= cols) {
      c -= cols;
      ++i;
    }
  }
}

}  // namespace pbx
