// The push merge: each unique row's sums of its keys' scaled gradients, and
// of their show and click counts, in a fixed order:
//     for u in [0, U): for k in order[offsets[u] .. offsets[u + 1]):
//         out[u, :W] += ((gflat[k, :] / grad_div) * slot_lr[slot(k)]) * mask(k)
//         out[u, W]  += valid(k)           valid(k) = mask(k) * ins_weight[ins(k)]
//         out[u, W + 1] += labels[ins(k)] * valid(k)
// where a key's segment seg = segments[k] gives mask 0 on the pad segment
// (seg >= S * b), ins = seg % b and slot = min(seg / b, S - 1). The division
// and the slot scale run only when given. Every (row, column) sum starts at
// 0.0f and adds its keys in merge order with no contraction (__fadd_rn,
// __fmul_rn, __fdiv_rn), so each sum has the bits of a lengths-based
// segment_reduce over the concatenated [L, W + 2] rows in that order, and
// out is laid out as that reduction's result is (the caller's guniq, show
// and clk are its column views).
//
// Replaces no TPU kernel: the JAX package leaves the merge to XLA (a
// segment sum), and the port ran it as five record-level PyTorch passes (a
// masked copy, a concatenation, a sort, a sorted gather and a segment
// reduction). It is the analog of the original's PushMergeCopy.
//
// What bounds it on the H100: bytes. It reads each key's gradient row once,
// with its order id and segment id, and writes each unique row's sums once:
// (L * (W * 4 + 8 + 4) + (U + 1) * 4 + U * (W + 2) * 4) bytes over
// 3.35 TB/s, about 3.2 ms at DLRM's step (L = 14.0 M, W = 131, U = 5.9 M).
// A key's row starts at any 4-byte offset (W is odd), so its read touches
// the 32-byte sectors it spans: about 6% more at W = 131, 60% at W = 13.
//
// Design: a unique row's keys lie anywhere in gflat, so every row read is a
// random one, and a row's sum is a chain that must take its keys in order.
// - Light rows (at most heavy_min keys): a group of G lanes (a power of two
//   from W: 16 at W = 13, 32 from W = 17) owns G consecutive unique rows,
//   whose keys are one contiguous stretch of the merge order. The group
//   walks that stretch as one stream, G keys at a time: each lane maps its
//   key to its row (a binary search over the group's running key counts)
//   and loads its order id, then its segment, from which it computes the
//   key's factors; the group loads P keys' rows at once (lane l holds
//   columns l, l + G, ..., NC of them in registers) and adds them in order,
//   storing a row's sums when the stream passes its end. The next chunk's
//   order ids, this chunk's segments and its first rows load together. So
//   P rows are in flight whatever the run lengths, and the sums stay in
//   registers. Rows wider than G * NC columns take more blocks along y,
//   each a slab of columns.
// - Heavy rows (more keys: a hot key, a slot of few values, the pad run):
//   one group would walk thousands of keys alone, so the light pass only
//   lists them, and a second kernel gives each one a whole block. The block
//   stages chunks of keys in shared memory with cp.async, HEAVY_STAGES - 1
//   chunks in flight ahead of the chunk it adds, one thread a column (one
//   more keeps show and clk); a chunk's order ids come the same way
//   IDS_AHEAD chunks earlier, so no chunk waits for its ids. A thread
//   scales HEAVY_BATCH keys' values before it adds them in order, so only
//   the adds form its chain.
//   One SM moves such a chain's rows at a few GB/s however deep its
//   pipeline, so a row is split by columns into items, each a block's (the
//   columns' sums are apart): one a slab_keys keys, up to max_slabs, and
//   never wider than the block, so a thread owns one column.
//   Blocks take items from a shared counter, so the longest rows do not
//   queue behind one another.
// Nothing is written twice and no sum uses atomics; the list's order varies
// from run to run, each row's bits do not.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface,
// loaded by paddlebox_tpu_torch/ops/cuda_kernels.py through ctypes, which
// also chooses G, NC, the heavy chunks and the grids (merge_geometry there).

#include "row_tile.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int HEAVY_STAGES = 4;  // chunks in shared memory: 3 in flight, 1 being added
constexpr int IDS_AHEAD = 4;  // a chunk's order ids load with the rows IDS_AHEAD chunks before
constexpr int IDS_RING = 8;  // chunks of order ids in shared memory: >= HEAVY_STAGES + IDS_AHEAD
constexpr int HEAVY_MAX_CK = 128;  // keys a chunk at most
constexpr int HEAVY_BATCH = 8;  // keys a thread scales before it adds them in order

struct MergeArgs {
  const float* gflat;       // [L, W]
  const int64_t* order;     // [L] merge order
  const int32_t* offsets;   // [U + 1] each row's first position in the order
  const int32_t* segments;  // [L] slot * b + ins, S * b on pad keys
  const float* labels;      // [b]
  const float* ins_weight;  // [b] or null
  const float* slot_lr;     // [S] or null
  float grad_div;
  int has_div;
  int64_t U;
  int W;
  int S;
  int b;
  int heavy_min;  // rows of more keys go to the heavy kernel
  int slab_keys;  // a heavy row takes a column slab for each slab_keys keys...
  int min_slabs;  // ...at least min_slabs (slabs of at most THREADS columns)...
  int max_slabs;  // ...and at most max_slabs
  float* out;     // [U, W + 2]: the sums, then show and clk
  int64_t* heavy;    // the heavy items, in no order: row * 1024 + slab * 32 + slabs
  int32_t* counters; // [2]: heavy items listed, heavy items taken
};

// 8-byte global -> shared copy, in flight until its group is waited for.
__device__ __forceinline__ void cp_async8(int64_t* smem_dst, const int64_t* gmem_src) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem_src) : "memory");
}

struct KeyFactors {
  float lr, mask, valid, lab;
};

__device__ __forceinline__ KeyFactors key_factors(const MergeArgs& a, int32_t seg) {
  KeyFactors f;
  const bool real = seg < a.S * a.b;
  const int ins = seg % a.b;
  f.mask = real ? 1.0f : 0.0f;
  f.lr = a.slot_lr != nullptr ? __ldg(a.slot_lr + min(seg / a.b, a.S - 1)) : 1.0f;
  f.valid = a.ins_weight != nullptr ? __fmul_rn(f.mask, __ldg(a.ins_weight + ins)) : f.mask;
  f.lab = __fmul_rn(__ldg(a.labels + ins), f.valid);
  return f;
}

// One gradient element as the plain code scales it: / grad_div, * lr, * mask.
__device__ __forceinline__ float scaled(const MergeArgs& a, float g, float lr, float mask) {
  if (a.has_div) g = __fdiv_rn(g, a.grad_div);
  if (a.slot_lr != nullptr) g = __fmul_rn(g, lr);
  return __fmul_rn(g, mask);
}

template <int G, int NC, int P>
__global__ void __launch_bounds__(THREADS) merge_light_kernel(MergeArgs a) {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G is a power of two up to 32");
  static_assert(P >= 1 && P <= G && (G % P) == 0, "P divides G");
  const int lane = threadIdx.x % G;
  const int base = (threadIdx.x % 32) / G * G;  // the group's first lane in its warp
  const unsigned gmask = G == 32 ? 0xffffffffu : (((1u << G) - 1u) << base);
  const int64_t u0 = ((int64_t)blockIdx.x * (THREADS / G) + threadIdx.x / G) * G;
  const int c0 = blockIdx.y * G * NC;
  const bool slab0 = blockIdx.y == 0;
  const bool counts = slab0 && lane == 0;  // the lane that keeps show and clk

  // lane j <-> unique row u0 + j
  const int64_t u = u0 + lane;
  int start = 0, n = 0;
  bool zero_row = false;
  if (u < a.U) {
    start = __ldg(a.offsets + u);
    const int len = __ldg(a.offsets + u + 1) - start;
    if (len > a.heavy_min) {
      if (slab0) {  // one item a column slab, as many as the keys ask for
        const int ns = max(a.min_slabs, min(a.max_slabs, 1 + (len - 1) / a.slab_keys));
        const int h = atomicAdd(a.counters, ns);
        for (int sl = 0; sl < ns; ++sl) a.heavy[h + sl] = u * 1024 + sl * 32 + ns;
      }
    } else {
      n = len;
      zero_row = len == 0;
    }
  }
  unsigned zeros = __ballot_sync(gmask, zero_row) >> base;
  while (zeros) {
    const int j = __ffs(zeros) - 1;
    zeros &= zeros - 1;
    float* dst = a.out + (u0 + j) * (a.W + 2);
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int col = c0 + lane + q * G;
      if (col < a.W) dst[col] = 0.0f;
    }
    if (counts) {
      dst[a.W] = 0.0f;
      dst[a.W + 1] = 0.0f;
    }
  }

  // the light rows' keys as one stream: lane j's row covers positions
  // [incl - n, incl) of it
  int incl = n;
#pragma unroll
  for (int d = 1; d < G; d <<= 1) {
    const int y = __shfl_up_sync(gmask, incl, d, G);
    if (lane >= d) incl += y;
  }
  const int total = __shfl_sync(gmask, incl, G - 1, G);
  const int excl = incl - n;

  float acc[NC];
  float s_acc = 0.0f, c_acc = 0.0f;
  int cur = -1;  // the row being summed, as its lane index

  auto flush = [&]() {
    float* dst = a.out + (u0 + cur) * (a.W + 2);
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int col = c0 + lane + q * G;
      if (col < a.W) dst[col] = acc[q];
    }
    if (counts) {
      dst[a.W] = s_acc;
      dst[a.W + 1] = c_acc;
    }
  };

  // this lane's key of the stream chunk at tb: its row (the first lane
  // whose running count passes t) and its order id
  auto map_key = [&](int tb, long long& ord, int& j) {
    const int t = tb + lane;
    j = 0;
#pragma unroll
    for (int step = G / 2; step >= 1; step >>= 1) {
      if (__shfl_sync(gmask, incl, j + step - 1, G) <= t) j += step;
    }
    const int row_start = __shfl_sync(gmask, start, j, G);
    const int row_excl = __shfl_sync(gmask, excl, j, G);
    ord = t < total ? __ldg(a.order + row_start + (t - row_excl)) : 0;
  };
  long long ord = 0;
  int j = 0;
  if (total > 0) map_key(0, ord, j);
  for (int tb = 0; tb < total; tb += G) {
    // in flight together: this chunk's segments, the next chunk's order
    // ids and this chunk's first rows; the factors wait for the segments
    const int32_t seg = tb + lane < total ? __ldg(a.segments + ord) : 0;
    long long ord_next = 0;
    int j_next = 0;
    if (tb + G < total) map_key(tb + G, ord_next, j_next);
    KeyFactors f;
    const int cnt = min(G, total - tb);
    for (int p0 = 0; p0 < cnt; p0 += P) {
      float v[P][NC];
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const long long k = __shfl_sync(gmask, ord, p0 + q, G);
        const float* src = a.gflat + k * a.W;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = c0 + lane + c * G;
          v[q][c] = (p0 + q < cnt && col < a.W) ? __ldg(src + col) : 0.0f;
        }
      }
      if (p0 == 0) f = key_factors(a, seg);
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const int src_lane = p0 + q;
        const int jq = __shfl_sync(gmask, j, src_lane, G);
        const float lr = __shfl_sync(gmask, f.lr, src_lane, G);
        const float mask = __shfl_sync(gmask, f.mask, src_lane, G);
        const float valid = __shfl_sync(gmask, f.valid, src_lane, G);
        const float lab = __shfl_sync(gmask, f.lab, src_lane, G);
        if (src_lane < cnt) {
          if (jq != cur) {
            if (cur >= 0) flush();
            cur = jq;
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[c] = 0.0f;
            s_acc = 0.0f;
            c_acc = 0.0f;
          }
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[c] = __fadd_rn(acc[c], scaled(a, v[q][c], lr, mask));
          s_acc = __fadd_rn(s_acc, valid);
          c_acc = __fadd_rn(c_acc, lab);
        }
      }
    }
    ord = ord_next;
    j = j_next;
  }
  if (cur >= 0) flush();
}

// Shared memory of the heavy kernel: IDS_RING x [HEAVY_MAX_CK int64 order
// ids], HEAVY_STAGES x [HEAVY_MAX_CK int32 segments], 4 x [HEAVY_MAX_CK
// float factors], HEAVY_STAGES x [stage_floats float rows]. An item of w
// columns takes chunks of min(HEAVY_MAX_CK, stage_floats / w) keys.
__host__ __device__ inline size_t heavy_smem_bytes(int stage_floats) {
  return (size_t)HEAVY_MAX_CK * (IDS_RING * 8 + HEAVY_STAGES * 4 + 4 * 4) +
         (size_t)HEAVY_STAGES * stage_floats * 4;
}

__global__ void __launch_bounds__(THREADS) merge_heavy_kernel(MergeArgs a, int stage_floats) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* s_ord = reinterpret_cast<int64_t*>(smem);
  int32_t* s_seg = reinterpret_cast<int32_t*>(s_ord + IDS_RING * HEAVY_MAX_CK);
  float* s_lr = reinterpret_cast<float*>(s_seg + HEAVY_STAGES * HEAVY_MAX_CK);
  float* s_mask = s_lr + HEAVY_MAX_CK;
  float* s_valid = s_mask + HEAVY_MAX_CK;
  float* s_lab = s_valid + HEAVY_MAX_CK;
  float* s_rows = s_lab + HEAVY_MAX_CK;
  __shared__ long long s_item;

  const int W = a.W;
  const int tid = threadIdx.x;
  const int counter_tid = THREADS - 1;  // keeps show and clk
  const int n_heavy = *(volatile int32_t*)a.counters;

  while (true) {
    if (tid == 0) {
      const int h = atomicAdd(a.counters + 1, 1);
      s_item = h < n_heavy ? a.heavy[h] : -1;
    }
    __syncthreads();
    const long long item = s_item;
    __syncthreads();  // s_item is read before the next item's claim
    if (item < 0) return;
    const int64_t u = item >> 10;
    const int slab = (int)(item >> 5) & 31, n_slabs = (int)item & 31;
    const int c_lo = slab * W / n_slabs;
    const int w = (slab + 1) * W / n_slabs - c_lo;  // this item's columns
    const bool counts = slab == 0;  // the first slab's block keeps show and clk
    const int ck = min(HEAVY_MAX_CK, stage_floats / w);

    const int start = __ldg(a.offsets + u);
    const int n = __ldg(a.offsets + u + 1) - start;
    const int nch = (n + ck - 1) / ck;
    auto keys_in = [&](int c) { return min(ck, n - c * ck); };
    // chunk c's order ids into their ring slot (cp.async, 8 bytes a key)
    auto issue_ids = [&](int c) {
      if (c < nch && tid < keys_in(c)) {
        cp_async8(s_ord + (c % IDS_RING) * HEAVY_MAX_CK + tid, a.order + start + (int64_t)c * ck + tid);
      }
    };
    // chunk c's rows and segments from its staged order ids, and chunk
    // c + IDS_AHEAD's ids: one commit group a chunk, even an empty one
    auto issue = [&](int c) {
      if (c < nch) {
        const int st = c % HEAVY_STAGES;
        const int nk = keys_in(c);
        const int64_t* ids = s_ord + (c % IDS_RING) * HEAVY_MAX_CK;
        float* rows = s_rows + (size_t)st * stage_floats;
        pbx::for_each_element(nk, w, [&](int e, int i, int col) {
          pbx::cp_async4(rows + e, a.gflat + ids[i] * W + c_lo + col);
        });
        if (tid < nk) {
          pbx::cp_async4(reinterpret_cast<float*>(s_seg + st * HEAVY_MAX_CK + tid),
                         reinterpret_cast<const float*>(a.segments + ids[tid]));
        }
      }
      issue_ids(c + IDS_AHEAD);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    };

    // the first IDS_AHEAD chunks' ids, then the first stages' rows
    for (int c = 0; c < IDS_AHEAD; ++c) issue_ids(c);
    pbx::cp_async_wait_all();
    __syncthreads();
    for (int c = 0; c < HEAVY_STAGES - 1; ++c) issue(c);

    float acc = 0.0f, s_acc = 0.0f, c_acc = 0.0f;  // this thread's column tid, show, clk

    for (int c = 0; c < nch; ++c) {
      // chunk c + STAGES - 1 goes into the stage chunk c - 1 left; its ids
      // came with the group of chunk c + STAGES - 1 - IDS_AHEAD, which the
      // last wait saw complete. Then chunk c's group completes.
      issue(c + HEAVY_STAGES - 1);
      asm volatile("cp.async.wait_group %0;\n" ::"n"(HEAVY_STAGES - 1) : "memory");
      __syncthreads();

      const int st = c % HEAVY_STAGES;
      const int nk = keys_in(c);
      const int32_t* segs = s_seg + st * HEAVY_MAX_CK;
      if (tid < nk) {
        const KeyFactors f = key_factors(a, segs[tid]);
        s_lr[tid] = f.lr;
        s_mask[tid] = f.mask;
        s_valid[tid] = f.valid;
        s_lab[tid] = f.lab;
      }
      __syncthreads();
      const float* rows = s_rows + (size_t)st * stage_floats;
      if (tid < w) {
        // HEAVY_BATCH keys' scaled values at a time, then their adds in order
        int i = 0;
        for (; i + HEAVY_BATCH <= nk; i += HEAVY_BATCH) {
          float x[HEAVY_BATCH];
#pragma unroll
          for (int k = 0; k < HEAVY_BATCH; ++k) x[k] = scaled(a, rows[(i + k) * w + tid], s_lr[i + k], s_mask[i + k]);
#pragma unroll
          for (int k = 0; k < HEAVY_BATCH; ++k) acc = __fadd_rn(acc, x[k]);
        }
        for (; i < nk; ++i) acc = __fadd_rn(acc, scaled(a, rows[i * w + tid], s_lr[i], s_mask[i]));
      }
      if (counts && tid == counter_tid) {
        int i = 0;
        for (; i + HEAVY_BATCH <= nk; i += HEAVY_BATCH) {
          float v[HEAVY_BATCH], l[HEAVY_BATCH];
#pragma unroll
          for (int k = 0; k < HEAVY_BATCH; ++k) {
            v[k] = s_valid[i + k];
            l[k] = s_lab[i + k];
          }
#pragma unroll
          for (int k = 0; k < HEAVY_BATCH; ++k) {
            s_acc = __fadd_rn(s_acc, v[k]);
            c_acc = __fadd_rn(c_acc, l[k]);
          }
        }
        for (; i < nk; ++i) {
          s_acc = __fadd_rn(s_acc, s_valid[i]);
          c_acc = __fadd_rn(c_acc, s_lab[i]);
        }
      }
      __syncthreads();  // the stage and the factors are free again
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");

    float* row = a.out + u * (W + 2);
    if (tid < w) row[c_lo + tid] = acc;
    if (counts && tid == counter_tid) {
      row[W] = s_acc;
      row[W + 1] = c_acc;
    }
  }
}

template <int G, int NC>
cudaError_t launch_light(const MergeArgs& a, int slabs, cudaStream_t stream) {
  constexpr int P = G < (NC <= 2 ? 16 : 8) ? G : (NC <= 2 ? 16 : 8);
  const int64_t rows_a_block = THREADS;  // THREADS / G groups of G rows
  const dim3 grid((unsigned)((a.U + rows_a_block - 1) / rows_a_block), (unsigned)slabs);
  merge_light_kernel<G, NC, P><<<grid, THREADS, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int G>
cudaError_t launch_light_g(const MergeArgs& a, int nc, int slabs, cudaStream_t stream) {
  if constexpr (G < 32) {
    return launch_light<G, 1>(a, slabs, stream);
  } else {
    switch (nc) {
      case 1: return launch_light<32, 1>(a, slabs, stream);
      case 2: return launch_light<32, 2>(a, slabs, stream);
      case 3: return launch_light<32, 3>(a, slabs, stream);
      case 4: return launch_light<32, 4>(a, slabs, stream);
      case 5: return launch_light<32, 5>(a, slabs, stream);
      case 6: return launch_light<32, 6>(a, slabs, stream);
      case 7: return launch_light<32, 7>(a, slabs, stream);
      case 8: return launch_light<32, 8>(a, slabs, stream);
      default: return cudaErrorInvalidValue;
    }
  }
}

cudaError_t launch_heavy(const MergeArgs& a, int stage_floats, int grid, cudaStream_t stream) {
  const size_t smem = heavy_smem_bytes(stage_floats);
  cudaError_t rc = cudaFuncSetAttribute(merge_heavy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        (int)smem);
  if (rc != cudaSuccess) return rc;
  merge_heavy_kernel<<<grid, THREADS, smem, stream>>>(a, stage_floats);
  return cudaGetLastError();
}

}  // namespace

// The whole merge on `stream`: zero the two counters, the light pass (one
// group a G unique rows, `slabs` column slabs), then the heavy pass
// (`heavy_grid` blocks, chunks of stage_floats floats; a heavy row of n keys is
// max(min_slabs, min(max_slabs, ceil(n / slab_keys))) items of its
// columns, min_slabs = ceil(W / 256) <= max_slabs <= 31). heavy and counters
// are scratch: int64 [U * min_slabs + L / slab_keys + 1] and int32 [2]. G is
// a power of two up to 32; nc = ceil(W / G) up to 8 where G is 32, else 1.
extern "C" int pbx_merge_rows_f32(const float* gflat, const long long* order, const int* offsets,
                                  const int* segments, const float* labels, const float* ins_weight,
                                  const float* slot_lr, float grad_div, int has_div, long long U, int W,
                                  int S, int b, float* out, long long* heavy,
                                  int* counters, int G, int nc, int slabs, int heavy_min, int slab_keys,
                                  int min_slabs, int max_slabs, int stage_floats, int heavy_grid,
                                  cudaStream_t stream) {
  if (U <= 0) return (int)cudaSuccess;
  if (W < 1 || b < 1 || S < 1 || slab_keys < 1 || min_slabs < (W + THREADS - 1) / THREADS ||
      max_slabs < min_slabs || max_slabs > 31 || stage_floats < THREADS || U >= (1LL << 53)) {
    return (int)cudaErrorInvalidValue;
  }
  MergeArgs a{gflat, (const int64_t*)order, offsets, segments, labels, ins_weight, slot_lr,
              grad_div, has_div, (int64_t)U, W, S, b, heavy_min, slab_keys, min_slabs, max_slabs, out,
              (int64_t*)heavy, counters};
  cudaError_t rc = cudaMemsetAsync(counters, 0, 2 * sizeof(int), stream);
  if (rc != cudaSuccess) return (int)rc;
  switch (G) {
    case 1: rc = launch_light_g<1>(a, nc, slabs, stream); break;
    case 2: rc = launch_light_g<2>(a, nc, slabs, stream); break;
    case 4: rc = launch_light_g<4>(a, nc, slabs, stream); break;
    case 8: rc = launch_light_g<8>(a, nc, slabs, stream); break;
    case 16: rc = launch_light_g<16>(a, nc, slabs, stream); break;
    case 32: rc = launch_light_g<32>(a, nc, slabs, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != cudaSuccess) return (int)rc;
  return (int)launch_heavy(a, stage_floats, heavy_grid, stream);
}
