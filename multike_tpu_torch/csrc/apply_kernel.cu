// Row-sparse Adagrad apply for Hopper (sm_90a): the whole step, from the
// per-occurrence gradients of a batch's ids to the updated rows.
//
// Replaces the TPU kernel multike_tpu/kernels/apply_kernel.py::
// fused_row_adagrad_pallas (kernel body _apply_kernel) together with the
// sort and segment-sum that feed it in multike_tpu/train/sparse_adagrad.py::
// row_apply(..., use_pallas=True). For every row r in
// [row_offset, row_offset + rows) that ids touches, with gsum the sum of the
// rows of g_rows at its occurrences:
//
//     acc[r]   += gsum * gsum
//     param[r] -= lr * ((acc[r] > 0 ? 1 / sqrt(acc[r] + eps) : 0) * gsum)
//
// Ids outside the range do nothing (a row shard of a larger table).
//
// Why there is no sort. The JAX package sorts the ids and segment-sums the
// sorted rows because on the TPU XLA's scatters serialize (about 30 ns a
// row), so a sort-free scatter dedup lost to the sort there. On Hopper the
// trade-off runs the other way: integer atomics on distinct addresses are
// cheap, and a multi-pass radix sort over the N ids is the expensive part.
// Four launches, one thread per occurrence or per touched row:
//   1. count: each occurrence adds 1 to its row's int32 counter; the value
//      it read is its place in the row's bucket. The first occurrence of a
//      row appends the row to the touched list (one atomic a block).
//   2. place: each touched row takes a bucket of its count from one cursor
//      (one atomic a block), notes the bucket's start by the row, and sets
//      its counter back to 0, so the counters are zero on the next call
//      without a memset of `rows` entries.
//      Buckets past kGroup go on a list of large buckets.
//   3. fill: each occurrence writes its own index into its row's bucket.
//   4. apply: a group of kGroup lanes per touched row (two rows a warp)
//      orders its bucket's occurrence indices ascending (a rank by
//      comparison over the group), sums those rows of g_rows in that order
//      from 0 and applies the update. A bucket past kGroup takes a block,
//      which orders it through a bitmap in shared memory.
// No float atomics: each row's sum is taken by one group or one block in
// ascending occurrence order, which is the order of the plain version (a
// stable sort, then a sequential index_add_ from 0). So the result is
// bitwise the plain version's on the CPU, and the same on every run.
// gsum never goes to device memory, and U stays on the device.
//
// Bound: bytes. The ids (8 bytes) and the gradient row (4 d bytes) of each
// of the N occurrences are read once; each of the U touched rows of param
// and acc is read and written once: N * (8 + 4 d) + 16 U d bytes. The
// arithmetic is a handful of operations an element. The scratch traffic
// (about 30 bytes an occurrence, most of it in L2) is a few percent of the
// bound at d = 75. Rows are 4 d bytes apart (300 at d = 75, not 16-byte
// aligned), so the loads are scalar; each lane keeps kCols columns and
// kDepth occurrences' loads in flight. The apply pass takes most of the
// time, waiting on its chain of dependent loads (slot, bucket, rows), so a
// warp applies two rows at once: the main path's rows are d = 75 wide,
// 5 columns a lane.
//
// Rounding: the products and sums are written with the _rn intrinsics, so
// nvcc contracts nothing into an FMA, and 1 / sqrt is rounded as the CPU's
// torch.rsqrt rounds it (a correctly rounded sqrt, then a correctly
// rounded division; rsqrt_as_cpu).

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;               // every launch
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroup = 16;                  // lanes that apply one row
constexpr int kGroups = 32 / kGroup;        // rows a warp applies at once
constexpr int kBitmapWords = 1024;          // 32,768 occurrences a window
constexpr int kBitmapBits = kBitmapWords * 32;
constexpr int kLargeBlocks = 132;           // blocks for the large buckets
constexpr int kMaxWarpBlocks = 4096;
constexpr int kCols = 2;                    // columns a lane keeps in flight
constexpr int kDepth = 4;                   // occurrences loaded at once

// counters (int32, zero on entry, restored to zero by the fill pass except
// the two copies that the apply pass reads)
enum { kTouched, kCursor, kLarge, kSlots, kLarges, kNumCounters };

// Exclusive prefix sum of x over the block (.x) and the block's sum (.y).
// Every thread of the block must call it.
__device__ __forceinline__ int2 block_exclusive_scan(int x) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int inc = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? warp_sums[lane] : 0;
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) warp_sums[lane] = s;
  }
  __syncthreads();
  const int before = warp ? warp_sums[warp - 1] : 0;
  const int total = warp_sums[kWarps - 1];
  __syncthreads();                          // warp_sums is reused
  return make_int2(before + inc - x, total);
}

__global__ void __launch_bounds__(kThreads)
count_kernel(const int64_t* __restrict__ ids, long long id_stride, int n,
             long long row_offset, int rows, int* __restrict__ cnt, int* __restrict__ counters,
             int* __restrict__ rank, int* __restrict__ touched) {
  __shared__ int base;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  int r = -1, first = 0;
  if (i < n) {
    const long long g = ids[i * id_stride] - row_offset;
    if (g >= 0 && g < rows) {
      r = (int)g;
      const int before = atomicAdd(cnt + r, 1);
      rank[i] = before;
      first = before == 0;
    }
  }
  const int2 scan = block_exclusive_scan(first);
  if (threadIdx.x == 0 && scan.y) base = atomicAdd(counters + kTouched, scan.y);
  __syncthreads();
  if (first) touched[base + scan.x] = r;
}

__global__ void __launch_bounds__(kThreads)
place_kernel(int* __restrict__ cnt, int* __restrict__ row_start,
             int* __restrict__ counters, const int* __restrict__ touched,
             int* __restrict__ slot_start, int* __restrict__ slot_count,
             int* __restrict__ large) {
  __shared__ int base;
  const int n_touched = counters[kTouched];
  if ((int)blockIdx.x * kThreads >= n_touched) return;  // the whole block
  const int t = blockIdx.x * kThreads + threadIdx.x;
  int c = 0, r = 0;
  if (t < n_touched) {
    r = touched[t];
    c = cnt[r];
    cnt[r] = 0;
  }
  const int2 scan = block_exclusive_scan(c);
  if (threadIdx.x == 0) base = atomicAdd(counters + kCursor, scan.y);
  __syncthreads();
  if (t < n_touched) {
    slot_start[t] = row_start[r] = base + scan.x;
    slot_count[t] = c;
    if (c > kGroup) large[atomicAdd(counters + kLarge, 1)] = t;
  }
}

__global__ void __launch_bounds__(kThreads)
fill_kernel(const int64_t* __restrict__ ids, long long id_stride, int n,
            long long row_offset, int rows, const int* __restrict__ row_start,
            const int* __restrict__ rank, int* __restrict__ bucket,
            int* __restrict__ counters) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) {
    const long long g = ids[i * id_stride] - row_offset;
    if (g >= 0 && g < rows) bucket[row_start[(int)g] + rank[i]] = i;
  }
  if (i == 0) {                   // no thread of this pass reads them
    counters[kSlots] = counters[kTouched];
    counters[kLarges] = counters[kLarge];
    counters[kTouched] = counters[kCursor] = counters[kLarge] = 0;
  }
}

// The float next to a positive float y, above (step 1) or below (-1).
__device__ __forceinline__ float step(float y, int k) {
  return __int_as_float(__float_as_int(y) + k);
}

// The float nearest to sqrt(x), x positive and normal, from an estimate
// within a few ulp: each neighbouring midpoint is compared with x exactly
// in double (a midpoint has 25 significant bits, its square 50).
__device__ __forceinline__ float sqrt_rn(float x) {
  float y = x * rsqrtf(x);
  const double xd = x;
  for (int i = 0; i < 4; ++i) {
    const double up = 0.5 * ((double)y + (double)step(y, 1));
    const double dn = 0.5 * ((double)y + (double)step(y, -1));
    if (up * up <= xd) y = step(y, 1);
    else if (dn * dn > xd) y = step(y, -1);
  }
  return y;
}

// The float nearest to 1 / y, y positive with a normal reciprocal, the
// same way (y times a midpoint has 49 significant bits).
__device__ __forceinline__ float rcp_rn(float y) {
  float r = __fdividef(1.f, y);
  const double yd = y;
  for (int i = 0; i < 4; ++i) {
    const double up = 0.5 * ((double)r + (double)step(r, 1));
    const double dn = 0.5 * ((double)r + (double)step(r, -1));
    if (yd * up < 1.0) r = step(r, 1);
    else if (yd * dn > 1.0) r = step(r, -1);
  }
  return r;
}

// 1 / sqrt(x) with the square root and the division each correctly
// rounded, as torch.rsqrt on the CPU. (__fdiv_rn and __fsqrt_rn give the
// same, but their slow paths are calls that take a stack frame.)
__device__ __forceinline__ float rsqrt_as_cpu(float x) {
  if (x > 0.f && x < INFINITY) {
    const float y = x >= FLT_MIN ? sqrt_rn(x)
                                 : sqrt_rn(x * 16777216.f) * (1.f / 4096.f);
    return rcp_rn(y);           // y is in [2^-75, 2^64]
  }
  if (x == 0.f) return __int_as_float(__float_as_int(x) | 0x7f800000);
  return x == INFINITY ? 0.f : __int_as_float(0x7fffffff);
}

// Sums the rows idx[0..c) of g_rows, in that order from 0, at the columns
// j0, j0 + stride, ... of the row, and applies the update to p and a.
__device__ __forceinline__ void apply_row(
    float* __restrict__ p, float* __restrict__ a,
    const float* __restrict__ g_rows, const int* idx, int c, int d, int j0,
    int stride, float lr, float eps) {
  for (int jb = j0; jb < d; jb += kCols * stride) {
    float gs[kCols], av[kCols], pv[kCols];
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int j = jb + u * stride;
      gs[u] = 0.f;
      av[u] = j < d ? a[j] : 0.f;
      pv[u] = j < d ? p[j] : 0.f;
    }
    int k = 0;
    for (; k + kDepth <= c; k += kDepth) {
      float v[kDepth][kCols];
#pragma unroll
      for (int q = 0; q < kDepth; ++q) {
        const float* g = g_rows + (long long)idx[k + q] * d;
#pragma unroll
        for (int u = 0; u < kCols; ++u) {
          const int j = jb + u * stride;
          v[q][u] = j < d ? g[j] : 0.f;
        }
      }
#pragma unroll
      for (int q = 0; q < kDepth; ++q)
#pragma unroll
        for (int u = 0; u < kCols; ++u) gs[u] = __fadd_rn(gs[u], v[q][u]);
    }
    for (; k < c; ++k) {
      const float* g = g_rows + (long long)idx[k] * d;
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int j = jb + u * stride;
        if (j < d) gs[u] = __fadd_rn(gs[u], g[j]);
      }
    }
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const int j = jb + u * stride;
      if (j < d) {
        const float aj = __fadd_rn(av[u], __fmul_rn(gs[u], gs[u]));
        a[j] = aj;
        const float s = aj > 0.f ? rsqrt_as_cpu(__fadd_rn(aj, eps)) : 0.f;
        p[j] = __fsub_rn(pv[u], __fmul_rn(lr, __fmul_rn(s, gs[u])));
      }
    }
  }
}

// Writes the c distinct occurrence indices of `in` (all in [0, n)) to `out`
// in ascending order: for each window of kBitmapBits indices, the block
// marks the bucket's members in a bitmap and each thread writes the set
// bits of its kBitmapWords / kThreads words at its prefix-sum position.
__device__ __forceinline__ void order_large_bucket(const int* in, int c, int* out, int n,
                                   unsigned* bits) {
  constexpr int kOwn = kBitmapWords / kThreads;
  int written = 0;
  for (int w0 = 0; w0 < n; w0 += kBitmapBits) {
    for (int q = threadIdx.x; q < kBitmapWords; q += kThreads) bits[q] = 0u;
    __syncthreads();
    for (int k = threadIdx.x; k < c; k += kThreads) {
      const int v = in[k] - w0;
      if (v >= 0 && v < kBitmapBits) atomicOr(bits + v / 32, 1u << (v % 32));
    }
    __syncthreads();
    unsigned own[kOwn];
    int mine = 0;
#pragma unroll
    for (int q = 0; q < kOwn; ++q) {
      own[q] = bits[threadIdx.x * kOwn + q];
      mine += __popc(own[q]);
    }
    const int2 scan = block_exclusive_scan(mine);
    int pos = written + scan.x;
#pragma unroll
    for (int q = 0; q < kOwn; ++q) {
      for (unsigned b = own[q]; b; b &= b - 1)
        out[pos++] = w0 + (threadIdx.x * kOwn + q) * 32 + __ffs(b) - 1;
    }
    written += scan.y;
  }
}

// Blocks [0, kLargeBlocks) take the large buckets, a block each; the rest
// take the others, a group of lanes each.
__global__ void __launch_bounds__(kThreads)
apply_kernel(float* __restrict__ param, float* __restrict__ acc,
             const float* __restrict__ g_rows, int n, int d, float lr,
             float eps, const int* __restrict__ counters,
             const int* __restrict__ touched,
             const int* __restrict__ slot_start,
             const int* __restrict__ slot_count,
             const int* __restrict__ bucket, const int* __restrict__ large,
             int* __restrict__ ordered) {
  __shared__ int warp_idx[kWarps][32];
  __shared__ unsigned bits[kBitmapWords];
  if (blockIdx.x < kLargeBlocks) {
    const int n_large = counters[kLarges];
    for (int l = blockIdx.x; l < n_large; l += kLargeBlocks) {
      const int t = large[l], c = slot_count[t], start = slot_start[t];
      order_large_bucket(bucket + start, c, ordered + start, n, bits);
      __syncthreads();                    // `ordered` written by the block
      const long long r = touched[t];
      apply_row(param + r * d, acc + r * d, g_rows, ordered + start, c, d,
                threadIdx.x, kThreads, lr, eps);
    }
    return;
  }
  // each group of kGroup lanes takes a row; the warp stays converged for
  // the shuffles, so every lane runs every loop of them
  const int n_slots = counters[kSlots];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int group = lane / kGroup, gl = lane % kGroup;
  const int step = (gridDim.x - kLargeBlocks) * kWarps * kGroups;
  int* idx = warp_idx[warp] + group * kGroup;
  for (int t0 = ((blockIdx.x - kLargeBlocks) * kWarps + warp) * kGroups;
       t0 < n_slots; t0 += step) {
    const int t = t0 + group;
    int c = t < n_slots ? slot_count[t] : 0;
    if (c > kGroup) c = 0;           // a large bucket: a block's work
    const int v = gl < c ? bucket[slot_start[t] + gl] : INT_MAX;
    int place = 0;                        // the indices are distinct
    for (int q = 0; q < kGroup; ++q) {
      const int w = __shfl_sync(kFull, v, q, kGroup);
      place += q < c && w < v;
    }
    if (gl < c) idx[place] = v;
    __syncwarp();
    if (c > 0) {
      const long long r = touched[t];
      apply_row(param + r * d, acc + r * d, g_rows, idx, c, d, gl, kGroup,
                lr, eps);
    }
    __syncwarp();                         // warp_idx is reused
  }
}

}  // namespace

// param, acc: (rows, d) float32, updated in place; ids: (n,) int64, id_stride
// elements apart; g_rows: (n, d) float32. counts: int32 (kNumCounters + rows), zero on
// entry and left zero on exit; row_start: int32 (rows) and work: int32
// (6 n), any contents. stream: a cudaStream_t. Returns cudaGetLastError().
extern "C" int row_adagrad(void* param, void* acc, const void* ids,
                           long long id_stride, const void* g_rows, int n,
                           long long row_offset,
                           int rows, int d, float lr, float eps, void* counts,
                           void* row_start_, void* work, void* stream) {
  if (n > 0 && rows > 0 && d > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    int* counters = (int*)counts;
    int* cnt = counters + kNumCounters;
    int* row_start = (int*)row_start_;
    int* rank = (int*)work;            // then, in the apply pass, `ordered`
    int* touched = rank + n;
    int* slot_start = touched + n;
    int* slot_count = slot_start + n;
    int* bucket = slot_count + n;
    int* large = bucket + n;
    const int blocks = (n + kThreads - 1) / kThreads;
    const int64_t* id = (const int64_t*)ids;
    count_kernel<<<blocks, kThreads, 0, s>>>(id, id_stride, n, row_offset,
                                             rows, cnt, counters, rank,
                                             touched);
    place_kernel<<<blocks, kThreads, 0, s>>>(cnt, row_start, counters,
                                             touched, slot_start, slot_count,
                                             large);
    fill_kernel<<<blocks, kThreads, 0, s>>>(id, id_stride, n, row_offset,
                                            rows, row_start, rank, bucket,
                                            counters);
    const int most = n < rows ? n : rows;  // touched rows, at most
    int warp_blocks = (most + kWarps * kGroups - 1) / (kWarps * kGroups);
    if (warp_blocks > kMaxWarpBlocks) warp_blocks = kMaxWarpBlocks;
    apply_kernel<<<kLargeBlocks + warp_blocks, kThreads, 0, s>>>(
        (float*)param, (float*)acc, (const float*)g_rows, n, d, lr, eps,
        counters, touched, slot_start, slot_count, bucket, large, rank);
  }
  return (int)cudaGetLastError();
}
