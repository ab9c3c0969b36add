// Fused similarity + rank count + argmax for Hopper (sm_90a).
//
// Replaces multike_tpu/kernels/rank_kernel.py::rank_count_pallas (kernel
// body _rank_kernel). For every row i of e1:
//
//     s_ij       = e1_i . e2_j                  (float32, FFMA)
//     s_ij       = 2 s_ij - r2_j                (CSLS, when r2 is given)
//     count_i    = #{ j != gold_idx_i : s_ij > gold_i }
//     best_idx_i = first j of max_j s_ij,  best_val_i = that max
//
// The n1 x n2 score matrix never exists in memory.
//
// Bound: operations. 2 * n1 * n2 * d float32 operations against
// (n1 + n2) * d * 4 bytes of input: at d = 75 that is tens of thousands of
// operations per byte, far above the card's float32 ridge. The dot products
// run on the float32 FMA units, not on TF32 tensor cores: the rank counts
// compare scores that differ in the 5th-7th digit, and TF32 keeps about 3.
//
// Design. The TPU kernel walks a sequential grid axis over column blocks
// and carries the per-row counters in its output block. Here blocks run in
// no order, so one CTA owns BM rows for the whole sweep: it stages its rows
// of e1 once in shared memory (transposed), then walks all n2 columns in
// BN-wide tiles of e2 staged the same way. Each of the 256 threads computes
// a TM x TN register tile of scores from float4 reads of shared memory and
// folds it at once into per-row registers (count, best value, best index).
// After the sweep the 16 threads that share a row merge their counters
// with warp shuffles. No atomics, no second pass, no cross-block state.
//
// Tie rules, as the reference: strict ">" against gold; the gold column is
// excluded by index; the running best moves only on a strict ">" while
// each thread visits its columns in increasing order, and the merge keeps
// the smaller index on equal values, so the first index of the maximum
// wins. Rows past n1 and columns past n2 are masked by index.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, TM = 4, TN = 4;
constexpr int TX = BN / TN;                   // 16 thread columns
constexpr int THREADS = (BM / TM) * TX;       // 256
constexpr int LDA = BM + 4, LDB = BN + 4;     // padded, 16-byte aligned rows
constexpr int kMaxSmem = 227 * 1024;

// Copy rows [first, first + count) of src (row-major, d wide) into
// dst[k * ld + c] (transposed); rows past `limit` become zeros. Each warp
// takes a row at a time, lanes on consecutive k: coalesced global reads.
__device__ __forceinline__ void stage_transposed(
    float* dst, int ld, const float* __restrict__ src, int first, int count,
    int limit, int d) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c = warp; c < count; c += THREADS / 32) {
    const int row = first + c;
    const float* s = src + (long long)row * d;
    for (int k = lane; k < d; k += 32) {
      dst[k * ld + c] = row < limit ? s[k] : 0.f;
    }
  }
}

__global__ void __launch_bounds__(THREADS, 4)
rank_count_kernel(const float* __restrict__ e1, const float* __restrict__ e2,
                  const float* __restrict__ gold,
                  const int32_t* __restrict__ gold_idx,
                  const float* __restrict__ r2, int n1, int n2, int d,
                  int32_t* __restrict__ count, int32_t* __restrict__ best_idx,
                  float* __restrict__ best_val) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;              // [d][LDA]
  float* Bs = smem + d * LDA;    // [d][LDB]
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int row0 = blockIdx.x * BM;

  stage_transposed(As, LDA, e1, row0, BM, n1, d);

  float g[TM], bv[TM];
  int gi[TM], cnt[TM], bi[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty * TM + i;
    g[i] = row < n1 ? gold[row] : INFINITY;
    gi[i] = row < n1 ? gold_idx[row] : -1;
    cnt[i] = 0;
    bv[i] = -INFINITY;
    bi[i] = 0;
  }

  for (int col0 = 0; col0 < n2; col0 += BN) {
    __syncthreads();  // the previous tile is consumed
    stage_transposed(Bs, LDB, e2, col0, BN, n2, d);
    __syncthreads();

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll 4
    for (int k = 0; k < d; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k * LDA + ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k * LDB + tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bw[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }

#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx * TN + j;
      if (col < n2) {
        const float pen = r2 != nullptr ? r2[col] : 0.f;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          float s = acc[i][j];
          if (r2 != nullptr) s = 2.f * s - pen;
          cnt[i] += (s > g[i] && col != gi[i]) ? 1 : 0;
          if (s > bv[i]) {
            bv[i] = s;
            bi[i] = col;
          }
        }
      }
    }
  }

  // The TX threads of a row group are lanes of one half-warp.
#pragma unroll
  for (int off = TX / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      cnt[i] += __shfl_xor_sync(0xffffffffu, cnt[i], off);
      const float ov = __shfl_xor_sync(0xffffffffu, bv[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi[i], off);
      if (ov > bv[i] || (ov == bv[i] && oi < bi[i])) {
        bv[i] = ov;
        bi[i] = oi;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = row0 + ty * TM + i;
      if (row < n1) {
        count[row] = cnt[i];
        best_idx[row] = bi[i];
        best_val[row] = bv[i];
      }
    }
  }
}

}  // namespace

// e1: (n1, d), e2: (n2, d), gold: (n1,) float32; gold_idx: (n1,) int32;
// r2: (n2,) float32 or null; outputs count, best_idx (int32) and best_val
// (float32), each (n1,); stream: a cudaStream_t. Returns cudaGetLastError().
extern "C" int rank_count(const void* e1, const void* e2, const void* gold,
                          const void* gold_idx, const void* r2, int n1,
                          int n2, int d, void* count, void* best_idx,
                          void* best_val, void* stream) {
  const size_t smem = (size_t)(LDA + LDB) * d * sizeof(float);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rank_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (n1 > 0) {
    const int blocks = (n1 + BM - 1) / BM;
    rank_count_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)e1, (const float*)e2, (const float*)gold,
        (const int32_t*)gold_idx, (const float*)r2, n1, n2, d,
        (int32_t*)count, (int32_t*)best_idx, (float*)best_val);
  }
  return (int)cudaGetLastError();
}
