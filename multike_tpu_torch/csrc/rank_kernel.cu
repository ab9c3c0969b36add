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
// Bound: operations. 2 n1 n2 d float32 operations against (n1 + n2) d 4
// bytes of input: at d = 75 and tens of thousands of rows that is
// thousands of operations per byte, far above the card's float32 ridge.
// The products are float32 FFMA with k in increasing order, not TF32 on the
// tensor cores: the rank count is exact and compares scores that differ in
// the 5th-7th digit, and TF32 keeps about 3.
//
// Inputs. A first small kernel copies e1 and e2 into k-major forms padded
// with zeros, in a workspace that the wrapper allocates: e1t (dp, ld1) and
// e2t (dp, ld2), with dp = d rounded up to 4 and ld1, ld2 the row counts
// rounded up to the 128-wide tile; r2 is padded to ld2 beside them. A
// tile's slice of one k row is then 512 contiguous, 16-byte aligned bytes
// that cp.async copies into shared memory as they lie, with no transposing
// stores. Zero rows of k add nothing to a score; padded rows and columns
// are masked by index.
//
// Work plan. The plane of (128-row block, 128-column tile) pairs is
// flattened row block by row block and cut into one contiguous range of
// tiles per CTA; the grid is one CTA per resident slot (occupancy x SMs),
// so every CTA gets within one tile of the same work at any shape and all
// of them run in a single wave. A CTA walks its range in segments, one per
// row block it touches. For each it stages the block's rows of e1t once,
// with their gold scores and gold columns, and streams the segment's
// column tiles of e2t, KC rows of k at a time, through a STAGES-deep ring
// of cp.async groups: the next chunks land while the current one is
// computed. Each of the 256 threads keeps an 8 x 8 register tile, fed for
// each k by four LDS.128 without bank conflicts (rows ty*4 and 64 + ty*4,
// columns tx*4 and 64 + tx*4): 64 FFMA per 4 shared loads. When a tile is
// complete its scores fold into the thread's per-row count and best, which
// wait in shared memory between tiles: in registers they pushed the kernel
// past the 128 registers that 2 CTAs per SM allow, and it spilled. The
// column mask and the gold-column test run only for a tile that holds the
// end of n2 or a gold column of the block; CSLS is a template argument.
//
// Merge. At a segment's end the 16 threads of a row merge by shuffles, and
// one of them merges the row into the outputs across CTAs: the count by
// atomicAdd into `count` (zeroed first), the best by atomicMax on a 64-bit
// key whose high word maps the score to an order-preserving integer and
// whose low word is ~column. A second kernel unpacks the keys into best_idx
// and best_val. Integer sums and maxima do not depend on order, so the
// outputs are bitwise equal from run to run.
//
// Tie rules, as the reference: strict ">" against gold; the gold column is
// excluded by index; the first index of the maximum wins (in a thread,
// columns are visited in increasing order and the best moves only on a
// strict ">"; every merge keeps the smaller column on equal scores). -0.0
// becomes +0.0 before packing, so a +0.0 at a later column does not beat a
// -0.0 at an earlier one.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128;            // rows and columns of a tile
constexpr int TM = 8, TN = 8;                // register tile of a thread
constexpr int TX = BN / TN, TY = BM / TM;    // 16 x 16 threads
constexpr int THREADS = TX * TY;             // 256
constexpr int KC = 16;                       // rows of k in a ring stage
constexpr int STAGES = 3;
constexpr int STAGE_FLOATS = KC * BN + BN;   // a chunk of e2t, then r2
constexpr int NO_COL = 0x7fffffff;           // "no column seen yet"
constexpr size_t kMaxSmem = 227 * 1024;

size_t smem_bytes(int dp) {
  return sizeof(float) * ((size_t)dp * BM + 2 * BM +
                          (size_t)STAGES * STAGE_FLOATS + 3 * TM * THREADS);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Tile-local row of a thread's i-th row, and column of its j-th column.
__device__ __forceinline__ int row_of(int ty, int i) {
  return i / 4 * (BM / 2) + ty * 4 + i % 4;
}
__device__ __forceinline__ int col_of(int tx, int j) {
  return j / 4 * (BN / 2) + tx * 4 + j % 4;
}

// High word: the score as an unsigned integer in the order of the floats,
// with -0.0 taken as +0.0. Low word: ~col, so equal scores keep the
// smaller column under a maximum.
__device__ __forceinline__ unsigned long long best_key(float v, int col) {
  uint32_t u = __float_as_uint(v);
  if ((u << 1) == 0u) u = 0u;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (unsigned long long)u << 32 | (uint32_t)~(uint32_t)col;
}

// K steps of k: acc[i][j] += A[k][row i] * B[k][col j].
template <int K>
__device__ __forceinline__ void fma_steps(float (&acc)[TM][TN],
                                          const float* A, const float* B,
                                          int tx, int ty) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(A + k * BM + ty * 4);
    const float4 a1 =
        *reinterpret_cast<const float4*>(A + k * BM + BM / 2 + ty * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(B + k * BN + tx * 4);
    const float4 b1 =
        *reinterpret_cast<const float4*>(B + k * BN + BN / 2 + tx * 4);
    const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Fold a finished tile into the thread's per-row count and best. EDGE
// masks columns past n2 and the gold column; otherwise neither can occur
// in this tile and each row takes the tile's maximum once.
template <bool CSLS, bool EDGE>
__device__ __forceinline__ void fold_tile(float (&acc)[TM][TN],
                                          const float (&g)[TM],
                                          const int (&gi)[TM],
                                          const float (&r)[TN], int col0,
                                          int n2, int tx, int (&cnt)[TM],
                                          float (&bv)[TM], int (&bi)[TM]) {
  if (EDGE) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + col_of(tx, j);
      if (col < n2) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float s = CSLS ? 2.f * acc[i][j] - r[j] : acc[i][j];
          cnt[i] += (s > g[i] && col != gi[i]) ? 1 : 0;
          if (s > bv[i]) {
            bv[i] = s;
            bi[i] = col;
          }
        }
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float m = -INFINITY;
    int c = 0;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (CSLS) acc[i][j] = 2.f * acc[i][j] - r[j];
      c += acc[i][j] > g[i] ? 1 : 0;
      m = fmaxf(m, acc[i][j]);
    }
    cnt[i] += c;
    if (m > bv[i]) {
      int jj = TN - 1;
#pragma unroll
      for (int j = TN - 2; j >= 0; --j)
        if (acc[i][j] == m) jj = j;
      bv[i] = m;
      bi[i] = col0 + col_of(tx, jj);
    }
  }
}

template <bool CSLS>
__global__ void __launch_bounds__(THREADS, 2)
rank_count_kernel(const float* __restrict__ e1t,
                  const float* __restrict__ e2t,
                  const float* __restrict__ gold,
                  const int32_t* __restrict__ gold_idx,
                  const float* __restrict__ r2, int n1, int n2, int dp,
                  int ld1, int ld2, int col_tiles, long long tiles,
                  int32_t* __restrict__ count,
                  unsigned long long* __restrict__ best) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                                  // [dp][BM]
  float* gs = As + (size_t)dp * BM;                  // [BM] gold scores
  int* gis = reinterpret_cast<int*>(gs + BM);        // [BM] gold columns
  float* ring = reinterpret_cast<float*>(gis + BM);  // [STAGES][STAGE_FLOATS]
  // Each thread's per-row count and best between tiles, [TM][THREADS]: in
  // shared memory they leave the registers to the 8 x 8 tile and its feed.
  int* st_cnt = reinterpret_cast<int*>(ring + STAGES * STAGE_FLOATS);
  float* st_bv = reinterpret_cast<float*>(st_cnt + TM * THREADS);
  int* st_bi = reinterpret_cast<int*>(st_bv + TM * THREADS);
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int cpt = (dp + KC - 1) / KC;                // chunks per tile

  const long long end = tiles * (blockIdx.x + 1) / gridDim.x;
  for (long long u = tiles * blockIdx.x / gridDim.x; u < end;) {
    // one segment: column tiles [t0, t0 + nt) of row block u / col_tiles
    const int row0 = (int)(u / col_tiles) * BM;
    const int t0 = (int)(u % col_tiles);
    const int nt = (int)min((long long)(col_tiles - t0), end - u);
    u += nt;

    __syncthreads();  // the previous segment is done with shared memory
    for (int r = tid; r < BM; r += THREADS) {
      const int row = row0 + r;
      gs[r] = row < n1 ? gold[row] : INFINITY;
      gis[r] = row < n1 ? gold_idx[row] : -1;
    }
    for (int c = tid; c < dp * (BM / 4); c += THREADS) {
      const int k = c / (BM / 4), q = c % (BM / 4) * 4;
      cp_async16(As + k * BM + q, e1t + (size_t)k * ld1 + row0 + q);
    }
    // Chunks run through the ring in order: chunk n holds rows [k0, k0 +
    // kc) of k of one column tile and goes to stage n % STAGES; a tile's
    // last chunk also brings the tile's r2 slice. These count the next
    // chunk to issue: chunk ic of tile t0 + it, into stage is.
    const int nchunks = nt * cpt;
    int issued = 0, ic = 0, it = 0, is = 0;
    auto issue_next = [&]() {
      if (issued < nchunks) {
        const int k0 = ic * KC, kc = min(KC, dp - k0);
        float* dst = ring + is * STAGE_FLOATS;
        const float* src = e2t + (size_t)k0 * ld2 + (size_t)(t0 + it) * BN;
        for (int c = tid; c < kc * (BN / 4); c += THREADS) {
          const int k = c / (BN / 4), q = c % (BN / 4) * 4;
          cp_async16(dst + k * BN + q, src + (size_t)k * ld2 + q);
        }
        if (CSLS && k0 + kc == dp && tid < BN / 4)
          cp_async16(dst + KC * BN + tid * 4,
                     r2 + (size_t)(t0 + it) * BN + tid * 4);
        ++issued;
        if (++ic == cpt) {
          ic = 0;
          ++it;
        }
        if (++is == STAGES) is = 0;
      }
      cp_async_commit();
    };
#pragma unroll
    for (int p = 0; p < STAGES - 1; ++p) issue_next();  // e1t joins group 0

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      st_cnt[i * THREADS + tid] = 0;
      st_bv[i * THREADS + tid] = -INFINITY;
      st_bi[i * THREADS + tid] = NO_COL;
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    }

    int k0 = 0, col0 = t0 * BN, stage = 0;  // the chunk computed next
    for (int n = 0; n < nchunks; ++n) {
      cp_async_wait<STAGES - 2>();  // chunk n has landed
      __syncthreads();              // ... for every thread; stage n-1 is free
      issue_next();

      const float* A = As + (size_t)k0 * BM;
      const float* B = ring + stage * STAGE_FLOATS;
      if (++stage == STAGES) stage = 0;
      if (k0 + KC <= dp) {
        fma_steps<KC>(acc, A, B, tx, ty);
      } else {
        for (int k = 0; k < dp - k0; k += 4)
          fma_steps<4>(acc, A + k * BM, B + k * BN, tx, ty);
      }
      if (k0 + KC < dp) {  // the tile has more chunks
        k0 += KC;
        continue;
      }

      const float4 g0 = *reinterpret_cast<const float4*>(gs + ty * 4);
      const float4 g1 = *reinterpret_cast<const float4*>(gs + BM / 2 + ty * 4);
      const int4 h0 = *reinterpret_cast<const int4*>(gis + ty * 4);
      const int4 h1 = *reinterpret_cast<const int4*>(gis + BM / 2 + ty * 4);
      const float g[TM] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      const int gi[TM] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
      float r[TN];
      if (CSLS) {
        const float4 r0 =
            *reinterpret_cast<const float4*>(B + KC * BN + tx * 4);
        const float4 r1 =
            *reinterpret_cast<const float4*>(B + KC * BN + BN / 2 + tx * 4);
        r[0] = r0.x; r[1] = r0.y; r[2] = r0.z; r[3] = r0.w;
        r[4] = r1.x; r[5] = r1.y; r[6] = r1.z; r[7] = r1.w;
      }
      bool edge = col0 + BN > n2;
#pragma unroll
      for (int i = 0; i < TM; ++i)
        edge |= (unsigned)(gi[i] - col0) < (unsigned)BN;
      int cnt[TM], bi[TM];
      float bv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        cnt[i] = st_cnt[i * THREADS + tid];
        bv[i] = st_bv[i * THREADS + tid];
        bi[i] = st_bi[i * THREADS + tid];
      }
      if (edge)
        fold_tile<CSLS, true>(acc, g, gi, r, col0, n2, tx, cnt, bv, bi);
      else
        fold_tile<CSLS, false>(acc, g, gi, r, col0, n2, tx, cnt, bv, bi);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        st_cnt[i * THREADS + tid] = cnt[i];
        st_bv[i * THREADS + tid] = bv[i];
        st_bi[i * THREADS + tid] = bi[i];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
      k0 = 0;
      col0 += BN;
    }

    // The TX threads of a row are the lanes of one half-warp.
    int cnt[TM], bi[TM];
    float bv[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      cnt[i] = st_cnt[i * THREADS + tid];
      bv[i] = st_bv[i * THREADS + tid];
      bi[i] = st_bi[i * THREADS + tid];
    }
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
        const int row = row0 + row_of(ty, i);
        if (row < n1) {
          if (cnt[i] != 0) atomicAdd(count + row, cnt[i]);
          if (bi[i] != NO_COL) atomicMax(best + row, best_key(bv[i], bi[i]));
        }
      }
    }
  }
}

__global__ void unpack_best(const unsigned long long* __restrict__ best,
                            int n1, int32_t* __restrict__ best_idx,
                            float* __restrict__ best_val) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n1) return;
  const unsigned long long key = best[i];
  uint32_t u = (uint32_t)(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  best_idx[i] = (int32_t)~(uint32_t)key;
  best_val[i] = __uint_as_float(u);
}

// Planes z = 0 and 1 of the grid copy e1 (n1, d) and e2 (n2, d) into their
// k-major, zero-padded forms e1t (dp, ld1) and e2t (dp, ld2), one 32 x 32
// tile per block of 32 x 8 threads, through a padded shared tile so that
// reads run along k and writes along the rows. Plane 2 zeroes count and the
// best keys and pads r2 to ld2.
__global__ void prepare_inputs(const float* __restrict__ e1,
                               const float* __restrict__ e2,
                               const float* __restrict__ r2, int n1, int n2,
                               int d, int dp, int ld1, int ld2,
                               float* __restrict__ e1t,
                               float* __restrict__ e2t,
                               float* __restrict__ r2p,
                               int32_t* __restrict__ count,
                               unsigned long long* __restrict__ best) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  if (blockIdx.z == 2) {
    const int stride = gridDim.x * gridDim.y * 256;
    for (int i = (blockIdx.y * gridDim.x + blockIdx.x) * 256 + ty * 32 + tx;
         i < max(n1, ld2); i += stride) {
      if (i < n1) {
        count[i] = 0;
        best[i] = 0ull;
      }
      if (r2p != nullptr && i < ld2) r2p[i] = i < n2 ? r2[i] : 0.f;
    }
    return;
  }
  const float* src = blockIdx.z == 0 ? e1 : e2;
  float* dst = blockIdx.z == 0 ? e1t : e2t;
  const int n = blockIdx.z == 0 ? n1 : n2, ld = blockIdx.z == 0 ? ld1 : ld2;
  const int c0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  if (c0 >= ld) return;
  __shared__ float tile[32][33];
  for (int r = ty; r < 32; r += 8) {
    const int c = c0 + r, k = k0 + tx;
    tile[r][tx] = c < n && k < d ? src[(size_t)c * d + k] : 0.f;
  }
  __syncthreads();
  for (int r = ty; r < 32; r += 8) {
    if (k0 + r < dp) dst[(size_t)(k0 + r) * ld + c0 + tx] = tile[tx][r];
  }
}

size_t round_up(size_t n, size_t m) { return (n + m - 1) / m * m; }

struct Plan {
  int dp, ld1, ld2;  // d rounded up to 4; n1 and n2 up to the tile
  int col_tiles;
  long long tiles;   // (row block, column tile) pairs
  int ctas;          // grid: min(tiles, resident)
  int resident;      // CTAs that fit on the card at once
  size_t smem;       // dynamic shared memory of a CTA
  // workspace layout in bytes: best keys (n1 uint64), then e1t, e2t, r2
  size_t e1t_at, e2t_at, r2_at, workspace;
};

// Sets the rank kernel's shared-memory attributes and plans the launch.
cudaError_t make_plan(int n1, int n2, int d, bool csls, Plan* p) {
  if (n1 < 0 || n2 < 0 || d <= 0) return cudaErrorInvalidValue;
  p->dp = (int)round_up(d, 4);
  p->ld1 = (int)round_up(n1, BM);
  p->ld2 = (int)round_up(n2, BN);
  p->smem = smem_bytes(p->dp);
  if (p->smem > kMaxSmem) return cudaErrorInvalidValue;
  p->e1t_at = round_up(sizeof(unsigned long long) * n1, 256);
  p->e2t_at = p->e1t_at + sizeof(float) * p->dp * p->ld1;
  p->r2_at = p->e2t_at + sizeof(float) * p->dp * p->ld2;
  p->workspace = p->r2_at + sizeof(float) * p->ld2;
  const void* fn = csls ? (const void*)rank_count_kernel<true>
                        : (const void*)rank_count_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p->smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS,
                                                      p->smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  p->col_tiles = p->ld2 / BN;
  p->tiles = (long long)(p->ld1 / BM) * p->col_tiles;
  p->resident = per_sm * sms;
  p->ctas = (int)(p->tiles < p->resident ? p->tiles : p->resident);
  return cudaSuccess;
}

template <bool CSLS>
void launch_rank(const Plan& p, cudaStream_t s, const float* e1t,
                 const float* e2t, const float* gold, const int32_t* gold_idx,
                 const float* r2p, int n1, int n2, int32_t* count,
                 unsigned long long* best) {
  rank_count_kernel<CSLS><<<p.ctas, THREADS, p.smem, s>>>(
      e1t, e2t, gold, gold_idx, r2p, n1, n2, p.dp, p.ld1, p.ld2, p.col_tiles,
      p.tiles, count, best);
}

}  // namespace

// The plan of rank_count on the current device: out[0] tiles, out[1] CTAs,
// out[2] resident CTA slots, out[3] dynamic shared memory bytes per CTA,
// out[4] workspace bytes. Returns a cudaError_t.
extern "C" int rank_count_plan(int n1, int n2, int d, int csls,
                               long long* out) {
  Plan p;
  const cudaError_t err = make_plan(n1, n2, d, csls != 0, &p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.tiles;
  out[1] = p.ctas;
  out[2] = p.resident;
  out[3] = (long long)p.smem;
  out[4] = (long long)p.workspace;
  return 0;
}

// e1: (n1, d), e2: (n2, d), gold: (n1,) float32, row-major; gold_idx: (n1,)
// int32; r2: (n2,) float32 or null; workspace: at least the bytes that
// rank_count_plan gives. Writes count, best_idx (int32) and best_val
// (float32), each (n1,). Launches, on `stream` (a cudaStream_t), the input
// preparation, the rank kernel and the unpacking of the best keys. Returns
// cudaGetLastError() or the first error met.
extern "C" int rank_count(const void* e1, const void* e2, const void* gold,
                          const void* gold_idx, const void* r2, int n1,
                          int n2, int d, void* workspace, void* count,
                          void* best_idx, void* best_val, void* stream) {
  if (n1 <= 0 || n2 <= 0) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = make_plan(n1, n2, d, r2 != nullptr, &p);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  char* ws = static_cast<char*>(workspace);
  auto* best = reinterpret_cast<unsigned long long*>(ws);
  auto* e1t = reinterpret_cast<float*>(ws + p.e1t_at);
  auto* e2t = reinterpret_cast<float*>(ws + p.e2t_at);
  auto* r2p = r2 != nullptr ? reinterpret_cast<float*>(ws + p.r2_at) : nullptr;
  const dim3 grid((p.ld1 > p.ld2 ? p.ld1 : p.ld2) / 32, (p.dp + 31) / 32, 3);
  prepare_inputs<<<grid, dim3(32, 8), 0, s>>>(
      (const float*)e1, (const float*)e2, (const float*)r2, n1, n2, d, p.dp,
      p.ld1, p.ld2, e1t, e2t, r2p, (int32_t*)count, best);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  (r2 != nullptr ? launch_rank<true> : launch_rank<false>)(
      p, s, e1t, e2t, (const float*)gold, (const int32_t*)gold_idx, r2p, n1,
      n2, (int32_t*)count, best);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  unpack_best<<<(n1 + 255) / 256, 256, 0, s>>>(best, n1, (int32_t*)best_idx,
                                               (float*)best_val);
  return (int)cudaGetLastError();
}
