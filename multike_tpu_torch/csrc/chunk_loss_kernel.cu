// Chunk-shared TransE logistic loss for Hopper (sm_90a), with its gradients
// computed in the same pass (K3).
//
// K3 replaces no TPU kernel: the JAX package's loss (multike_tpu/losses.py::
// chunk_shared_relation_logistic_loss) is plain jnp, which XLA fuses into a
// few passes. Run eagerly on the card, the same expression is about 45 ops
// for each KG forward and as many autograd nodes backward, so a batch-80,000
// relation-view step spent most of its host time dispatching them and most
// of its card time in their elementwise passes. K3 computes the loss and
// its gradients with respect to the five row tensors at once; the loss is a
// scalar sum, so the backward only scales them by the incoming gradient.
//
// For a chunk of S positives (h, r, t rows, d wide) and its head and tail
// pools of C rows each (ph, pt):
//
//   loss = sum_i m_i softplus(|h_i + r_i - t_i|^2)
//        + w sum_ij m_i kh_ij softplus(-|ph_j + (r_i - t_i)|^2)
//        + w sum_ij m_i kt_ij softplus(-|pt_j - (h_i + r_i)|^2)
//
// with the positives' mask m and the pairs' keep flags kh, kt (1 where
// absent). Both pools are one form, |p_j + x_i|^2, with x = r - t for the
// head pool and x = -(h + r) for the tail pool. With the pair coefficient
// k_ij = -2 w m_i keep_ij sigmoid(-|p_j + x_i|^2), the gradients are
//   g_x_i = sum_j k_ij p_j + (sum_j k_ij) x_i
//   g_p_j = sum_i k_ij x_i + (sum_i k_ij) p_j.
//
// Bound: operations. Each pair of a positive and a pool member costs a
// d-wide distance and, for the gradients, two d-wide products: 6 d FLOPs a
// pair by gpubench/lib/bounds.py's count (2 forward, 4 backward); at the
// relation-view cell's step, 2 x 10 chunks x ~4,000 positives x 256 members
// x 75, that is 9.2 GFLOP, 0.14 ms at 67 TFLOP/s (fp32 outside the tensor
// cores). Everything is fp32 FFMA: no TF32, no bf16 (the TF32 control
// already fails the cell's loss limit).
//
// Design. One block of 256 threads per (chunk, tile of kRows positives)
// walks the two pools in tiles of kPool members and the width in stages of
// up to kCols columns, so any d and any C fit in 96 KB of shared memory:
//   1. the tile's positive terms, one warp a row; their gradients are the
//      first values of the block's rows of g_h, g_r, g_t;
//   2. for each pool tile: the distances |p_j + x_i|^2, computed directly
//      (no cancellation of the expanded form), as a 4 x 8 register tile a
//      thread over staged columns of x and p; then each pair's loss term
//      (into an fp64 sum) and its coefficient, kept in shared memory;
//   3. with the coefficients' row and column sums, the row gradients g_x
//      (added into the block's own rows of g_h, g_r, g_t: no other block
//      writes them) and the pool gradients g_p of this tile of positives,
//      written to a scratch slot of their own; 4 x 5 register tiles, so a
//      stage of 80 columns is one pass, fed by 16-byte loads of four
//      coefficients and of four rows or members of a column (the stages
//      hold x and p by column).
// Where d <= kCols (the main path's d = 75), x and p are staged once a pool
// tile and serve both the distances and the gradients.
// A second launch sums the pool gradients of the row tiles in tile order,
// in fp64, and the blocks' loss partials in a fixed tree. There are no
// atomics: every sum is taken in an order that does not depend on the
// schedule, so two launches give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;                   // positives a block takes
constexpr int kPool = 128;                  // pool members a tile takes
constexpr int kColsPer = 5;                 // a thread's columns of a stage
constexpr int kCols = 16 * kColsPer;        // the widest stage (80 columns)
constexpr int kRowsPer = kRows / 16;        // a thread's rows (4)
constexpr int kPoolPer = kPool / 16;        // a thread's pool members (8)
constexpr int kXLd = kRows + 4;             // a column of the staged x
constexpr int kPLd = kPool + 4;             // a column of the staged p
constexpr int kCoefLd = kPool + 4;          // a row of coefficients
constexpr int kSmemFloats = kCols * (kXLd + kPLd) + kRows * kCoefLd +
                            2 * kRows + kPool;
constexpr int kSmemBytes = kSmemFloats * 4;
constexpr int kMaxSumBlocks = 4096;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* h;          // (nc, s, d)
  const float* r;
  const float* t;
  const float* ph;         // (nc, c, d)
  const float* pt;
  const float* mask;       // (nc, s) or null
  const float* keep_h;     // (nc, s, c) or null
  const float* keep_t;
  float w;
  int s, c, d, tiles;
  float* gh;               // (nc, s, d)
  float* gr;
  float* gt;
  float* part;             // (nc, tiles, 2, c, d): pool gradients a tile
  double* loss_part;       // (nc, tiles)
};

// softplus and its derivative as torch computes them (threshold 20)
__device__ __forceinline__ float softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}

__device__ __forceinline__ float softplus_grad(float x) {
  if (x > 20.f) return 1.f;
  const float z = expf(x);
  return z / (z + 1.f);
}

// The stages hold x and p by column (xs[k * kXLd + i], ps[k * kPLd + j]),
// so the gradient products read four rows or members at once. Warp w takes
// rows w, w + 8, ..., lane l columns l, l + 32, l + 64; the loads of kBatch
// rows are issued before their first store, so their latencies overlap
// (the stores could alias them, as far as the compiler knows).
constexpr int kColChunks = (kCols + 31) / 32;
constexpr int kBatch = 4;

// Columns [k0, k0 + cols) of the tile's rows of x into xs, zero past the
// tile's rows (h, r, t point at the tile's first row): x = r - t for the
// head pool, -(h + r) for the tail pool.
__device__ __forceinline__ void stage_rows(float* xs, const float* h,
                                           const float* r, const float* t,
                                           int d, int rows, int pool, int k0,
                                           int cols) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int q0 = 0; q0 < kRows / kWarps; q0 += kBatch) {
    float v[kBatch][kColChunks];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int i = warp + kWarps * (q0 + q);
#pragma unroll
      for (int m = 0; m < kColChunks; ++m) {
        const int k = lane + 32 * m;
        const long long o = (long long)i * d + k0 + k;
        v[q][m] = i >= rows || k >= cols ? 0.f
                  : pool == 0 ? r[o] - t[o] : -(h[o] + r[o]);
      }
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
#pragma unroll
      for (int m = 0; m < kColChunks; ++m)
        if (lane + 32 * m < cols)
          xs[(lane + 32 * m) * kXLd + warp + kWarps * (q0 + q)] = v[q][m];
  }
}

// Columns [k0, k0 + cols) of pool members [0, members) of p into ps, zero
// past the members.
__device__ __forceinline__ void stage_pool(float* ps, const float* p, int d,
                                           int members, int k0, int cols) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int q0 = 0; q0 < kPool / kWarps; q0 += kBatch) {
    float v[kBatch][kColChunks];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int j = warp + kWarps * (q0 + q);
#pragma unroll
      for (int m = 0; m < kColChunks; ++m) {
        const int k = lane + 32 * m;
        v[q][m] = j >= members || k >= cols ? 0.f
                  : p[(long long)j * d + k0 + k];
      }
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
#pragma unroll
      for (int m = 0; m < kColChunks; ++m)
        if (lane + 32 * m < cols)
          ps[(lane + 32 * m) * kPLd + warp + kWarps * (q0 + q)] = v[q][m];
  }
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One block an SM by registers (up to 255 a thread: at two blocks an SM,
// 128 a thread, the kernel spills, and on the card it ran no faster).
__global__ void __launch_bounds__(kThreads, 1)
chunk_loss_kernel(const Args a) {
  extern __shared__ float4 smem4[];         // 16-byte aligned
  float* xs = reinterpret_cast<float*>(smem4);                        // [kCols][kXLd]
  float* ps = xs + kCols * kXLd;            // [kCols][kPLd]
  float* cs = ps + kCols * kPLd;            // [kRows][kCoefLd]
  float* rsum = cs + kRows * kCoefLd;       // [kRows]
  float* csum = rsum + kRows;               // [kPool]
  float* ms = csum + kPool;                 // [kRows]: the tile's mask
  __shared__ double warp_loss[kWarps];

  const int chunk = blockIdx.y, tile = blockIdx.x;
  const int row0 = tile * kRows;
  const int rows = min(kRows, a.s - row0);
  const long long first = (long long)chunk * a.s + row0;   // first row
  const long long base = first * a.d;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ty = tid / 16, tx = tid % 16;
  const float* h = a.h + base;
  const float* r = a.r + base;
  const float* t = a.t + base;
  // A stage holds up to kCols columns; a width of at most kCols is staged
  // once a pool tile.
  const int width = min(a.d, kCols);
  const bool one_stage = a.d <= kCols;
  double loss = 0.0;

  // 1. the positives, one warp a row
  for (int i = warp; i < rows; i += kWarps) {
    const long long o = (long long)i * a.d;
    const float m = a.mask ? a.mask[first + i] : 1.f;
    float sq = 0.f;
    for (int k = lane; k < a.d; k += 32) {
      const float e = (h[o + k] + r[o + k]) - t[o + k];
      sq = fmaf(e, e, sq);
    }
    for (int off = 16; off > 0; off >>= 1)
      sq += __shfl_xor_sync(kFull, sq, off);
    if (lane == 0) {
      loss += (double)(m * softplus(sq));
      ms[i] = m;
    }
    const float cp = 2.f * m * softplus_grad(sq);
    for (int k = lane; k < a.d; k += 32) {
      const float g = cp * ((h[o + k] + r[o + k]) - t[o + k]);
      a.gh[base + o + k] = g;
      a.gr[base + o + k] = g;
      a.gt[base + o + k] = -g;
    }
  }

  // 2. and 3. the pools
  for (int pool = 0; pool < 2; ++pool) {
    const float* p_all = (pool == 0 ? a.ph : a.pt) +
                         (long long)chunk * a.c * a.d;
    const float* keep = pool == 0 ? a.keep_h : a.keep_t;
    for (int j0 = 0; j0 < a.c; j0 += kPool) {
      const int members = min(kPool, a.c - j0);
      const float* p = p_all + (long long)j0 * a.d;

      // the distances |p_j + x_i|^2 of rows ty + 16u, members tx + 16v
      float acc[kRowsPer][kPoolPer];
#pragma unroll
      for (int u = 0; u < kRowsPer; ++u)
#pragma unroll
        for (int v = 0; v < kPoolPer; ++v) acc[u][v] = 0.f;
      for (int k0 = 0; k0 < a.d; k0 += width) {
        const int cols = min(width, a.d - k0);
        __syncthreads();                    // the stages are free
        stage_rows(xs, h, r, t, a.d, rows, pool, k0, cols);
        stage_pool(ps, p, a.d, members, k0, cols);
        __syncthreads();
        for (int k = 0; k < cols; ++k) {
          float xv[kRowsPer], pv[kPoolPer];
#pragma unroll
          for (int u = 0; u < kRowsPer; ++u) xv[u] = xs[k * kXLd + ty + 16 * u];
#pragma unroll
          for (int v = 0; v < kPoolPer; ++v) pv[v] = ps[k * kPLd + tx + 16 * v];
#pragma unroll
          for (int u = 0; u < kRowsPer; ++u)
#pragma unroll
            for (int v = 0; v < kPoolPer; ++v) {
              const float diff = pv[v] + xv[u];
              acc[u][v] = fmaf(diff, diff, acc[u][v]);
            }
        }
      }

      // each pair's loss term and coefficient, in place of its distance in
      // cs: softplus(-dist) and its derivative from one exp (-dist <= 0,
      // under torch's threshold). Through shared memory, so the distances'
      // registers are free for the math.
#pragma unroll
      for (int u = 0; u < kRowsPer; ++u)
#pragma unroll
        for (int v = 0; v < kPoolPer; ++v)
          cs[(ty + 16 * u) * kCoefLd + tx + 16 * v] = acc[u][v];
#pragma unroll 1
      for (int e = 0; e < kRowsPer * kPoolPer; ++e) {
        const int i = ty + 16 * (e / kPoolPer), j = tx + 16 * (e % kPoolPer);
        float* c = cs + i * kCoefLd + j;
        float coef = 0.f;
        if (i < rows && j < members) {
          const float kp = keep ? keep[(first + i) * a.c + j0 + j] : 1.f;
          const float wk = a.w * ms[i] * kp;
          const float z = expf(-*c);
          loss += (double)(wk * log1pf(z));
          coef = -2.f * wk * (z / (z + 1.f));
        }
        *c = coef;
      }
      __syncthreads();
      if (tid < kRows) {                    // (coefficients past the
        float sum = 0.f;                    // members are 0)
        for (int j = 0; j < members; j += 4) {
          const float4 c4 = load4(cs + tid * kCoefLd + j);
          sum += c4.x;
          sum += c4.y;
          sum += c4.z;
          sum += c4.w;
        }
        rsum[tid] = sum;
      } else if (tid < kRows + kPool) {
        const int j = tid - kRows;
        float sum = 0.f;
        for (int i = 0; i < rows; ++i) sum += cs[i * kCoefLd + j];
        csum[j] = sum;
      }

      for (int k0 = 0; k0 < a.d; k0 += width) {
        const int cols = min(width, a.d - k0);
        if (!one_stage) {
          __syncthreads();                  // the stages are free
          stage_rows(xs, h, r, t, a.d, rows, pool, k0, cols);
          stage_pool(ps, p, a.d, members, k0, cols);
        }
        __syncthreads();                    // the sums (and the stages)

        // the row gradients g_x of rows ty + 16u, columns tx + 16v, four
        // members at a time (coefficients and p past the members are 0)
        float gx[kRowsPer][kColsPer];
#pragma unroll
        for (int u = 0; u < kRowsPer; ++u)
#pragma unroll
          for (int v = 0; v < kColsPer; ++v) gx[u][v] = 0.f;
        for (int j = 0; j < members; j += 4) {
          float4 cv[kRowsPer], pv[kColsPer];
#pragma unroll
          for (int u = 0; u < kRowsPer; ++u)
            cv[u] = load4(cs + (ty + 16 * u) * kCoefLd + j);
#pragma unroll
          for (int v = 0; v < kColsPer; ++v)
            pv[v] = load4(ps + (tx + 16 * v) * kPLd + j);
#pragma unroll
          for (int u = 0; u < kRowsPer; ++u)
#pragma unroll
            for (int v = 0; v < kColsPer; ++v) {
              gx[u][v] = fmaf(cv[u].x, pv[v].x, gx[u][v]);
              gx[u][v] = fmaf(cv[u].y, pv[v].y, gx[u][v]);
              gx[u][v] = fmaf(cv[u].z, pv[v].z, gx[u][v]);
              gx[u][v] = fmaf(cv[u].w, pv[v].w, gx[u][v]);
            }
        }
        // into the block's rows: a row's old values are all loaded before
        // the first store, so the loads' latencies overlap
        float* g_plus = pool == 0 ? a.gr : a.gh;   // x = r - t: g_r += g
        float* g_minus = pool == 0 ? a.gt : a.gr;  // x = -(h + r): g_r -= g
        const float sign = pool == 0 ? 1.f : -1.f;
#pragma unroll
        for (int u = 0; u < kRowsPer; ++u) {
          const int i = ty + 16 * u;
          const long long o = base + (long long)i * a.d + k0 + tx;
          float old_plus[kColsPer], old_minus[kColsPer];
#pragma unroll
          for (int v = 0; v < kColsPer; ++v) {
            const bool in = i < rows && tx + 16 * v < cols;
            old_plus[v] = in ? g_plus[o + 16 * v] : 0.f;
            old_minus[v] = in ? g_minus[o + 16 * v] : 0.f;
          }
#pragma unroll
          for (int v = 0; v < kColsPer; ++v) {
            const int k = tx + 16 * v;
            if (i >= rows || k >= cols) continue;
            const float g = fmaf(rsum[i], xs[k * kXLd + i], gx[u][v]);
            g_plus[o + 16 * v] = old_plus[v] + sign * g;
            g_minus[o + 16 * v] = old_minus[v] - g;
          }
        }

        // the pool gradients g_p of members 64 half + 4 ty + u, columns
        // tx + 16v, four rows at a time (coefficients and x past the rows
        // are 0)
        float* out = a.part + (((long long)chunk * a.tiles + tile) * 2 + pool) *
                                  a.c * a.d;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int jb = 64 * half + 4 * ty;
          float gp[4][kColsPer];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < kColsPer; ++v) gp[u][v] = 0.f;
          for (int i = 0; i < rows; i += 4) {
            float4 cv[4], xv[kColsPer];
#pragma unroll
            for (int q = 0; q < 4; ++q) cv[q] = load4(cs + (i + q) * kCoefLd + jb);
#pragma unroll
            for (int v = 0; v < kColsPer; ++v)
              xv[v] = load4(xs + (tx + 16 * v) * kXLd + i);
#pragma unroll
            for (int v = 0; v < kColsPer; ++v) {
              gp[0][v] = fmaf(cv[0].x, xv[v].x, gp[0][v]);
              gp[1][v] = fmaf(cv[0].y, xv[v].x, gp[1][v]);
              gp[2][v] = fmaf(cv[0].z, xv[v].x, gp[2][v]);
              gp[3][v] = fmaf(cv[0].w, xv[v].x, gp[3][v]);
              gp[0][v] = fmaf(cv[1].x, xv[v].y, gp[0][v]);
              gp[1][v] = fmaf(cv[1].y, xv[v].y, gp[1][v]);
              gp[2][v] = fmaf(cv[1].z, xv[v].y, gp[2][v]);
              gp[3][v] = fmaf(cv[1].w, xv[v].y, gp[3][v]);
              gp[0][v] = fmaf(cv[2].x, xv[v].z, gp[0][v]);
              gp[1][v] = fmaf(cv[2].y, xv[v].z, gp[1][v]);
              gp[2][v] = fmaf(cv[2].z, xv[v].z, gp[2][v]);
              gp[3][v] = fmaf(cv[2].w, xv[v].z, gp[3][v]);
              gp[0][v] = fmaf(cv[3].x, xv[v].w, gp[0][v]);
              gp[1][v] = fmaf(cv[3].y, xv[v].w, gp[1][v]);
              gp[2][v] = fmaf(cv[3].z, xv[v].w, gp[2][v]);
              gp[3][v] = fmaf(cv[3].w, xv[v].w, gp[3][v]);
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int j = jb + u;
#pragma unroll
            for (int v = 0; v < kColsPer; ++v) {
              const int k = tx + 16 * v;
              if (j >= members || k >= cols) continue;
              out[(long long)(j0 + j) * a.d + k0 + k] =
                  fmaf(csum[j], ps[k * kPLd + j], gp[u][v]);
            }
          }
        }
      }
    }
  }

  // the block's loss, in a fixed order
  for (int off = 16; off > 0; off >>= 1)
    loss += __shfl_xor_sync(kFull, loss, off);
  if (lane == 0) warp_loss[warp] = loss;
  __syncthreads();
  if (tid == 0) {
    double sum = 0.0;
    for (int k = 0; k < kWarps; ++k) sum += warp_loss[k];
    a.loss_part[(long long)chunk * a.tiles + tile] = sum;
  }
}

// The pool gradients, each the sum of its row tiles' slots in tile order
// (all blocks but the last), and the loss, the sum of the blocks' partials
// (the last block).
__global__ void __launch_bounds__(kThreads)
pool_sum_kernel(const float* __restrict__ part,
                const double* __restrict__ loss_part, int nc, int tiles,
                long long cd, float* __restrict__ gph,
                float* __restrict__ gpt, float* __restrict__ loss) {
  if (blockIdx.x == gridDim.x - 1) {
    __shared__ double sums[kThreads];
    double v = 0.0;
    const long long n = (long long)nc * tiles;
    for (long long k = threadIdx.x; k < n; k += kThreads) v += loss_part[k];
    sums[threadIdx.x] = v;
    __syncthreads();
    for (int o = kThreads / 2; o > 0; o >>= 1) {
      if ((int)threadIdx.x < o) sums[threadIdx.x] += sums[threadIdx.x + o];
      __syncthreads();
    }
    if (threadIdx.x == 0) *loss = (float)sums[0];
    return;
  }
  const long long n = (long long)nc * 2 * cd;
  const long long stride = (long long)(gridDim.x - 1) * kThreads;
  for (long long e = (long long)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += stride) {
    const long long chunk = e / (2 * cd), rem = e - chunk * 2 * cd;
    const int pool = rem >= cd;
    const long long q = pool ? rem - cd : rem;
    const float* p = part + (chunk * tiles * 2 + pool) * cd + q;
    double sum = 0.0;
    for (int k = 0; k < tiles; ++k) sum += p[(long long)k * 2 * cd];
    (pool ? gpt : gph)[chunk * cd + q] = (float)sum;
  }
}

}  // namespace

// The loss of nc chunks into *loss and its gradients with respect to h, r,
// t (gh, gr, gt: (nc, s, d)) and the pools (gph, gpt: (nc, c, d)). part
// holds nc * ceil(s / 64) * 2 * c * d floats and loss_part nc * ceil(s / 64)
// doubles. All tensors are contiguous fp32; mask, keep_h and keep_t may be
// null. Two launches on `stream`; returns cudaGetLastError().
extern "C" int chunk_loss(const float* h, const float* r, const float* t,
                          const float* ph, const float* pt, const float* mask,
                          const float* keep_h, const float* keep_t, float w,
                          int nc, int s, int c, int d, float* gh, float* gr,
                          float* gt, float* gph, float* gpt, float* part,
                          double* loss_part, float* loss,
                          cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      chunk_loss_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return err;
  const int tiles = (s + kRows - 1) / kRows;
  if (nc > 0 && tiles > 0) {
    const Args a{h, r, t, ph, pt, mask, keep_h, keep_t, w, s, c, d, tiles,
                 gh, gr, gt, part, loss_part};
    chunk_loss_kernel<<<dim3(tiles, nc), kThreads, kSmemBytes, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long cd = (long long)c * d;
  long long blocks = ((long long)nc * 2 * cd + kThreads - 1) / kThreads;
  if (blocks > kMaxSumBlocks) blocks = kMaxSumBlocks;
  pool_sum_kernel<<<(int)blocks + 1, kThreads, 0, stream>>>(
      part, loss_part, nc, tiles, cd, gph, gpt, loss);
  return cudaGetLastError();
}
