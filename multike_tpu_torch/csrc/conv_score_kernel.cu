// The attribute views' CNN scorer for Hopper (sm_90a), forward and
// closed-form backward (K4).
//
// K4 replaces no TPU kernel: the JAX package's scorer (multike_tpu/views/
// attr_conv.py) is lax.conv and jnp, which XLA fuses. Run eagerly on the
// card, it was about 40 PyTorch ops a step: two cuDNN convolutions of a
// (2, d) one-channel image with a (2, 4) kernel and 2 maps, each wrapped in
// NCHW <-> NHWC transposes, and about 40 autograd nodes whose backward ran
// two more cuDNN engines a convolution. The work is small: at d = 75 a row
// is 62,628 FLOPs forward (gpubench/lib/bounds_itc.conv_row_flops), about
// 188K with the backward, so a 5,000-row step is 0.94 GFLOP, 14 us at 67
// TFLOP/s fp32; most of it is the dense layer's three products (flat @ W,
// dz @ W^T, flat^T dz), each 2 x 5,000 x 4d x d FLOPs.
//
// What a row computes (kernels/conv_score.py states it in full): the batch
// norm of the (2, d) image of its attribute and value rows, two SAME
// convolutions with tanh, a norm over the width, the dense layer with tanh
// and the row mask; the batch's sum of squares S then scales every row, and
// score = -|h - g|^2. The backward takes the scores' incoming gradient.
//
// Launches (the wrapper runs batch_sum, the dp ranks' all-reduce, between
// them on S and T):
//   forward   1. conv_rows_kernel: a block takes 32 rows; a warp takes a
//                row through the batch norm, both convolutions and the
//                norm in shared memory and writes its flat row (4d); then
//                the block's dense product over its flat rows (a tiled
//                fp32 GEMM, dense_w streamed through shared memory in
//                stages of 32), tanh, the mask; its rows' sum of squares;
//                the last block to finish sums the blocks' sums into S;
//             2. conv_out_kernel: g = y rsqrt(max(S, eps)), the scores and
//                each row's <h - g, g> (the backward's T is a dot with
//                them);
//   backward  3. conv_t_kernel: T = 2 sum gs <h - g, g>, one block;
//             4. conv_bwd_rows_kernel: a block takes 32 rows: dh, dz;
//                dflat = dz dense_w^T (the GEMM); a warp takes a row back
//                through the norm, both convolutions (recomputed from the
//                row) and the batch norm, to da and dv; the block's sums
//                of the convolutions', gamma's, beta's and dense_b's
//                gradients;
//             5. conv_wgrad_kernel: dense_w's gradient flat^T dz in tiles
//                of 32 x 80, each over a run of rows (about 264 blocks);
//             6. conv_sum_kernel: the runs' sums and the blocks' sums.
// Everything is fp32 FFMA: no TF32, no tensor cores. Every sum is taken in
// an order fixed by the shapes (warp butterflies, warps in order, blocks
// in order) and no float atomic is used (the one integer atomic picks the
// block that sums S, which sums in block order), so two runs give the same
// bits.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;                 // a row pass's rows a block
constexpr int kKT = 32;                   // the depth of a GEMM stage
constexpr int kLd = kKT + 4;              // a staged row: 16-byte aligned,
                                          // conflict-free 16-byte reads
constexpr int kColsPer = 5;               // a thread's columns of a pass
constexpr int kCols = 16 * kColsPer;      // a pass's 80 output columns
constexpr int kTileM = 32;                // the weight gradient's tile rows
constexpr int kNConv = 52;                // conv0_w 16, conv0_b 2, conv1_w 32,
                                          // conv1_b 2 (HWIO, flattened)
constexpr int kB0 = 16, kW1 = 18, kB1 = 50;
constexpr float kEpsL2 = 1e-12f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Every lane gets the same sum: each butterfly step adds a pair in both
// orders, and a + b == b + a.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// One stage of a GEMM operand in registers: rows x kKT elements of G(i, k)
// = g[i * si + k * sk], kN a thread. Element j of a thread is e = tid +
// kThreads j, at (i, kk) = (e / kKT, e % kKT) where g is k-contiguous and
// at (e % rows, e / rows) where it is i-contiguous, so that consecutive
// threads read consecutive addresses. Zero for i >= valid or kk >= kt.
template <int kRowsT>
struct Stage {
  static constexpr int kN = kRowsT * kKT / kThreads;
  float r[kN];

  __device__ __forceinline__ void fetch(const float* g, long long si,
                                        long long sk, int valid, int k0,
                                        int kt) {
    const bool kfast = sk == 1;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int e = threadIdx.x + kThreads * j;
      const int i = kfast ? e / kKT : e % kRowsT;
      const int kk = kfast ? e % kKT : e / kRowsT;
      r[j] = i < valid && kk < kt ? g[i * si + (long long)(k0 + kk) * sk]
                                  : 0.f;
    }
  }

  // into s[i * kLd + kk]
  __device__ __forceinline__ void put(float* s, bool kfast) const {
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int e = threadIdx.x + kThreads * j;
      const int i = kfast ? e / kKT : e % kRowsT;
      const int kk = kfast ? e % kKT : e / kRowsT;
      s[i * kLd + kk] = r[j];
    }
  }
};

// acc[u][v] = sum over k < K of A(ty + 16u, k) B(k, tx + 16v), k in
// increasing order, with ty = tid / 16, tx = tid % 16, u < TM, A(i, k) =
// a[i * sam + k * sak] for i < m and B(k, j) = b[k * sbk + j * sbn] for j <
// n (zero past them); K > 0. Both operands are staged k-contiguous in
// shared memory (as: 16 TM rows, bs: 80, each kLd wide), so a thread reads four
// k of a row or column at once; the next stage is fetched into registers
// while this one is multiplied. Starts with a block barrier: the caller's
// earlier writes (global or shared) are seen, and the stages are free.
template <int TM>
__device__ __forceinline__ void gemm(const float* a, long long sam,
                                     long long sak, int m, const float* b,
                                     long long sbk, long long sbn, int n,
                                     int K, float* as, float* bs,
                                     float (&acc)[TM][kColsPer]) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int u = 0; u < TM; ++u)
#pragma unroll
    for (int v = 0; v < kColsPer; ++v) acc[u][v] = 0.f;
  Stage<16 * TM> sa;
  Stage<kCols> sb;
  sa.fetch(a, sam, sak, m, 0, min(kKT, K));
  sb.fetch(b, sbn, sbk, n, 0, min(kKT, K));
  for (int k0 = 0; k0 < K; k0 += kKT) {
    __syncthreads();
    sa.put(as, sak == 1);
    sb.put(bs, sbk == 1);
    __syncthreads();
    const int k1 = k0 + kKT;
    if (k1 < K) {
      sa.fetch(a, sam, sak, m, k1, min(kKT, K - k1));
      sb.fetch(b, sbn, sbk, n, k1, min(kKT, K - k1));
    }
#pragma unroll
    for (int kk = 0; kk < kKT; kk += 4) {      // zero past the stage's k
      float4 av[TM], bv[kColsPer];
#pragma unroll
      for (int u = 0; u < TM; ++u) av[u] = load4(as + (ty + 16 * u) * kLd + kk);
#pragma unroll
      for (int v = 0; v < kColsPer; ++v)
        bv[v] = load4(bs + (tx + 16 * v) * kLd + kk);
#pragma unroll
      for (int u = 0; u < TM; ++u)
#pragma unroll
        for (int v = 0; v < kColsPer; ++v) {
          acc[u][v] = fmaf(av[u].x, bv[v].x, acc[u][v]);
          acc[u][v] = fmaf(av[u].y, bv[v].y, acc[u][v]);
          acc[u][v] = fmaf(av[u].z, bv[v].z, acc[u][v]);
          acc[u][v] = fmaf(av[u].w, bv[v].w, acc[u][v]);
        }
    }
  }
}

// One row's (2, d) image through the batch norm and both convolutions, by
// one warp, into its buffers: each of L = d + 4 floats, column w at w + 2,
// zero at the pads (-2, -1, d, d + 1), so the convolutions' taps (w - 1 ..
// w + 2) and their adjoints' (w - 2 .. w + 1) read zeros past the image.
// xs [2 h][L] holds the batch norm's output, c0 and c1 [2 maps][2 h][L]
// the convolutions'. n[h][c] gets each map row's sum of squares over the
// width (the same in every lane). TF's SAME padding for a (2, 4) kernel:
// an output (h, w) reads rows h, h + 1 (zero past the image) and columns
// w - 1 .. w + 2.
__device__ __forceinline__ void row_forward(const float* arow,
                                            const float* vrow,
                                            const float* gamma,
                                            const float* beta,
                                            const float* cw, float inv, int d,
                                            float* xs, float* c0, float* c1,
                                            float (&n)[2][2]) {
  const int lane = threadIdx.x % 32, L = d + 4;
  for (int e = lane; e < L; e += 32) {
    const int w = e - 2;
    const bool in = w >= 0 && w < d;
    xs[e] = in ? gamma[w] * arow[w] * inv + beta[w] : 0.f;
    xs[L + e] = in ? gamma[w] * vrow[w] * inv + beta[w] : 0.f;
  }
  __syncwarp();
  // conv0: a lane's column e reads x[h][e - 1 .. e + 2], loaded once
  for (int e = lane; e < L; e += 32) {
    float out[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    if (e >= 2 && e < d + 2) {
      float x[2][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int kw = 0; kw < 4; ++kw) x[hh][kw] = xs[hh * L + e + kw - 1];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int co = 0; co < 2; ++co) {
          float s = cw[kB0 + co];
#pragma unroll
          for (int kh = 0; kh < 2; ++kh)
#pragma unroll
            for (int kw = 0; kw < 4; ++kw)
              if (h + kh < 2)
                s = fmaf(cw[(kh * 4 + kw) * 2 + co], x[h + kh][kw], s);
          out[h][co] = tanhf(s);
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int co = 0; co < 2; ++co) c0[(co * 2 + h) * L + e] = out[h][co];
  }
  __syncwarp();
  // conv1: column e reads c0[ci][h][e - 1 .. e + 2]
  float sq[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int e = lane; e < L; e += 32) {
    float out[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    if (e >= 2 && e < d + 2) {
      float x[2][2][4];
#pragma unroll
      for (int ci = 0; ci < 2; ++ci)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int kw = 0; kw < 4; ++kw)
            x[ci][hh][kw] = c0[(ci * 2 + hh) * L + e + kw - 1];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int co = 0; co < 2; ++co) {
          float s = cw[kB1 + co];
#pragma unroll
          for (int kh = 0; kh < 2; ++kh)
#pragma unroll
            for (int kw = 0; kw < 4; ++kw)
#pragma unroll
              for (int ci = 0; ci < 2; ++ci)
                if (h + kh < 2)
                  s = fmaf(cw[kW1 + ((kh * 4 + kw) * 2 + ci) * 2 + co],
                           x[ci][h + kh][kw], s);
          s = tanhf(s);
          sq[h][co] = fmaf(s, s, sq[h][co]);
          out[h][co] = s;
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int co = 0; co < 2; ++co) c1[(co * 2 + h) * L + e] = out[h][co];
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 2; ++c) n[h][c] = warp_sum(sq[h][c]);
}

__host__ __device__ constexpr int conv_floats(int d) {
  return kWarps * 10 * (d + 4);
}

constexpr int kRowTM = kRows / 16;        // the row passes' GEMM tiles
constexpr int kGemmFloats = ((kRows > kTileM ? kRows : kTileM) + kCols) * kLd;

__host__ __device__ constexpr int rows_floats(int d) {
  return conv_floats(d) > kGemmFloats ? conv_floats(d) : kGemmFloats;
}

struct RowsArgs {
  const float* a;          // (B, d) attribute rows
  const float* v;          // (B, d) value rows
  const float* mask;       // (B,) or null
  const float* gamma;      // (d,)
  const float* beta;
  const float* cw;         // (52,): conv0_w, conv0_b, conv1_w, conv1_b (HWIO)
  const float* dw;         // (4d, d) dense_w
  const float* db;         // (d,) dense_b
  float inv;               // rsqrt(1 + 1e-3)
  int B, d;
  float* flat;             // (B, 4d) out: the normalized conv rows
  float* t;                // (B, d) out: tanh of the dense layer
  float* s_part;           // (blocks,) out: each block's sum of (t m)^2
  int* ticket;             // zero before the launch
  float* S;                // out: the sum of s_part, in block order
};

__global__ void __launch_bounds__(kThreads, 2)
conv_rows_kernel(const RowsArgs p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float cw[kNConv];
  __shared__ float warp_part[kWarps];
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int d = p.d, L = d + 4, d4 = 4 * d;
  const int row0 = blockIdx.x * kRows, rows = min(kRows, p.B - row0);
  if (tid < kNConv) cw[tid] = p.cw[tid];
  __syncthreads();

  // 1. each row through the convolutions and the norm, into flat
  float* xs = smem + warp * 10 * L;
  float* c0 = xs + 2 * L;
  float* c1 = c0 + 4 * L;
  for (int i = warp; i < rows; i += kWarps) {
    const long long row = row0 + i;
    float n[2][2];
    row_forward(p.a + row * d, p.v + row * d, p.gamma, p.beta, cw, p.inv, d,
                xs, c0, c1, n);
    float q[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 2; ++c) q[h][c] = rsqrtf(fmaxf(n[h][c], kEpsL2));
    float* out = p.flat + row * d4;
    for (int w = lane; w < d; w += 32)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(out + (h * d + w) * 2) =
            make_float2(c1[h * L + w + 2] * q[h][0],
                        c1[(2 + h) * L + w + 2] * q[h][1]);
    __syncwarp();
  }

  // 2. the dense layer over the block's flat rows (the GEMM's first
  // barrier makes them seen), tanh, the mask, the sum of squares
  const int ty = tid / 16, tx = tid % 16;
  float ssq = 0.f;
  for (int n0 = 0; n0 < d; n0 += kCols) {
    float acc[kRowTM][kColsPer];
    gemm<kRowTM>(p.flat + (long long)row0 * d4, d4, 1, rows, p.dw + n0, d,
                 1, min(kCols, d - n0), d4, smem, smem + kRows * kLd, acc);
#pragma unroll
    for (int u = 0; u < kRowTM; ++u)
#pragma unroll
      for (int v = 0; v < kColsPer; ++v) {
        const int i = ty + 16 * u, j = n0 + tx + 16 * v;
        if (i >= rows || j >= d) continue;
        const float tt = tanhf(acc[u][v] + p.db[j]);
        p.t[(long long)(row0 + i) * d + j] = tt;
        const float y = p.mask ? tt * p.mask[row0 + i] : tt;
        ssq = fmaf(y, y, ssq);
      }
  }

  // 3. the block's sum; the last block sums the blocks' in block order
  ssq = warp_sum(ssq);
  if (lane == 0) warp_part[warp] = ssq;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += warp_part[w];
    p.s_part[blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(p.ticket, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last || warp != 0) return;
  double s = 0.0;
  for (int b = lane; b < (int)gridDim.x; b += 32)
    s += (double)__ldcg(p.s_part + b);
  s = warp_sum(s);
  if (lane == 0) *p.S = (float)s;
}

// A warp a row: g = t m rsqrt(max(S, eps)), score = -|h - g|^2 and
// hg = <h - g, g>.
__global__ void __launch_bounds__(kThreads)
conv_out_kernel(const float* __restrict__ h, const float* __restrict__ t,
                const float* __restrict__ mask, const float* __restrict__ S,
                int B, int d, float* __restrict__ score,
                float* __restrict__ hg) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= B) return;
  const float r = rsqrtf(fmaxf(*S, kEpsL2));
  const float m = mask ? mask[row] : 1.f;
  float sc = 0.f, pg = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float g = t[row * d + j] * m * r;
    const float diff = h[row * d + j] - g;
    sc = fmaf(diff, diff, sc);
    pg = fmaf(diff, g, pg);
  }
  sc = warp_sum(sc);
  pg = warp_sum(pg);
  if (lane == 0) {
    score[row] = -sc;
    hg[row] = pg;
  }
}

// T = sum <2 gs (h - g), g> = 2 sum gs hg, in one block, in a fixed order.
__global__ void __launch_bounds__(kThreads)
conv_t_kernel(const float* __restrict__ gs, const float* __restrict__ hg,
              int B, float* __restrict__ T) {
  __shared__ double part[kWarps];
  double s = 0.0;
  for (int b = threadIdx.x; b < B; b += kThreads)
    s += (double)gs[b] * (double)hg[b];
  s = warp_sum(s);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    double sum = 0.0;
    for (int w = 0; w < kWarps; ++w) sum += part[w];
    *T = (float)(2.0 * sum);
  }
}

struct BwdArgs {
  const float* h;          // (B, d)
  const float* a;
  const float* v;
  const float* mask;       // (B,) or null
  const float* gamma;
  const float* beta;
  const float* cw;
  const float* dw;         // (4d, d)
  float inv;
  int B, d;
  const float* t;          // (B, d), the forward's
  const float* S;
  const float* gs;         // (B,) the scores' incoming gradient
  const float* T;
  float* dh;               // (B, d) out
  float* da;
  float* dv;
  float* dz;               // (B, d) out: the dense layer's pre-tanh gradient
  float* dflat;            // (B, 4d) scratch
  float* part;             // (blocks, 52 + 3d) out: the block's sums
};

__global__ void __launch_bounds__(kThreads, 2)
conv_bwd_rows_kernel(const BwdArgs p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float cw[kNConv];
  __shared__ float wsum[kWarps][kNConv];
  // each thread's sums of conv0's gradients, cw[0, kW1) (the rest are
  // registers: all of them there spill)
  __shared__ float g0[kW1][kThreads];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int d = p.d, L = d + 4, d4 = 4 * d;
  const int row0 = blockIdx.x * kRows, rows = min(kRows, p.B - row0);
  // the warps' sums of gamma's, beta's and dense_b's gradients: [3][8][d]
  float* acc3 = smem + rows_floats(d);
  float* acc_g = acc3;
  float* acc_b = acc3 + kWarps * d;
  float* acc_db = acc3 + 2 * kWarps * d;
  for (int e = tid; e < 3 * kWarps * d; e += kThreads) acc3[e] = 0.f;
  for (int k = 0; k < kW1; ++k) g0[k][tid] = 0.f;
  if (tid < kNConv) cw[tid] = p.cw[tid];
  __syncthreads();
  const float S = *p.S, T = *p.T;
  const float r = rsqrtf(fmaxf(S, kEpsL2));
  const bool big = S >= kEpsL2;      // else the clamp holds: no gradient

  // 1. dh and dz, a warp a row
  for (int i = warp; i < rows; i += kWarps) {
    const long long row = row0 + i, o = row * d;
    const float gs = p.gs[row], m = p.mask ? p.mask[row] : 1.f;
    for (int j = lane; j < d; j += 32) {
      const float tt = p.t[o + j];
      const float g = tt * m * r;
      const float gg = 2.f * gs * (p.h[o + j] - g);
      p.dh[o + j] = -gg;
      const float dy = big ? r * (gg - T * g) : r * gg;
      const float dz = dy * m * (1.f - tt * tt);
      p.dz[o + j] = dz;
      acc_db[warp * d + j] += dz;
    }
  }

  // 2. dflat = dz dense_w^T over the block's rows (the GEMM's first
  // barrier makes dz seen)
  const int ty = tid / 16, tx = tid % 16;
  for (int n0 = 0; n0 < d4; n0 += kCols) {
    float acc[kRowTM][kColsPer];
    gemm<kRowTM>(p.dz + (long long)row0 * d, d, 1, rows,
                 p.dw + (long long)n0 * d, 1, d, min(kCols, d4 - n0), d,
                 smem, smem + kRows * kLd, acc);
#pragma unroll
    for (int u = 0; u < kRowTM; ++u)
#pragma unroll
      for (int v = 0; v < kColsPer; ++v) {
        const int i = ty + 16 * u, j = n0 + tx + 16 * v;
        if (i < rows && j < d4)
          p.dflat[(long long)(row0 + i) * d4 + j] = acc[u][v];
      }
  }
  __syncthreads();       // dflat seen; the stages free for the rows

  // 3. a warp a row, back through the norm, the convolutions (recomputed)
  // and the batch norm. g1: the lane's sums of conv1's gradients, cw[kW1,
  // kNConv).
  float g1[kNConv - kW1];
#pragma unroll
  for (int k = 0; k < kNConv - kW1; ++k) g1[k] = 0.f;
  float* xs = smem + warp * 10 * L;
  float* c0 = xs + 2 * L;
  float* c1 = c0 + 4 * L;
  for (int i = warp; i < rows; i += kWarps) {
    const long long row = row0 + i;
    float n[2][2], q[2][2], dot[2][2];
    row_forward(p.a + row * d, p.v + row * d, p.gamma, p.beta, cw, p.inv, d,
                xs, c0, c1, n);
    const float* dl = p.dflat + row * d4;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        q[h][c] = rsqrtf(fmaxf(n[h][c], kEpsL2));
        dot[h][c] = 0.f;
      }
    for (int e = lane + 2; e < d + 2; e += 32)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 g2 =
            *reinterpret_cast<const float2*>(dl + (h * d + e - 2) * 2);
        dot[h][0] = fmaf(g2.x, c1[h * L + e] * q[h][0], dot[h][0]);
        dot[h][1] = fmaf(g2.y, c1[(2 + h) * L + e] * q[h][1], dot[h][1]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 2; ++c) dot[h][c] = warp_sum(dot[h][c]);
    // du1 = dc1 (1 - c1^2), in place of c1 (a lane its own columns)
    for (int e = lane + 2; e < d + 2; e += 32)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 g2 =
            *reinterpret_cast<const float2*>(dl + (h * d + e - 2) * 2);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float* cp = c1 + (c * 2 + h) * L + e;
          const float cv = *cp, g = c == 0 ? g2.x : g2.y;
          const float dc = n[h][c] >= kEpsL2
                               ? q[h][c] * (g - cv * q[h][c] * dot[h][c])
                               : q[h][c] * g;
          *cp = dc * (1.f - cv * cv);
        }
      }
    __syncwarp();
    // conv1's weights and biases: du1 against c0
    for (int e = lane + 2; e < d + 2; e += 32)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int co = 0; co < 2; ++co) {
          const float du = c1[(co * 2 + h) * L + e];
          g1[kB1 - kW1 + co] += du;
#pragma unroll
          for (int kh = 0; kh < 2; ++kh)
#pragma unroll
            for (int kw = 0; kw < 4; ++kw)
#pragma unroll
              for (int ci = 0; ci < 2; ++ci)
                if (h + kh < 2) {
                  float& g = g1[((kh * 4 + kw) * 2 + ci) * 2 + co];
                  g = fmaf(du, c0[(ci * 2 + h + kh) * L + e + kw - 1], g);
                }
        }
    __syncwarp();          // c0 read by every lane: now du0 may replace it
    // du0 = dc0 (1 - c0^2), dc0 conv1's adjoint of du1
    for (int e = lane + 2; e < d + 2; e += 32) {
      float u[2][2][4];             // du1[co][h][e + 1 - kw]
#pragma unroll
      for (int co = 0; co < 2; ++co)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int kw = 0; kw < 4; ++kw)
            u[co][h][kw] = c1[(co * 2 + h) * L + e - kw + 1];
#pragma unroll
      for (int hp = 0; hp < 2; ++hp)
#pragma unroll
        for (int ci = 0; ci < 2; ++ci) {
          float s = 0.f;
#pragma unroll
          for (int kh = 0; kh < 2; ++kh)
#pragma unroll
            for (int kw = 0; kw < 4; ++kw)
#pragma unroll
              for (int co = 0; co < 2; ++co)
                if (kh <= hp)
                  s = fmaf(u[co][hp - kh][kw],
                           cw[kW1 + ((kh * 4 + kw) * 2 + ci) * 2 + co], s);
          float* cp = c0 + (ci * 2 + hp) * L + e;
          const float cv = *cp;
          *cp = s * (1.f - cv * cv);
        }
    }
    __syncwarp();
    // conv0's weights and biases: du0 against the batch norm's output
    for (int e = lane + 2; e < d + 2; e += 32)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int co = 0; co < 2; ++co) {
          const float du = c0[(co * 2 + h) * L + e];
          g0[kB0 + co][tid] += du;
#pragma unroll
          for (int kh = 0; kh < 2; ++kh)
#pragma unroll
            for (int kw = 0; kw < 4; ++kw)
              if (h + kh < 2) {
                float& g = g0[(kh * 4 + kw) * 2 + co][tid];
                g = fmaf(du, xs[(h + kh) * L + e + kw - 1], g);
              }
        }
    // dx0, conv0's adjoint of du0; then the batch norm
    for (int e = lane + 2; e < d + 2; e += 32) {
      const int w = e - 2;
      float u[2][2][4];             // du0[co][h][e + 1 - kw]
#pragma unroll
      for (int co = 0; co < 2; ++co)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int kw = 0; kw < 4; ++kw)
            u[co][h][kw] = c0[(co * 2 + h) * L + e - kw + 1];
#pragma unroll
      for (int hp = 0; hp < 2; ++hp) {
        float s = 0.f;
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
#pragma unroll
          for (int kw = 0; kw < 4; ++kw)
#pragma unroll
            for (int co = 0; co < 2; ++co)
              if (kh <= hp)
                s = fmaf(u[co][hp - kh][kw], cw[(kh * 4 + kw) * 2 + co], s);
        const float x = (hp == 0 ? p.a : p.v)[row * d + w];
        acc_g[warp * d + w] += s * x * p.inv;
        acc_b[warp * d + w] += s;
        (hp == 0 ? p.da : p.dv)[row * d + w] = s * p.gamma[w] * p.inv;
      }
    }
    __syncwarp();          // the buffers are read: the next row may start
  }

  // 4. the block's sums: over lanes, then warps in order
  for (int k = 0; k < kW1; ++k) {
    const float s = warp_sum(g0[k][tid]);
    if (lane == 0) wsum[warp][k] = s;
  }
#pragma unroll
  for (int k = kW1; k < kNConv; ++k) {
    const float s = warp_sum(g1[k - kW1]);
    if (lane == 0) wsum[warp][k] = s;
  }
  __syncthreads();
  float* out = p.part + (long long)blockIdx.x * (kNConv + 3 * d);
  if (tid < kNConv) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += wsum[w][tid];
    out[tid] = s;
  }
  for (int e = tid; e < 3 * d; e += kThreads) {
    const float* acc = acc3 + (e / d) * kWarps * d + e % d;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += acc[w * d];
    out[kNConv + e] = s;
  }
}

struct WgradArgs {
  const float* flat;       // (B, 4d)
  const float* dz;         // (B, d)
  int B, d, splits, split_rows, tiles_n;
  float* wpart;            // (splits, 4d, d) out
};

// dense_w's gradient over one run of rows, for one 32 x 80 tile:
// flat^T dz.
__global__ void __launch_bounds__(kThreads, 2)
conv_wgrad_kernel(const WgradArgs p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int d = p.d, d4 = 4 * d;
  const int tile = blockIdx.x / p.splits, split = blockIdx.x % p.splits;
  const int m0 = (tile / p.tiles_n) * kTileM, n0 = (tile % p.tiles_n) * kCols;
  const int r0 = split * p.split_rows;
  const int kr = min(p.split_rows, p.B - r0);
  float acc[kTileM / 16][kColsPer];
  gemm<kTileM / 16>(p.flat + (long long)r0 * d4 + m0, 1, d4,
                    min(kTileM, d4 - m0), p.dz + (long long)r0 * d + n0, d,
                    1, min(kCols, d - n0), kr, smem, smem + kTileM * kLd,
                    acc);
  float* out = p.wpart + (long long)split * d4 * d;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int u = 0; u < kTileM / 16; ++u)
#pragma unroll
    for (int v = 0; v < kColsPer; ++v) {
      const int m = m0 + ty + 16 * u, n = n0 + tx + 16 * v;
      if (m < d4 && n < d) out[(long long)m * d + n] = acc[u][v];
    }
}

// The first wblocks blocks: dense_w's gradient, each element the sum of
// the runs' in run order. The rest: each warp a column of the row blocks'
// sums (52 + 3d), its lanes over the blocks in a fixed order.
__global__ void __launch_bounds__(kThreads)
conv_sum_kernel(const float* __restrict__ wpart, int splits, long long nw,
                int wblocks, const float* __restrict__ part, int blocks,
                int small, float* __restrict__ dw, float* __restrict__ sums) {
  if ((int)blockIdx.x < wblocks) {
    const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (e >= nw) return;
    double s = 0.0;
    for (int k = 0; k < splits; ++k) s += (double)wpart[k * nw + e];
    dw[e] = (float)s;
    return;
  }
  const int lane = threadIdx.x % 32;
  const int col = ((int)blockIdx.x - wblocks) * kWarps + threadIdx.x / 32;
  if (col >= small) return;
  double s = 0.0;
  for (int b = lane; b < blocks; b += 32)
    s += (double)part[(long long)b * small + col];
  s = warp_sum(s);
  if (lane == 0) sums[col] = (float)s;
}

cudaError_t launch_rows(const RowsArgs& p, cudaStream_t stream) {
  const int bytes = 4 * rows_floats(p.d);
  cudaError_t err = cudaFuncSetAttribute(
      conv_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  conv_rows_kernel<<<(p.B + kRows - 1) / kRows, kThreads, bytes,
                     stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The forward's first launch: the B rows' flat conv rows (B, 4d) and
// tanh(flat dense_w + dense_b) (B, d), and into *S the batch's sum of
// (t mask)^2. s_part holds ceil(B / 32) floats; *ticket is 0. cw holds
// conv0_w, conv0_b, conv1_w, conv1_b flattened (HWIO). mask may be null.
// All tensors contiguous fp32; returns cudaGetLastError().
extern "C" int conv_score_rows(const float* a, const float* v,
                               const float* mask, const float* gamma,
                               const float* beta, const float* cw,
                               const float* dw, const float* db, float inv,
                               int B, int d, float* flat, float* t,
                               float* s_part, int* ticket, float* S,
                               cudaStream_t stream) {
  const RowsArgs p{a, v, mask, gamma, beta, cw, dw, db, inv, B, d, flat, t,
                   s_part, ticket, S};
  return launch_rows(p, stream);
}

// The forward's second launch: the (B,) scores and hg = <h - g, g> from
// the rows' t and the batch's S (summed over the ranks by then).
extern "C" int conv_score_out(const float* h, const float* t,
                              const float* mask, const float* S, int B, int d,
                              float* score, float* hg, cudaStream_t stream) {
  conv_out_kernel<<<(B + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      h, t, mask, S, B, d, score, hg);
  return cudaGetLastError();
}

// The backward's first launch: *T = 2 sum gs hg.
extern "C" int conv_score_t(const float* gs, const float* hg, int B,
                            float* T, cudaStream_t stream) {
  conv_t_kernel<<<1, kThreads, 0, stream>>>(gs, hg, B, T);
  return cudaGetLastError();
}

// The backward's other three launches, from the scores' incoming gradient
// gs and T (summed over the ranks by then): dh, da, dv (B, d); dense_w's
// gradient dwgrad (4d, d); and sums (52 + 3d): the convolutions' gradients
// in cw's layout, then gamma's, beta's and dense_b's. Scratch: dz (B, d),
// dflat (B, 4d), part (ceil(B / 32), 52 + 3d), wpart (splits, 4d, d), with
// the rows in splits runs of split_rows (a multiple of 32).
extern "C" int conv_score_backward(
    const float* h, const float* a, const float* v, const float* mask,
    const float* gamma, const float* beta, const float* cw, const float* dw,
    float inv, int B, int d, const float* t, const float* flat,
    const float* S, const float* gs, const float* T, int splits,
    int split_rows, float* dh, float* da, float* dv, float* dz, float* dflat,
    float* part, float* wpart, float* sums, float* dwgrad,
    cudaStream_t stream) {
  const int blocks = (B + kRows - 1) / kRows;
  const int bytes = 4 * (rows_floats(d) + 3 * kWarps * d);
  cudaError_t err = cudaFuncSetAttribute(
      conv_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const BwdArgs p{h, a, v, mask, gamma, beta, cw, dw, inv, B, d, t, S, gs, T,
                  dh, da, dv, dz, dflat, part};
  conv_bwd_rows_kernel<<<blocks, kThreads, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const int tiles_n = (d + kCols - 1) / kCols;
  const int tiles = ((4 * d + kTileM - 1) / kTileM) * tiles_n;
  const WgradArgs w{flat, dz, B, d, splits, split_rows, tiles_n, wpart};
  conv_wgrad_kernel<<<tiles * splits, kThreads, 4 * kGemmFloats,
                      stream>>>(w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long nw = 4LL * d * d;
  const int wblocks = (int)((nw + kThreads - 1) / kThreads);
  const int small = kNConv + 3 * d;
  conv_sum_kernel<<<wblocks + (small + kWarps - 1) / kWarps, kThreads, 0,
               stream>>>(wpart, splits, nw, wblocks, part, blocks, small,
                         dwgrad, sums);
  return cudaGetLastError();
}
