// Per-slot TransE logistic loss for Hopper (sm_90a), with its gradients
// computed in the same pass (K5).
//
// K5 replaces no TPU kernel: the JAX package's loss (multike_tpu/losses.py::
// lean_relation_logistic_loss) is plain jnp, which XLA fuses into a few
// passes. Run eagerly on the card, the same expression is some 20 ops for
// each KG forward and as many autograd nodes backward, each a pass over
// (B, K) or (B, K, D) tensors, so a batch-5000 per-slot step spent most of
// its card time in elementwise passes and their zero-filled gradients.
// K5 computes the loss and its gradients with respect to the four row
// tensors at once; the loss is a scalar sum, so the backward only scales
// them by the incoming gradient.
//
// For B positives (h, r, t rows, d wide), each with K slots: a candidate
// row c, a coin (corrupt the head or the tail) and a keep flag:
//
//   loss = sum_i m_i softplus(|h_i + r_i - t_i|^2)
//        + sum_ij m_i keep_ij softplus(-|x_ij|^2)
//
// with x_ij = c_ij + r_i - t_i where slot j corrupts the head and
// x_ij = h_i + r_i - c_ij where it corrupts the tail; m (the positives'
// mask) and keep are 1 where absent. With k_ij = -2 m_i keep_ij
// sigmoid(-|x_ij|^2), a head slot adds k x to g_c and g_r and subtracts it
// from g_t; a tail slot adds k x to g_h and g_r and subtracts it from g_c;
// the positive adds 2 m sigmoid(|a|^2) a to g_h and g_r and subtracts it
// from g_t, a = h + r - t.
//
// Bound: bytes. Every row is read once and its gradient written once:
// (3 + K) d floats in and as many out a positive, with the coins, flags
// and mask; at the per-slot cell's step (5,000 positives, K = 10, d = 75)
// 39 MB, about 12 us at 3.35 TB/s. The arithmetic is 10 d FLOPs a slot.
//
// Design. One warp a positive, 8 a block. The warp reads its rows in rounds
// of 128 columns (4 a lane, the loads of a round issued together), so any
// d takes the same path:
//   1. the positive's distance, reduced by a butterfly of shuffles (every
//      lane ends with the same bits);
//   2. the slots' distances, kBatch slots at a time, their candidate loads
//      in flight together; each slot's loss term (lane 0, into an fp64
//      sum) and coefficient, kept in shared memory;
//   3. a second walk over the columns: the positive's gradient, then each
//      slot's g_c written and its share added to the lane's g_h, g_r, g_t
//      in slot order, which are written once (the warp's candidate rows
//      come back from L1).
// Distances are computed directly, not through the expanded
// |c|^2 + |x|^2 + 2 c.x. A block writes the sum of its warps' losses in
// warp order, and a second launch sums the blocks' partials in a fixed
// tree. No atomics, no TF32: two launches give the same bits.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                     // a lane's columns of a round
constexpr int kRound = 32 * kPer;           // the columns of a round
constexpr int kBatch = 8;                   // slots whose loads overlap
constexpr unsigned kFull = 0xffffffffu;

// The inputs are read through the read-only cache (__ldg): the warp's
// candidate rows come back from L1 in step 3.
struct Args {
  const float* h;                 // (b, d)
  const float* r;
  const float* t;
  const float* c;                 // (b, k, d)
  const unsigned char* head;      // (b, k): 1 corrupts the head
  const float* mask;              // (b) or null
  const float* keep;              // (b, k) or null
  int b, k, d;
  float* gh;                      // (b, d)
  float* gr;
  float* gt;
  float* gc;                      // (b, k, d)
  double* loss_part;              // one a block
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

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
per_slot_loss_kernel(const Args a) {
  extern __shared__ float coef_all[];       // [kWarps][k]
  __shared__ double warp_loss[kWarps];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long i = (long long)blockIdx.x * kWarps + warp;
  float* coef = coef_all + warp * a.k;
  double loss = 0.0;

  if (i < a.b) {
    const int d = a.d, k = a.k;
    const float* h = a.h + i * d;
    const float* r = a.r + i * d;
    const float* t = a.t + i * d;
    const float* c = a.c + i * k * d;
    const unsigned char* head = a.head + i * k;
    const float m = a.mask ? __ldg(a.mask + i) : 1.f;

    // 1. the positive
    float sq = 0.f;
    for (int k0 = 0; k0 < d; k0 += kRound) {
      float e[kPer];
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int col = k0 + lane + 32 * q;
        e[q] = col < d ? (__ldg(h + col) + __ldg(r + col)) - __ldg(t + col)
                     : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kPer; ++q) sq = fmaf(e[q], e[q], sq);
    }
    sq = warp_sum(sq);
    if (lane == 0) loss += (double)(m * softplus(sq));
    const float cp = 2.f * m * softplus_grad(sq);

    // 2. the slots' distances and coefficients, kBatch at a time
    for (int j0 = 0; j0 < k; j0 += kBatch) {
      bool hd[kBatch];
      float acc[kBatch];
#pragma unroll
      for (int s = 0; s < kBatch; ++s) {
        hd[s] = j0 + s < k && __ldg(head + j0 + s) != 0;
        acc[s] = 0.f;
      }
      for (int k0 = 0; k0 < d; k0 += kRound) {
        float hv[kPer], rv[kPer], tv[kPer], cv[kBatch][kPer];
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          const int col = k0 + lane + 32 * q;
          const bool in = col < d;
          hv[q] = in ? __ldg(h + col) : 0.f;
          rv[q] = in ? __ldg(r + col) : 0.f;
          tv[q] = in ? __ldg(t + col) : 0.f;
#pragma unroll
          for (int s = 0; s < kBatch; ++s)
            cv[s][q] = in && j0 + s < k
                           ? __ldg(c + (long long)(j0 + s) * d + col) : 0.f;
        }
#pragma unroll
        for (int s = 0; s < kBatch; ++s)
#pragma unroll
          for (int q = 0; q < kPer; ++q) {
            const float x = hd[s] ? (cv[s][q] + rv[q]) - tv[q]
                                  : (hv[q] + rv[q]) - cv[s][q];
            acc[s] = fmaf(x, x, acc[s]);
          }
      }
#pragma unroll
      for (int s = 0; s < kBatch; ++s) {
        const float dist = warp_sum(acc[s]);
        if (j0 + s < k && lane == 0) {
          const float wk =
              m * (a.keep ? __ldg(a.keep + i * k + j0 + s) : 1.f);
          // softplus(-dist) and its derivative from one exp (-dist <= 0,
          // under torch's threshold)
          const float z = expf(-dist);
          loss += (double)(wk * log1pf(z));
          coef[j0 + s] = -2.f * wk * (z / (z + 1.f));
        }
      }
    }
    __syncwarp();

    // 3. the gradients
    float* gh = a.gh + i * d;
    float* gr = a.gr + i * d;
    float* gt = a.gt + i * d;
    float* gc = a.gc + i * k * d;
    for (int k0 = 0; k0 < d; k0 += kRound) {
      float hv[kPer], rv[kPer], tv[kPer], sh[kPer], sr[kPer], st[kPer];
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int col = k0 + lane + 32 * q;
        const bool in = col < d;
        hv[q] = in ? __ldg(h + col) : 0.f;
        rv[q] = in ? __ldg(r + col) : 0.f;
        tv[q] = in ? __ldg(t + col) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const float g = cp * ((hv[q] + rv[q]) - tv[q]);
        sh[q] = g;
        sr[q] = g;
        st[q] = -g;
      }
      for (int j = 0; j < k; ++j) {
        const bool hd = __ldg(head + j) != 0;
        const float kj = coef[j];
        const float* cj = c + (long long)j * d;
        float* gcj = gc + (long long)j * d;
        float cv[kPer];
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          const int col = k0 + lane + 32 * q;
          cv[q] = col < d ? __ldg(cj + col) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          const int col = k0 + lane + 32 * q;
          const float x = hd ? (cv[q] + rv[q]) - tv[q]
                             : (hv[q] + rv[q]) - cv[q];
          const float g = kj * x;
          sr[q] += g;
          if (hd) st[q] -= g; else sh[q] += g;
          if (col < d) gcj[col] = hd ? g : -g;
        }
      }
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int col = k0 + lane + 32 * q;
        if (col < d) {
          gh[col] = sh[q];
          gr[col] = sr[q];
          gt[col] = st[q];
        }
      }
    }
  }

  // the block's loss, in warp order
  if (lane == 0) warp_loss[warp] = loss;
  __syncthreads();
  if (threadIdx.x == 0) {
    double sum = 0.0;
    for (int w = 0; w < kWarps; ++w) sum += warp_loss[w];
    a.loss_part[blockIdx.x] = sum;
  }
}

// The loss: the blocks' partials summed in a fixed tree, one block.
__global__ void __launch_bounds__(kThreads)
slot_loss_sum_kernel(const double* __restrict__ part, int n,
                     float* __restrict__ loss) {
  __shared__ double sums[kThreads];
  double v = 0.0;
  for (int k = threadIdx.x; k < n; k += kThreads) v += part[k];
  sums[threadIdx.x] = v;
  __syncthreads();
  for (int o = kThreads / 2; o > 0; o >>= 1) {
    if ((int)threadIdx.x < o) sums[threadIdx.x] += sums[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) *loss = (float)sums[0];
}

}  // namespace

// The loss of b positives with k slots each into *loss, and its gradients
// with respect to h, r, t (gh, gr, gt: (b, d)) and the candidates (gc:
// (b, k, d)). All tensors are contiguous; rows, mask and keep fp32 (mask
// and keep may be null), head one byte a slot. loss_part holds
// ceil(b / 8) doubles; a block takes 32 k bytes of shared memory. Two
// launches on `stream`; returns cudaGetLastError().
extern "C" int per_slot_loss(const float* h, const float* r, const float* t,
                             const float* c, const unsigned char* head,
                             const float* mask, const float* keep, int b,
                             int k, int d, float* gh, float* gr, float* gt,
                             float* gc, double* loss_part, float* loss,
                             cudaStream_t stream) {
  const int blocks = (b + kWarps - 1) / kWarps;
  const int smem = kWarps * k * (int)sizeof(float);
  if (blocks > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        per_slot_loss_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    const Args a{h, r, t, c, head, mask, keep, b, k, d, gh, gr, gt, gc,
                 loss_part};
    per_slot_loss_kernel<<<blocks, kThreads, smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  slot_loss_sum_kernel<<<1, kThreads, 0, stream>>>(loss_part, blocks, loss);
  return cudaGetLastError();
}
