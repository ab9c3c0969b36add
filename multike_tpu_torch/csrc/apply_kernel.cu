// Fused row-sparse Adagrad apply for Hopper (sm_90a).
//
// Replaces multike_tpu/kernels/apply_kernel.py::fused_row_adagrad_pallas
// (kernel body _apply_kernel). For each slot k with r = loc[k] in [0, rows):
//
//     acc[r]   += g * g                       (g = gsum[k], a row of d)
//     param[r] -= lr * g * (acc[r] > 0 ? rsqrt(acc[r] + eps) : 0)
//
// Slots with r outside [0, rows) are the dedup's sentinels and do nothing.
// loc holds each row at most once, so no two warps touch the same row: no
// atomics are needed and the update is in place.
//
// Bound: bytes. Each touched row is read from param, acc and gsum and
// written to param and acc once (5 * 4 * d bytes per row) plus 4 bytes of
// loc per slot; the arithmetic is a handful of operations per element. The
// design keeps that to one pass: one warp per slot, lanes on consecutive
// elements of the row, so each row's 4*d bytes are read and written as a
// few coalesced segments. Rows are 4*d bytes apart (300 at d = 75), which
// is not 16-byte aligned, so the loads are scalar.
//
// Rounding: the products and sums are written with the _rn intrinsics so
// nvcc does not contract them into FMAs; with them the kernel repeats the
// plain PyTorch version's operation order. rsqrtf has at most 2 ulp error
// (CUDA Math API); torch.rsqrt on a CUDA tensor calls the same rsqrtf.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_row_adagrad_kernel(float* __restrict__ param, float* __restrict__ acc,
                         const int32_t* __restrict__ loc,
                         const float* __restrict__ gsum, long long n,
                         int rows, int d, float lr, float eps) {
  const long long k =
      (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (k >= n) return;
  const int r = loc[k];
  if (r < 0 || r >= rows) return;  // sentinel slot
  const float* g = gsum + k * d;
  float* p = param + (long long)r * d;
  float* a = acc + (long long)r * d;
  for (int j = lane; j < d; j += 32) {
    const float gj = g[j];
    const float aj = __fadd_rn(a[j], __fmul_rn(gj, gj));
    a[j] = aj;
    const float upd = aj > 0.f ? __fmul_rn(rsqrtf(__fadd_rn(aj, eps)), gj)
                               : 0.f;
    p[j] = __fsub_rn(p[j], __fmul_rn(lr, upd));
  }
}

}  // namespace

// param, acc: (rows, d) float32, updated in place; loc: (n,) int32;
// gsum: (n, d) float32; stream: a cudaStream_t. Returns cudaGetLastError().
extern "C" int fused_row_adagrad(void* param, void* acc, const void* loc,
                                 const void* gsum, long long n, int rows,
                                 int d, float lr, float eps, void* stream) {
  if (n > 0) {
    const long long blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    fused_row_adagrad_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0,
                               (cudaStream_t)stream>>>(
        (float*)param, (float*)acc, (const int32_t*)loc, (const float*)gsum,
        n, rows, d, lr, eps);
  }
  return (int)cudaGetLastError();
}
