// Per-row block top-k sparsification of stacked client updates, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/topk_sparsify/kernel.py:
// _topk_rows_kernel (entry topk_sparsify_rows_pallas), reached from
// fl/compression.batch_block_topk.
//
// Input: x [n_rows, d] fp32 (one client update per row), ks [n_rows] int32.
// Each row is cut into 4096-wide blocks (the last one ragged; its missing
// tail counts as zeros, as the reference's zero padding does, and is never
// written). In every block the ks[row] largest magnitudes are kept, ties
// to the lower index — the exact mask of ref.topk_threshold_mask, computed
// by topk_common.cuh (bisection on the bit pattern of |x|, the float tests,
// an index-order scan for the ties) — and written as
//   out = mask ? x : +0.0, what the reference's jitted x * mask gives
//   (XLA turns the product into a select), so a dropped NaN or -x is 0.
// When every row has k >= 4096 the whole matrix copies through, as the
// reference's all-full lax.cond skip returns it. Otherwise a row with
// k >= 4096 takes the mask at k = 4096, which keeps every lane but a NaN
// (a NaN magnitude passes neither float test); the kernel writes that
// directly instead of bisecting.
//
// What bounds it: memory. Each element is read once and written once
// (2 x 326 MB at the main path's [50, 1,630,090]: 0.19 ms at 3.35 TB/s).
// The design keeps the whole block in registers (one CTA of 256 threads
// per block, 16 contiguous elements per thread; topk_common.cuh) so the 31
// counting passes and the scan never touch memory again.
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

using topk::kPer;
using topk::kThreads;
constexpr int kBlock = topk::kMaxBlock;

__global__ void __launch_bounds__(kThreads)
topk_rows_kernel(const float* __restrict__ x, float* __restrict__ out,
                 const int* __restrict__ ks, int n_rows, long long d, int nb) {
  __shared__ topk::Shared sh;
  const int tid = threadIdx.x;
  const int row = blockIdx.x / nb;
  const long long start = static_cast<long long>(blockIdx.x % nb) * kBlock;
  const long long rem = d - start;
  const int valid = rem < kBlock ? static_cast<int>(rem) : kBlock;
  const float* xr = x + static_cast<long long>(row) * d + start;
  float* outr = out + static_cast<long long>(row) * d + start;

  bool full = true;                        // every row keeps its whole block
  for (int i = tid; i < n_rows; i += kThreads) full = full && ks[i] >= kBlock;
  if (__syncthreads_and(full)) {           // the all-full skip: copy through
    for (int i = tid; i < valid; i += kThreads) outr[i] = xr[i];
    return;
  }
  int k = ks[row];
  if (k >= kBlock) {                       // the mask at k = 4096: all but NaN
    for (int i = tid; i < valid; i += kThreads) {
      const float v = xr[i];
      outr[i] = v != v ? 0.0f : v;
    }
    return;
  }
  k = k < 1 ? 1 : k;

  const int base = tid * kPer;
  float v[kPer];
  int bits[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int idx = base + p;
    v[p] = idx < valid ? xr[idx] : 0.0f;
    bits[p] = __float_as_int(v[p]) & 0x7fffffff;   // bits of |x|, >= 0
  }
  bool keep[kPer];
  topk::keep_mask(bits, kPer, k, sh, keep);
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int idx = base + p;
    if (idx < valid) outr[idx] = keep[p] ? v[p] : 0.0f;
  }
}

}  // namespace

extern "C" int topk_rows_f32(const float* x, float* out, const int* ks,
                             int n_rows, long long d, void* stream) {
  if (n_rows < 1 || d < 1) return 0;
  const long long nb = (d + kBlock - 1) / kBlock;
  const long long grid = nb * n_rows;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  topk_rows_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      x, out, ks, n_rows, d, static_cast<int>(nb));
  return static_cast<int>(cudaGetLastError());
}
