// Per-row block top-k sparsification of stacked client updates, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/topk_sparsify/kernel.py:
// _topk_rows_kernel (entry topk_sparsify_rows_pallas), reached from
// fl/compression.batch_block_topk once a round.
//
// Input: x [n_rows, d] fp32 (one client update per row), ks [n_rows] int32.
// Each row is cut into 4096-wide blocks (the last one ragged; its missing
// tail counts as zeros, as the reference's zero padding does, and is never
// written). In every block the ks[row] largest magnitudes are kept, ties
// to the lower index — the exact mask of ref.topk_threshold_mask, computed
// by topk_common.cuh — and written as
//   out = mask ? x : +0.0, what the reference's jitted x * mask gives
//   (XLA turns the product into a select), so a dropped NaN or -x is 0.
// When every row has k >= 4096 the whole matrix copies through, as the
// reference's all-full lax.cond skip returns it. Otherwise a row with
// k >= 4096 takes the mask at k = 4096, which keeps every lane but a NaN
// (a NaN magnitude passes neither float test); the kernel writes that
// directly instead of selecting.
//
// What bounds it on an H100: memory. Each element is read once and written
// once (2 x 326 MB at the main path's [50, 1,630,090]: 0.195 ms at
// 3.35 TB/s), so the select has to cost less than the block's bytes. The
// reference's 31 bisection passes (a compare and an add a lane each, and a
// CTA barrier a pass) took more issue slots than that alone; the radix
// select of topk_common.cuh takes 4 passes of an 8-bit digit, and after the
// first (the exponent) only the lanes that share the threshold's digits so
// far count. One CTA a 4096-lane block: it comes in by one bulk async copy
// and goes out one 16-byte word a thread, and five CTAs share an SM, so
// some load or store while others select (topk_common.cuh).
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

using topk::kThreads;
constexpr int kBlock = topk::kMaxBlock;

__global__ void __launch_bounds__(kThreads, topk::kMinCtas)
topk_rows_kernel(const float* __restrict__ x, float* __restrict__ out,
                 const int* __restrict__ ks, int n_rows, long long d, int nb) {
  const int row = blockIdx.x / nb;
  const long long start = static_cast<long long>(blockIdx.x % nb) * kBlock;
  const long long rem = d - start;
  const int valid = rem < kBlock ? static_cast<int>(rem) : kBlock;
  const long long offset = static_cast<long long>(row) * d + start;
  bool full = true;                        // every row keeps its whole block
  for (int i = threadIdx.x; i < n_rows; i += kThreads)
    full = full && ks[i] >= kBlock;
  // the all-full skip copies through; a row with k >= 4096 loses its NaN
  // lanes only
  topk::sparsify_block(x + offset, out + offset, valid, x,
                       x + static_cast<long long>(n_rows) * d, kBlock, ks[row],
                       __syncthreads_and(full));
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

// The compiled kernel's registers a thread, local (spill) bytes a thread,
// static and dynamic shared bytes a CTA, into out[0..3].
extern "C" int topk_rows_attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, topk_rows_kernel);
  if (err == cudaSuccess) {
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
    out[2] = static_cast<int>(a.sharedSizeBytes);
    out[3] = 0;
  }
  return static_cast<int>(err);
}
