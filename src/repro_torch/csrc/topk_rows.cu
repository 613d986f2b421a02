// Per-row block top-k sparsification of stacked client updates, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/topk_sparsify/kernel.py:
// _topk_rows_kernel (entry topk_sparsify_rows_pallas), reached from
// fl/compression.batch_block_topk once a round, and the rows entry
// kernels/topk_sparsify/ops.block_topk_sparsify_rows.
//
// Input: x [n_rows, d] fp32 (one client update per row), ks [n_rows] int32,
// a block width (any, from 1 to a whole row). Each row is cut into
// block-wide blocks (the last one ragged; its missing tail counts as zeros,
// as the reference's zero padding does, and is never written). In every
// block the ks[row] largest magnitudes are kept, ties to the lower index —
// the exact mask of ref.topk_threshold_mask, computed by topk_common.cuh —
// and written as
//   out = mask ? x : +0.0, what the reference's jitted x * mask gives
//   (XLA turns the product into a select), so a dropped NaN or -x is 0.
// Flags: kSkipFull — when every row has k >= block the whole matrix copies
// through, as the reference's all-full lax.cond skip returns it; kClipK — a
// k below 1 counts as 1 (batch_block_topk's clip). Without kClipK a k of 0
// or less keeps what the reference's bisection keeps at that k (nothing,
// but for the wrapped bisection of a block holding 0x7fffffff). A row with
// k >= block takes the mask there, which keeps every lane but a NaN (a NaN
// magnitude passes neither float test); the kernel writes that directly.
//
// What bounds it on an H100: memory. Each element is read once and written
// once (2 x 326 MB at the main path's [50, 1,630,090]: 0.195 ms at
// 3.35 TB/s), so the select has to cost less than the block's bytes. The
// reference's 31 bisection passes (a compare and an add a lane each, and a
// CTA barrier a pass) took more issue slots than that alone; the radix
// select of topk_common.cuh takes 4 passes of an 8-bit digit, and after the
// first (the exponent) only the lanes that share the threshold's digits so
// far count. One CTA a block of up to 4096 lanes: it comes in by one bulk
// async copy and goes out one 16-byte word a thread, and five CTAs share an
// SM, so some load or store while others select (topk_common.cuh). The
// instance holds the block's width rounded up to 256 lanes times a power of
// two. A wider block is streamed from device memory, one CTA a block
// (topk_common.cuh: stream_block), a simple kernel whose passes re-read it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

using topk::kThreads;
constexpr int kSkipFull = 1, kClipK = 2;

// the row, the block's first column and its valid lanes, k after the
// flags, and whether the whole matrix copies through
struct RowBlock {
  long long offset;
  int valid, k;
  bool copy;
};

__device__ __forceinline__ RowBlock row_block(const int* ks, int n_rows,
                                              long long d, int nb, int block,
                                              int flags) {
  const int row = blockIdx.x / nb;
  const long long start = static_cast<long long>(blockIdx.x % nb) * block;
  const long long rem = d - start;
  RowBlock rb;
  rb.valid = rem < block ? static_cast<int>(rem) : block;
  rb.offset = static_cast<long long>(row) * d + start;
  bool full = true;                        // every row keeps its whole block
  if (flags & kSkipFull)
    for (int i = threadIdx.x; i < n_rows; i += kThreads)
      full = full && ks[i] >= block;
  rb.copy = __syncthreads_and(full && (flags & kSkipFull));
  rb.k = ks[row];
  if ((flags & kClipK) && rb.k < 1) rb.k = 1;
  return rb;
}

template <int Per>
__global__ void __launch_bounds__(kThreads, topk::kMinCtas)
topk_rows_kernel(const float* __restrict__ x, float* __restrict__ out,
                 const int* __restrict__ ks, int n_rows, long long d, int nb,
                 int block, int flags) {
  const RowBlock rb = row_block(ks, n_rows, d, nb, block, flags);
  topk::sparsify_block<float, Per>(x + rb.offset, out + rb.offset, rb.valid, x,
                                   x + static_cast<long long>(n_rows) * d,
                                   block, rb.k, rb.copy);
}

__global__ void __launch_bounds__(kThreads)
topk_rows_stream_kernel(const float* __restrict__ x, float* __restrict__ out,
                        const int* __restrict__ ks, int n_rows, long long d,
                        int nb, int block, int flags) {
  const RowBlock rb = row_block(ks, n_rows, d, nb, block, flags);
  topk::stream_block<float>(x + rb.offset, out + rb.offset, rb.valid, block,
                            rb.k, rb.copy);
}

using RowsKernel = void (*)(const float*, float*, const int*, int, long long,
                            int, int, int);

// the instance for a block of `block` lanes
RowsKernel rows_kernel_for(long long block) {
  switch (topk::lanes_a_thread(block)) {
    case 1: return topk_rows_kernel<1>;
    case 2: return topk_rows_kernel<2>;
    case 4: return topk_rows_kernel<4>;
    case 8: return topk_rows_kernel<8>;
    case 16: return topk_rows_kernel<16>;
    default: return topk_rows_stream_kernel;
  }
}

}  // namespace

extern "C" int topk_rows_f32(const float* x, float* out, const int* ks,
                             int n_rows, long long d, int block, int flags,
                             void* stream) {
  if (block < 1 || block > topk::kMaxStreamBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows < 1 || d < 1) return 0;
  const long long nb = (d + block - 1) / block;
  const long long grid = nb * n_rows;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  rows_kernel_for(block)<<<static_cast<unsigned>(grid), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x, out, ks, n_rows, d, static_cast<int>(nb), block, flags);
  return static_cast<int>(cudaGetLastError());
}

// The registers a thread, local (spill) bytes a thread, static and dynamic
// shared bytes a CTA of the instance that takes blocks of `block` lanes,
// into out[0..3].
extern "C" int topk_rows_attrs(int block, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, rows_kernel_for(block));
  if (err == cudaSuccess) {
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
    out[2] = static_cast<int>(a.sharedSizeBytes);
    out[3] = 0;
  }
  return static_cast<int>(err);
}
