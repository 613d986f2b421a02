// Block top-k sparsification of one flat vector, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/topk_sparsify/kernel.py:
// _topk_block_kernel (entry topk_sparsify_pallas), reached from
// kernels/topk_sparsify/ops.block_topk_sparsify and fl/compression.block_topk
// (the cross-silo aggregation of fl/collectives.py).
//
// Input: x [n] fp32, bf16 or fp16, a static k and a block width (any, from 1 to
// the whole vector). The vector is cut into blocks of that width (the last one
// ragged: read in place, its missing tail competes as zeros, as the
// reference's zero padding does, and is never written). In every block the
// k largest magnitudes are kept, ties to the lower index — the exact mask
// of ref.topk_threshold_mask, computed by topk_common.cuh on the fp32 value
// of each lane (a bf16 or fp16 lane widens exactly; fp16 subnormals are
// normal fp32 numbers, so the denormals-as-zero compare leaves them be, as
// the reference's does) — and written as
//   out = mask ? x : +0.0 in the input's type, what the reference's jitted
//   x * mask gives (XLA turns the product into a select).
// At k >= block the mask keeps every lane but a NaN (a NaN magnitude passes
// neither float test); the kernel writes that directly. There is no
// all-full skip: the reference's block_topk has none.
//
// What bounds it on an H100: memory in principle (2 x 6.5 MB at the paper
// CNN's flat update, n = 1,630,090 fp32: 3.9 us at 3.35 TB/s), latency in
// practice: the exchange's vector is only 398 blocks of 4096, about three
// a streaming multiprocessor, so the time is one block's chain of load,
// select and store, plus the launch. The design shortens that chain: the
// 4-pass radix select of topk_common.cuh in place of 31 bisection passes,
// the block staged by one bulk async copy and written back one 16-byte word
// a thread, and five CTAs of 256 threads an SM, so that all 398 blocks run
// in one wave. Lanes past the block width are ignored. The instance holds
// the block's width rounded up to 256 lanes times a power of two; a block
// wider than 4096 lanes is streamed from device memory, one CTA a block
// (topk_common.cuh: stream_block), a simple kernel whose passes re-read it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

using topk::kThreads;

template <typename T, int Per>
__global__ void __launch_bounds__(kThreads, topk::kMinCtas)
topk_block_kernel(const T* __restrict__ x, T* __restrict__ out, long long n,
                  int block, int k) {
  const long long start = static_cast<long long>(blockIdx.x) * block;
  const long long rem = n - start;
  const int valid = rem < block ? static_cast<int>(rem) : block;
  topk::sparsify_block<T, Per>(x + start, out + start, valid, x, x + n, block,
                               k, false);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_block_stream_kernel(const T* __restrict__ x, T* __restrict__ out,
                         long long n, int block, int k) {
  const long long start = static_cast<long long>(blockIdx.x) * block;
  const long long rem = n - start;
  const int valid = rem < block ? static_cast<int>(rem) : block;
  topk::stream_block<T>(x + start, out + start, valid, block, k, false);
}

template <typename T>
using BlockKernel = void (*)(const T*, T*, long long, int, int);

// the instance for a block of `block` lanes
template <typename T>
BlockKernel<T> block_kernel_for(long long block) {
  switch (topk::lanes_a_thread(block)) {
    case 1: return topk_block_kernel<T, 1>;
    case 2: return topk_block_kernel<T, 2>;
    case 4: return topk_block_kernel<T, 4>;
    case 8: return topk_block_kernel<T, 8>;
    case 16: return topk_block_kernel<T, 16>;
    default: return topk_block_stream_kernel<T>;
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, long long n, int block, int k,
                   unsigned nb, cudaStream_t s) {
  block_kernel_for<T>(block)<<<nb, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, block, k);
  return cudaGetLastError();
}

template <typename T>
cudaError_t attrs(int block, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, block_kernel_for<T>(block));
  if (err == cudaSuccess) {
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
    out[2] = static_cast<int>(a.sharedSizeBytes);
    out[3] = 0;
  }
  return err;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (the 16-bit types passed
// as their patterns)
extern "C" int topk_block(const void* x, void* out, long long n, int block,
                          int k, int dtype, void* stream) {
  if (block < 1 || block > topk::kMaxStreamBlock || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n < 1) return 0;
  const long long nb = (n + block - 1) / block;
  if (nb > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(nb);
  return static_cast<int>(
      dtype == 0 ? launch<float>(x, out, n, block, k, grid, s)
      : dtype == 1 ? launch<uint16_t>(x, out, n, block, k, grid, s)
                   : launch<topk::f16_lane>(x, out, n, block, k, grid, s));
}

// The instance's (dtype as above, blocks of `block` lanes) registers a
// thread, local (spill) bytes a thread, static and dynamic shared bytes a
// CTA, into out[0..3].
extern "C" int topk_block_attrs(int dtype, int block, int* out) {
  if (dtype == 0) return static_cast<int>(attrs<float>(block, out));
  if (dtype == 1) return static_cast<int>(attrs<uint16_t>(block, out));
  if (dtype == 2) return static_cast<int>(attrs<topk::f16_lane>(block, out));
  return static_cast<int>(cudaErrorInvalidValue);
}
