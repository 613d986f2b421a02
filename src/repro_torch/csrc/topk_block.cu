// Block top-k sparsification of one flat vector, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/topk_sparsify/kernel.py:
// _topk_block_kernel (entry topk_sparsify_pallas), reached from
// kernels/topk_sparsify/ops.block_topk_sparsify and fl/compression.block_topk
// (the cross-silo aggregation of fl/collectives.py).
//
// Input: x [n] fp32 or bf16, a static k and a block width (a multiple of 128
// up to 4096). The vector is cut into blocks of that width (the last one
// ragged: read in place, its missing tail competes as zeros, as the
// reference's zero padding does, and is never written). In every block the
// k largest magnitudes are kept, ties to the lower index — the exact mask
// of ref.topk_threshold_mask, computed by topk_common.cuh on the fp32 value
// of each lane (a bf16 lane widens exactly) — and written as
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
// in one wave. Lanes past the block width are ignored.
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

using topk::kThreads;

template <typename T>
__global__ void __launch_bounds__(kThreads, topk::kMinCtas)
topk_block_kernel(const T* __restrict__ x, T* __restrict__ out, long long n,
                  int block, int k) {
  const long long start = static_cast<long long>(blockIdx.x) * block;
  const long long rem = n - start;
  const int valid = rem < block ? static_cast<int>(rem) : block;
  topk::sparsify_block(x + start, out + start, valid, x, x + n, block, k,
                       false);
}

template <typename T>
cudaError_t attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, topk_block_kernel<T>);
  if (err == cudaSuccess) {
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
    out[2] = static_cast<int>(a.sharedSizeBytes);
    out[3] = 0;
  }
  return err;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (passed as its 16-bit pattern)
extern "C" int topk_block(const void* x, void* out, long long n, int block,
                          int k, int dtype, void* stream) {
  if (block < 128 || block > topk::kMaxBlock || block % 128 != 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n < 1) return 0;
  const long long nb = (n + block - 1) / block;
  if (nb > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    topk_block_kernel<float><<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n, block, k);
  else
    topk_block_kernel<uint16_t><<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
        static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out), n, block,
        k);
  return static_cast<int>(cudaGetLastError());
}

// The compiled instance's (dtype as above) registers a thread, local
// (spill) bytes a thread, static and dynamic shared bytes a CTA, into
// out[0..3].
extern "C" int topk_block_attrs(int dtype, int* out) {
  if (dtype == 0) return static_cast<int>(attrs<float>(out));
  if (dtype == 1) return static_cast<int>(attrs<uint16_t>(out));
  return static_cast<int>(cudaErrorInvalidValue);
}
