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
// What bounds it: memory. Each element is read once and written once
// (2 x 6.5 MB at the paper CNN's flat update, n = 1,630,090 fp32: 3.9 us at
// 3.35 TB/s). One CTA of 256 threads per block holds the block in registers
// (16 contiguous lanes a thread; lanes past the block width are ignored) so
// the 31 counting passes and the tie scan never touch memory again.
#include <cuda_runtime.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace {

using topk::kPer;
using topk::kThreads;

// bit pattern of |x| for an fp32 lane and for a bf16 lane (its fp32 value
// is the bf16 bits shifted up 16)
__device__ __forceinline__ int mag_bits(float v) {
  return __float_as_int(v) & 0x7fffffff;
}
__device__ __forceinline__ int mag_bits(uint16_t v) {
  return (static_cast<int>(v) << 16) & 0x7fffffff;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_block_kernel(const T* __restrict__ x, T* __restrict__ out, long long n,
                  int block, int k) {
  __shared__ topk::Shared sh;
  const int tid = threadIdx.x;
  const long long start = static_cast<long long>(blockIdx.x) * block;
  const long long rem = n - start;
  const int valid = rem < block ? static_cast<int>(rem) : block;
  const T* xb = x + start;
  T* ob = out + start;

  if (k >= block) {                        // the mask at k = block: all but NaN
    for (int i = tid; i < valid; i += kThreads) {
      const T v = xb[i];
      ob[i] = mag_bits(v) > 0x7f800000 ? T(0) : v;
    }
    return;
  }
  k = k < 1 ? 1 : k;

  const int base = tid * kPer;
  const int left = block - base;           // this thread's lanes in the block
  const int n_mine = left < 0 ? 0 : (left < kPer ? left : kPer);
  T v[kPer];
  int bits[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int idx = base + p;
    v[p] = idx < valid ? xb[idx] : T(0);
    bits[p] = mag_bits(v[p]);
  }
  bool keep[kPer];
  topk::keep_mask(bits, n_mine, k, sh, keep);
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int idx = base + p;
    if (idx < valid) ob[idx] = keep[p] ? v[p] : T(0);
  }
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
