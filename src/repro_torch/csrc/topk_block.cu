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
// the block's width rounded up to 256 lanes times a power of two; narrower
// blocks go several to a CTA, a warp selecting each; wider ones are staged
// whole in shared memory up to 192 KiB (48 Ki fp32 lanes, 96 Ki 16-bit),
// one CTA a block, and cut into chunks of 8 Ki lanes above that, one CTA a
// chunk over six launches, so that a whole CNN row runs on 199 CTAs
// (topk_common.cuh's tiers).
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

// the other tiers' place of block g
struct VecGeo {
  long long n;
  int block, k;
  __device__ __forceinline__ topk::Blk operator()(long long g) const {
    const long long start = g * block, rem = n - start;
    return {start, rem < block ? static_cast<int>(rem) : block, k};
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_block_narrow_kernel(const T* __restrict__ x, T* __restrict__ out,
                         long long n, int block, int k) {
  topk::narrow_blocks<T>(x, out, x, x + n, (n + block - 1) / block, block,
                         VecGeo{n, block, k}, false);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_block_staged_kernel(const T* __restrict__ x, T* __restrict__ out,
                         long long n, int block, int k) {
  const topk::Blk b = VecGeo{n, block, k}(blockIdx.x);
  topk::staged_block<T>(x + b.start, out + b.start, b.valid, x, x + n, block,
                        k, false);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
topk_block_chunk_kernel(const T* __restrict__ x, T* __restrict__ out,
                        long long n, int block, int k, unsigned* ws, int pass) {
  const int cpb = static_cast<int>(topk::chunks_a_block(block));
  const long long b = blockIdx.x / cpb;
  topk::chunk_pass<T>(x, out, x, x + n, ws, (n + block - 1) / block, block,
                      pass, b, static_cast<int>(blockIdx.x - b * cpb),
                      VecGeo{n, block, k}(b), false);
}

__global__ void __launch_bounds__(kThreads)
topk_block_clear_kernel(unsigned* ws, long long words) {
  topk::clear_words(ws, words);
}

template <typename T>
using BlockKernel = void (*)(const T*, T*, long long, int, int);

// the kernel for a block of `block` lanes (the chunked tier's: nullptr)
template <typename T>
BlockKernel<T> block_kernel_for(long long block) {
  switch (topk::tier_of(block, sizeof(T))) {
    case topk::kTierNarrow: return topk_block_narrow_kernel<T>;
    case topk::kTierStaged: return topk_block_staged_kernel<T>;
    case topk::kTierChunked: return nullptr;
    default: break;
  }
  switch (topk::lanes_a_thread(block)) {
    case 1: return topk_block_kernel<T, 1>;
    case 2: return topk_block_kernel<T, 2>;
    case 4: return topk_block_kernel<T, 4>;
    case 8: return topk_block_kernel<T, 8>;
    default: return topk_block_kernel<T, 16>;
  }
}

template <typename T>
cudaError_t launch(const void* x_, void* out_, long long n, int block, int k,
                   void* ws, long long ws_words, cudaStream_t s) {
  const T* x = static_cast<const T*>(x_);
  T* out = static_cast<T*>(out_);
  const long long n_blocks = (n + block - 1) / block;
  constexpr int esize = sizeof(T);
  switch (topk::tier_of(block, esize)) {
    case topk::kTierNarrow: {
      const long long per_cta = topk::kWarps * topk::narrow_bpw(block);
      topk_block_narrow_kernel<T><<<static_cast<unsigned>((n_blocks + per_cta - 1) / per_cta),
                                    kThreads, 0, s>>>(x, out, n, block, k);
      break;
    }
    case topk::kTierRegister:
      block_kernel_for<T>(block)<<<static_cast<unsigned>(n_blocks), kThreads, 0, s>>>(
          x, out, n, block, k);
      break;
    case topk::kTierStaged: {
      const int bytes = topk::stage_bytes(block, esize);
      const cudaError_t err = cudaFuncSetAttribute(
          topk_block_staged_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          bytes);
      if (err != cudaSuccess) return err;
      topk_block_staged_kernel<T><<<static_cast<unsigned>(n_blocks), kThreads, bytes, s>>>(
          x, out, n, block, k);
      break;
    }
    case topk::kTierChunked: {
      const long long header = n_blocks * topk::kHeaderWords;
      const long long grid = n_blocks * topk::chunks_a_block(block);
      if (ws == nullptr || ws_words < topk::chunk_ws_words(n_blocks, block) ||
          grid > 0x7fffffffLL)
        return cudaErrorInvalidValue;
      unsigned* w = static_cast<unsigned*>(ws);
      topk_block_clear_kernel<<<static_cast<unsigned>(header < 262144 ? (header + 255) / 256 : 1024),
                                kThreads, 0, s>>>(w, header);
      for (int pass = 0; pass <= topk::kPasses; ++pass) {
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return err;
        topk_block_chunk_kernel<T><<<static_cast<unsigned>(grid), kThreads,
                                     topk::stage_bytes(topk::kChunk, esize), s>>>(
            x, out, n, block, k, w, pass);
      }
      break;
    }
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t attrs(int block, int* out) {
  cudaFuncAttributes a;
  const topk::Tier tier = topk::tier_of(block, sizeof(T));
  const cudaError_t err =
      tier == topk::kTierChunked
          ? cudaFuncGetAttributes(&a, topk_block_chunk_kernel<T>)
          : cudaFuncGetAttributes(&a, block_kernel_for<T>(block));
  if (err == cudaSuccess) {
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
    out[2] = static_cast<int>(a.sharedSizeBytes);
    out[3] = tier == topk::kTierStaged ? topk::stage_bytes(block, sizeof(T))
           : tier == topk::kTierChunked ? topk::stage_bytes(topk::kChunk, sizeof(T))
                                        : 0;
  }
  return err;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (the 16-bit types passed
// as their patterns); ws: the chunked tier's workspace of ws_words unsigned
// words (at least topk::chunk_ws_words of the call's blocks; unused by the
// other tiers)
extern "C" int topk_block(const void* x, void* out, long long n, int block,
                          int k, int dtype, void* ws, long long ws_words,
                          void* stream) {
  if (block < 1 || block > topk::kMaxWidth || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n < 1) return 0;
  if ((n + block - 1) / block > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dtype == 0 ? launch<float>(x, out, n, block, k, ws, ws_words, s)
      : dtype == 1 ? launch<uint16_t>(x, out, n, block, k, ws, ws_words, s)
                   : launch<topk::f16_lane>(x, out, n, block, k, ws, ws_words, s));
}

// The kernel's (dtype as above, blocks of `block` lanes; the chunked tier:
// its pass kernel) registers a thread, local (spill) bytes a thread and
// static shared bytes a CTA, and the dynamic shared bytes it is launched
// with at that width, into out[0..3].
extern "C" int topk_block_attrs(int dtype, int block, int* out) {
  if (block < 1 || block > topk::kMaxWidth)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return static_cast<int>(attrs<float>(block, out));
  if (dtype == 1) return static_cast<int>(attrs<uint16_t>(block, out));
  if (dtype == 2) return static_cast<int>(attrs<topk::f16_lane>(block, out));
  return static_cast<int>(cudaErrorInvalidValue);
}
