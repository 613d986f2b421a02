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
// far count. One CTA a block of 256 to 4096 lanes: it comes in by one bulk
// async copy and goes out one 16-byte word a thread, and five CTAs share an
// SM, so some load or store while others select (topk_common.cuh). The
// instance holds the block's width rounded up to 256 lanes times a power of
// two. Narrower blocks go several to a CTA, a warp selecting each; wider
// ones are staged whole in shared memory up to 48 Ki lanes (kStageBytes),
// one CTA a block, and cut into chunks of 8 Ki lanes above that, one CTA a
// chunk over six launches (topk_common.cuh's tiers). The all-full test reads
// every k once a CTA.
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

// the other tiers' place of block g: row g / nb, its column of blocks
// g % nb
struct RowsGeo {
  const int* ks;
  long long d;
  int nb, block, flags;
  __device__ __forceinline__ topk::Blk operator()(long long g) const {
    const unsigned row = static_cast<unsigned>(g) / static_cast<unsigned>(nb);
    const long long c0 =
        static_cast<long long>(static_cast<unsigned>(g) - row * nb) * block;
    const long long rem = d - c0;
    int k = ks[row];
    if ((flags & kClipK) && k < 1) k = 1;
    return {static_cast<long long>(row) * d + c0,
            rem < block ? static_cast<int>(rem) : block, k};
  }
};

// whether every row keeps its whole block (kSkipFull): the matrix copies
__device__ __forceinline__ bool all_full(const int* ks, int n_rows, int block,
                                         int flags) {
  bool full = true;
  if (flags & kSkipFull)
    for (int i = threadIdx.x; i < n_rows; i += kThreads)
      full = full && ks[i] >= block;
  return __syncthreads_and(full && (flags & kSkipFull));
}

__global__ void __launch_bounds__(kThreads)
topk_rows_narrow_kernel(const float* __restrict__ x, float* __restrict__ out,
                        const int* __restrict__ ks, int n_rows, long long d,
                        int nb, int block, int flags) {
  const bool copy = all_full(ks, n_rows, block, flags);
  topk::narrow_blocks<float>(x, out, x, x + static_cast<long long>(n_rows) * d,
                             static_cast<long long>(nb) * n_rows, block,
                             RowsGeo{ks, d, nb, block, flags}, copy);
}

__global__ void __launch_bounds__(kThreads)
topk_rows_staged_kernel(const float* __restrict__ x, float* __restrict__ out,
                        const int* __restrict__ ks, int n_rows, long long d,
                        int nb, int block, int flags) {
  const bool copy = all_full(ks, n_rows, block, flags);
  const topk::Blk b = RowsGeo{ks, d, nb, block, flags}(blockIdx.x);
  topk::staged_block<float>(x + b.start, out + b.start, b.valid, x,
                            x + static_cast<long long>(n_rows) * d, block, b.k,
                            copy);
}

__global__ void __launch_bounds__(kThreads)
topk_rows_chunk_kernel(const float* __restrict__ x, float* __restrict__ out,
                       const int* __restrict__ ks, int n_rows, long long d,
                       int nb, int block, int flags, unsigned* ws, int pass) {
  const bool copy = all_full(ks, n_rows, block, flags);
  const int cpb = static_cast<int>(topk::chunks_a_block(block));
  const long long b = blockIdx.x / cpb;
  topk::chunk_pass<float>(x, out, x, x + static_cast<long long>(n_rows) * d, ws,
                          static_cast<long long>(nb) * n_rows, block, pass, b,
                          static_cast<int>(blockIdx.x - b * cpb),
                          RowsGeo{ks, d, nb, block, flags}(b), copy);
}

__global__ void __launch_bounds__(kThreads)
topk_rows_clear_kernel(unsigned* ws, long long words) {
  topk::clear_words(ws, words);
}

using RowsKernel = void (*)(const float*, float*, const int*, int, long long,
                            int, int, int);

// the kernel for a block of `block` lanes (the chunked tier's: nullptr)
RowsKernel rows_kernel_for(long long block) {
  switch (topk::tier_of(block, 4)) {
    case topk::kTierNarrow: return topk_rows_narrow_kernel;
    case topk::kTierStaged: return topk_rows_staged_kernel;
    case topk::kTierChunked: return nullptr;
    default: break;
  }
  switch (topk::lanes_a_thread(block)) {
    case 1: return topk_rows_kernel<1>;
    case 2: return topk_rows_kernel<2>;
    case 4: return topk_rows_kernel<4>;
    case 8: return topk_rows_kernel<8>;
    default: return topk_rows_kernel<16>;
  }
}

}  // namespace

// ws: the chunked tier's workspace of ws_words unsigned words (at least
// topk::chunk_ws_words of the call's blocks; unused by the other tiers).
extern "C" int topk_rows_f32(const float* x, float* out, const int* ks,
                             int n_rows, long long d, int block, int flags,
                             void* ws, long long ws_words, void* stream) {
  if (block < 1 || block > topk::kMaxWidth)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows < 1 || d < 1) return 0;
  const long long nb = (d + block - 1) / block;
  const long long n_blocks = nb * n_rows;
  if (n_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int inb = static_cast<int>(nb);
  switch (topk::tier_of(block, 4)) {
    case topk::kTierNarrow: {
      const long long per_cta = topk::kWarps * topk::narrow_bpw(block);
      topk_rows_narrow_kernel<<<static_cast<unsigned>((n_blocks + per_cta - 1) / per_cta),
                                kThreads, 0, s>>>(x, out, ks, n_rows, d, inb, block,
                                                  flags);
      break;
    }
    case topk::kTierRegister:
      rows_kernel_for(block)<<<static_cast<unsigned>(n_blocks), kThreads, 0, s>>>(
          x, out, ks, n_rows, d, inb, block, flags);
      break;
    case topk::kTierStaged: {
      const int bytes = topk::stage_bytes(block, 4);
      const cudaError_t err = cudaFuncSetAttribute(
          topk_rows_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return static_cast<int>(err);
      topk_rows_staged_kernel<<<static_cast<unsigned>(n_blocks), kThreads, bytes, s>>>(
          x, out, ks, n_rows, d, inb, block, flags);
      break;
    }
    case topk::kTierChunked: {
      const long long header = n_blocks * topk::kHeaderWords;
      const long long grid = n_blocks * topk::chunks_a_block(block);
      if (ws == nullptr || ws_words < topk::chunk_ws_words(n_blocks, block) ||
          grid > 0x7fffffffLL)
        return static_cast<int>(cudaErrorInvalidValue);
      unsigned* w = static_cast<unsigned*>(ws);
      topk_rows_clear_kernel<<<static_cast<unsigned>(header < 262144 ? (header + 255) / 256 : 1024),
                               kThreads, 0, s>>>(w, header);
      for (int pass = 0; pass <= topk::kPasses; ++pass) {
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
        topk_rows_chunk_kernel<<<static_cast<unsigned>(grid), kThreads,
                                 topk::stage_bytes(topk::kChunk, 4), s>>>(
            x, out, ks, n_rows, d, inb, block, flags, w, pass);
      }
      break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// The registers a thread, local (spill) bytes a thread, static shared bytes
// a CTA of the kernel that takes blocks of `block` lanes (the chunked tier:
// its pass kernel), and the dynamic shared bytes it is launched with at that
// width, into out[0..3].
extern "C" int topk_rows_attrs(int block, int* out) {
  if (block < 1 || block > topk::kMaxWidth)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  const topk::Tier tier = topk::tier_of(block, 4);
  const cudaError_t err =
      tier == topk::kTierChunked
          ? cudaFuncGetAttributes(&a, topk_rows_chunk_kernel)
          : cudaFuncGetAttributes(&a, rows_kernel_for(block));
  if (err == cudaSuccess) {
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
    out[2] = static_cast<int>(a.sharedSizeBytes);
    out[3] = tier == topk::kTierStaged ? topk::stage_bytes(block, 4)
           : tier == topk::kTierChunked ? topk::stage_bytes(topk::kChunk, 4) : 0;
  }
  return static_cast<int>(err);
}
