// Device routines shared by the block top-k kernels (topk_rows.cu and
// topk_block.cu): the keep-mask of one block's k largest magnitudes, ties
// to the lower index — the exact mask of ref.topk_threshold_mask:
//   1. lo/hi bisection on the int32 bit pattern of |x| (31 steps, each a
//      block-wide count of bits >= mid) gives the k-th largest magnitude;
//   2. the float tests mag > thresh and mag == thresh (a NaN magnitude
//      passes neither, though the bisection counted it — kept as is);
//   3. an inclusive scan of `equal` in index order fills the ties.
// One CTA of kThreads threads owns a block of at most kMaxBlock lanes;
// thread t holds lanes t*kPer .. t*kPer + kPer - 1 in registers, so the 31
// counting passes and the scan never touch memory; each pass is a warp
// reduction plus one exchange through double-buffered shared memory.
#pragma once

#include <cuda_runtime.h>

namespace topk {

constexpr int kThreads = 256;
constexpr int kPer = 16;                      // lanes a thread holds
constexpr int kMaxBlock = kThreads * kPer;    // 4096
constexpr int kWarps = kThreads / 32;

// int32 arithmetic that wraps as the reference's jnp int32 does (an
// all-ones NaN magnitude makes max(bits) + 1 overflow); >> 1 is its floor
// division by 2
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int warp_sum(int v) {
  return __reduce_add_sync(0xffffffffu, v);
}

__device__ __forceinline__ int warp_max(int v) {
  return __reduce_max_sync(0xffffffffu, v);
}

struct Shared {
  int red[2][kWarps];
  int warp_eq[kWarps];
  int warp_gt[kWarps];
};

// keep[p] for this thread's lanes. bits[p] is the bit pattern of |x| (>= 0)
// at block position threadIdx.x * kPer + p; only the first n_mine lanes
// belong to the block (the others are ignored, not counted as zeros).
// 1 <= k < number of lanes in the block. Every thread of the CTA calls it.
__device__ __forceinline__ void keep_mask(const int (&bits)[kPer], int n_mine,
                                          int k, Shared& sh,
                                          bool (&keep)[kPer]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int local_max = 0;
#pragma unroll
  for (int p = 0; p < kPer; ++p)
    if (p < n_mine && bits[p] > local_max) local_max = bits[p];

  // hi = max(bits) + 1; invariant: count(bits >= lo) >= k > count(bits >= hi)
  int m = warp_max(local_max);
  if (lane == 0) sh.red[0][warp] = m;
  __syncthreads();
  m = sh.red[0][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = sh.red[0][w] > m ? sh.red[0][w] : m;
  int lo = 0, hi = wrap_add(m, 1);

  for (int it = 0; it < 31; ++it) {
    const int mid = wrap_add(lo, wrap_sub(hi, lo) >> 1);
    int cnt = 0;
#pragma unroll
    for (int p = 0; p < kPer; ++p) cnt += p < n_mine && bits[p] >= mid;
    cnt = warp_sum(cnt);
    int* buf = sh.red[(it + 1) & 1];        // red[0] was read before this loop
    if (lane == 0) buf[warp] = cnt;
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += buf[w];
    if (total >= k) lo = mid; else hi = mid;
  }
  const float thresh = __int_as_float(lo);  // the k-th largest |x|

  // n_greater and the per-thread count of ties, in index order
  int n_gt = 0, n_eq = 0;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const float mag = __int_as_float(bits[p]);
    n_gt += p < n_mine && mag > thresh;
    n_eq += p < n_mine && mag == thresh;
  }
  // inclusive warp scan of the tie counts
  int scan = n_eq;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, scan, off);
    if (lane >= off) scan += y;
  }
  n_gt = warp_sum(n_gt);
  if (lane == 31) sh.warp_eq[warp] = scan;
  if (lane == 0) sh.warp_gt[warp] = n_gt;
  __syncthreads();
  int before = scan - n_eq, total_gt = 0;   // ties in earlier threads
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? sh.warp_eq[w] : 0;
    total_gt += sh.warp_gt[w];
  }
  const int room = k - total_gt;            // ties that still fit

  int seen = before;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const float mag = __int_as_float(bits[p]);
    const bool equal = p < n_mine && mag == thresh;
    seen += equal;
    keep[p] = (p < n_mine && mag > thresh) || (equal && seen <= room);
  }
}

}  // namespace topk
