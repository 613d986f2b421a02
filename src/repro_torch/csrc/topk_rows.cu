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
// to the lower index — the exact mask of ref.topk_threshold_mask:
//   1. lo/hi bisection on the int32 bit pattern of |x| (31 steps, each a
//      block-wide count of bits >= mid) gives the k-th largest magnitude;
//   2. the float tests mag > thresh and mag == thresh (a NaN magnitude
//      passes neither, though the bisection counted it — kept as is);
//   3. an inclusive scan of `equal` in index order fills the ties;
//   4. out = mask ? x : +0.0, what the reference's jitted x * mask gives
//      (XLA turns the product into a select), so a dropped NaN or -x is 0.
// When every row has k >= 4096 the whole matrix copies through, as the
// reference's all-full lax.cond skip returns it. Otherwise a row with
// k >= 4096 takes the mask at k = 4096, which keeps every lane but a NaN
// (a NaN magnitude passes neither float test); the kernel writes that
// directly instead of bisecting.
//
// What bounds it: memory. Each element is read once and written once
// (2 x 326 MB at the main path's [50, 1,630,090]: 0.19 ms at 3.35 TB/s).
// The design keeps the whole block in registers (one CTA of 256 threads
// per block, 16 contiguous elements per thread) so the 31 counting passes
// and the scan never touch memory again; each pass is a warp reduction
// plus one exchange through double-buffered shared memory (one barrier).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 4096;
constexpr int kThreads = 256;
constexpr int kPer = kBlock / kThreads;   // 16 elements per thread
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

__global__ void __launch_bounds__(kThreads)
topk_rows_kernel(const float* __restrict__ x, float* __restrict__ out,
                 const int* __restrict__ ks, int n_rows, long long d, int nb) {
  __shared__ int red[2][kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
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
  int local_max = 0;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int idx = base + p;
    v[p] = idx < valid ? xr[idx] : 0.0f;
    bits[p] = __float_as_int(v[p]) & 0x7fffffff;   // bits of |x|, >= 0
    local_max = bits[p] > local_max ? bits[p] : local_max;
  }

  // hi = max(bits) + 1; invariant: count(bits >= lo) >= k > count(bits >= hi)
  int m = warp_max(local_max);
  if (lane == 0) red[0][warp] = m;
  __syncthreads();
  m = red[0][0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = red[0][w] > m ? red[0][w] : m;
  int lo = 0, hi = wrap_add(m, 1);

  for (int it = 0; it < 31; ++it) {
    const int mid = wrap_add(lo, wrap_sub(hi, lo) >> 1);
    int cnt = 0;
#pragma unroll
    for (int p = 0; p < kPer; ++p) cnt += bits[p] >= mid;
    cnt = warp_sum(cnt);
    int* buf = red[(it + 1) & 1];          // red[0] was read before this loop
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
    n_gt += mag > thresh;
    n_eq += mag == thresh;
  }
  // inclusive warp scan of the tie counts
  int scan = n_eq;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, scan, off);
    if (lane >= off) scan += y;
  }
  n_gt = warp_sum(n_gt);
  __shared__ int warp_eq[kWarps], warp_gt[kWarps];
  if (lane == 31) warp_eq[warp] = scan;
  if (lane == 0) warp_gt[warp] = n_gt;
  __syncthreads();
  int before = scan - n_eq, total_gt = 0;   // ties in earlier threads
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? warp_eq[w] : 0;
    total_gt += warp_gt[w];
  }
  const int room = k - total_gt;            // ties that still fit

  int seen = before;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const float mag = __int_as_float(bits[p]);
    const bool equal = mag == thresh;
    seen += equal;
    const bool keep = (mag > thresh) || (equal && seen <= room);
    const int idx = base + p;
    if (idx < valid) outr[idx] = keep ? v[p] : 0.0f;
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
