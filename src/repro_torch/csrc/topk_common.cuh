// Device routines shared by the block top-k kernels (topk_rows.cu and
// topk_block.cu): stage one block in shared memory, find the keep-mask of
// its k largest magnitudes, ties to the lower index — the exact mask of
// ref.topk_threshold_mask — and write the block back with the dropped lanes
// as +0.0.
//
// The mask, as the reference defines it:
//   1. thresh = the k-th largest int32 bit pattern of |x| over the block
//      (a NaN counts above every number);
//   2. the float tests mag > thresh and mag == thresh (a NaN magnitude
//      passes neither, though step 1 counted it), with denormals as zero:
//      the reference's platform, XLA on the CPU, compares so, and the
//      kernel clears a denormal pattern (exponent field 0) before the test;
//   3. the ties, in index order, while they fit: inclusive count <= k - n_gt.
// The reference finds step 1 by 31 bisection passes. Here it is a radix
// select on the 31-bit pattern, most significant digit first: 4 passes of
// 8, 8, 8 and 7 bits (bits 30..23 are the exponent). A pass histograms the
// digit of the lanes whose higher digits equal the threshold's so far, then
// one scan of the bins from the top fixes the digit and the rank left in
// it. One histogram serves the CTA: on the card, copies of it (to spread the
// atomics on a few hot exponent bins) cost more in the scan than they saved,
// even when every lane hits one bin. The bisection equals the k-th largest
// pattern whenever the block's largest pattern is below 0x7fffffff; at
// 0x7fffffff (a NaN with every mantissa bit set) the reference's
// max(bits) + 1 wraps to INT_MIN, and the kernel runs that wrapped
// bisection itself to keep the reference's mask.
//
// Layout: a CTA of kThreads = 256 threads owns a block of at most kMaxBlock
// = 4096 lanes; thread t holds lanes t + 256 p (p < 16) in registers, so
// neighbouring threads read neighbouring shared words, and the passes and
// the tie scan never touch device memory again. The tie scan follows index
// order through (p, warp, lane): a ballot a (p, warp), an exclusive scan of
// the 128 (p, warp) counts, a popcount below the lane. At 48 registers five
// such CTAs share an SM: while some select, others load or store, and the
// 398 blocks of the cross-silo exchange's vector run in one wave. (On the
// card, 1024 threads of 4 lanes, and a persistent grid of CTAs with a
// two-stage ring of blocks, each measured slower.)
//
// Memory: the block comes into shared memory by one bulk async copy
// (cp.async.bulk, completed on an mbarrier) of the 16-byte words that cover
// it (a row of odd length starts mid-word, so up to 12 bytes of each
// neighbour come along); only where those words would leave the tensor (its
// first or last block, when it starts or ends mid-word) is the block loaded
// lane by lane. It goes back as one 16-byte store a thread, neighbouring
// threads on neighbouring words, the partial words at its ends lane by
// lane: only the block's own lanes are written.
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace topk {

constexpr int kMaxBlock = 4096;               // lanes of a block at most
constexpr int kThreads = 256;                 // a CTA
constexpr int kPer = kMaxBlock / kThreads;    // lanes a thread: 16
constexpr int kWarps = kThreads / 32;
constexpr int kMinCtas = 5;                   // CTAs an SM: 48 registers
constexpr int kPasses = 4;                    // digits 30..23, 22..15, 14..7, 6..0
constexpr int kBins = 256;                    // bins of an 8-bit digit
constexpr int kTieEntries = kMaxBlock / 32;   // (p, warp) tie counts: 128

__host__ __device__ constexpr int digit_shift(int pass) {
  return pass < kPasses - 1 ? 23 - 8 * pass : 0;
}
__host__ __device__ constexpr int digit_bits(int pass) {
  return pass < kPasses - 1 ? 8 : 7;
}

// int32 arithmetic that wraps as the reference's jnp int32 does; >> 1 is
// its floor division by 2
__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int warp_sum(int v) {
  return __reduce_add_sync(0xffffffffu, v);
}

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += y;
  }
  return v;
}

// bit pattern of |x| for an fp32 lane and for a bf16 lane (its fp32 value
// is the bf16 bits shifted up 16, so the mask is the fp32 widening's)
__device__ __forceinline__ int mag_bits(float v) {
  return __float_as_int(v) & 0x7fffffff;
}
__device__ __forceinline__ int mag_bits(uint16_t v) {
  return (static_cast<int>(v) << 16) & 0x7fffffff;
}

// The float that a compare on XLA's CPU sees for the pattern `bits`:
// denormals (exponent field 0, either sign) are +0.0.
__device__ __forceinline__ float daz_float(int bits) {
  return __int_as_float((bits & 0x7f800000) ? bits : 0);
}

// ---- PTX: mbarrier and the bulk async copy ---------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait for the phase of parity `parity`; trap after ~2^31 cycles (about a
// second) rather than hang the card on a protocol fault.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1LL << 31)) __trap();
  }
}

// `bytes` (a multiple of 16) from 16-byte aligned global `src` to 16-byte
// aligned shared `dst`, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- shared state -----------------------------------------------------------
struct SelectShared {
  unsigned hist[kBins];
  int part[kWarps];              // the bin scan's warp totals
  int tie[kTieEntries];          // ties a (p, warp), then their exclusive scan
  int gt[kWarps];                // lanes above the threshold a warp
  int red[2][kWarps];            // the wrapped bisection's counts
  int digit, rank;               // a pass's result
  int total_gt;
};

// One block staged in shared memory: lane e at data[e + shift]
template <typename T>
struct Stage {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  alignas(16) T data[kMaxBlock + 2 * kVec];
};

// ---- load and store ---------------------------------------------------------
// A block x[0, valid) as the whole 16-byte words that cover it: they start
// `shift` elements before x. `bulk` says that they lie inside [lo, hi), the
// tensor's bytes (the words at a misaligned start or end of the tensor do
// not), so one bulk copy may bring them; else the block is loaded lane by
// lane. Reading a few bytes of the neighbouring blocks is harmless: only
// the block's own lanes are ever written.
struct Window {
  int valid, shift, words;
  bool bulk;
};

template <typename T>
__device__ __forceinline__ Window window_of(const T* x, int valid, const T* lo,
                                            const T* hi) {
  const uintptr_t a0 = reinterpret_cast<uintptr_t>(x);
  const uintptr_t a1 = a0 + static_cast<uintptr_t>(valid) * sizeof(T);
  const uintptr_t w0 = a0 & ~uintptr_t(15), w1 = (a1 + 15) & ~uintptr_t(15);
  Window w;
  w.valid = valid;
  w.shift = static_cast<int>((a0 - w0) / sizeof(T));
  w.words = static_cast<int>((w1 - w0) / 16);
  w.bulk = w0 >= reinterpret_cast<uintptr_t>(lo) &&
           w1 <= reinterpret_cast<uintptr_t>(hi);
  return w;
}

// One thread: start the bulk copy of the window into `st`, completing on
// `bar` (nothing for a window that is not bulk).
template <typename T>
__device__ __forceinline__ void start_load(const T* x, const Window& w,
                                           Stage<T>& st, uint32_t bar) {
  if (!w.bulk) return;
  mbar_expect_tx(bar, w.words * 16);
  bulk_load(smem_u32(st.data), x - w.shift, w.words * 16, bar);
}

// Every thread: wait for the window's bulk copy (the first phase of `bar`),
// or load its lanes one by one; either way the block is then visible to
// the thread.
template <typename T>
__device__ __forceinline__ void finish_load(const T* x, const Window& w,
                                            Stage<T>& st, uint32_t bar) {
  if (w.bulk) {
    mbar_wait(bar, 0);
  } else {
    for (int e = threadIdx.x; e < w.valid; e += kThreads)
      st.data[e + w.shift] = x[e];
    __syncthreads();
  }
}

// Write st.data (lane e at e + shift) to out[0, valid): its whole 16-byte
// words one a thread, neighbouring threads on neighbouring words, the
// partial words at either end lane by lane.
template <typename T>
__device__ __forceinline__ void store_block(T* out, int valid, int shift,
                                            const Stage<T>& st) {
  constexpr int kVec = Stage<T>::kVec;
  const int tid = threadIdx.x;
  const int out_shift =
      static_cast<int>((reinterpret_cast<uintptr_t>(out) & 15) / sizeof(T));
  const int head = min(valid, (kVec - out_shift) % kVec);
  const int n_words = (valid - head) / kVec;
  const int tail = head + n_words * kVec;
  uint4* dst = reinterpret_cast<uint4*>(out + head);
  if ((head + shift) % kVec == 0) {       // out and x start alike in a word
    const uint4* src = reinterpret_cast<const uint4*>(st.data + head + shift);
    for (int j = tid; j < n_words; j += kThreads) dst[j] = src[j];
  } else {
    for (int j = tid; j < n_words; j += kThreads) {
      union { uint4 w; T v[kVec]; } u;
#pragma unroll
      for (int i = 0; i < kVec; ++i) u.v[i] = st.data[head + shift + j * kVec + i];
      dst[j] = u.w;
    }
  }
  for (int e = tid; e < head; e += kThreads) out[e] = st.data[e + shift];
  for (int e = tail + tid; e < valid; e += kThreads) out[e] = st.data[e + shift];
}

// ---- the select -------------------------------------------------------------
// keep[p] for lane p * kThreads + threadIdx.x. bits[p] is the pattern of |x|
// there (0 for a lane of the ragged tail, which competes as a zero); lanes
// >= n_lanes are not counted (bits 0). 1 <= k < n_lanes <= kMaxBlock. Every
// thread of the CTA calls it with the same k and n_lanes.
__device__ __forceinline__ void keep_mask(const int (&bits)[kPer], int n_lanes,
                                          int k, SelectShared& sh,
                                          bool (&keep)[kPer]) {
  static_assert(kThreads == kBins, "one thread a bin in the scan");
  static_assert(kTieEntries == 4 * 32, "warp 0 scans 4 tie counts a lane");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  bool counted[kPer];
  bool all_ones = false;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    counted[p] = p * kThreads + tid < n_lanes;
    all_ones |= bits[p] == 0x7fffffff;
  }
  // radix select: prefix holds the threshold's digits fixed so far, kk the
  // rank of the threshold among the lanes that share them
  int prefix = 0, kk = k;
  bool wrapped = false;
#pragma unroll
  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = digit_shift(pass), width = digit_bits(pass);
    const int nb = 1 << width, top = shift + width;
#pragma unroll
    for (int p = 0; p < kPer; ++p)
      if (counted[p] && (bits[p] >> top) == prefix)
        atomicAdd(&sh.hist[(bits[p] >> shift) & (nb - 1)], 1u);
    if (pass == 0) {
      if (__syncthreads_or(all_ones)) {   // max(bits) = 0x7fffffff
        wrapped = true;
        break;
      }
    } else {
      __syncthreads();
    }
    // thread t owns bin nb - 1 - t (if any), so a scan over t sums the bins
    // from the top; it zeroes its bin for the next pass
    const int d = nb - 1 - tid;
    int cnt = 0;
    if (d >= 0) {
      cnt = sh.hist[d];
      sh.hist[d] = 0;
    }
    int incl = warp_incl_scan(cnt);
    if (lane == 31) sh.part[warp] = incl;
    __syncthreads();
    for (int w = 0; w < warp; ++w) incl += sh.part[w];
    const int excl = incl - cnt;
    if (excl < kk && kk <= incl) {      // one bin: cnt > 0 there
      sh.digit = d;
      sh.rank = kk - excl;
    }
    __syncthreads();
    prefix = (prefix << width) | sh.digit;
    kk = sh.rank;
  }

  if (wrapped) {
    // the reference's bisection with hi = max + 1 wrapped to INT_MIN
    int lo = 0, hi = INT_MIN;
    for (int it = 0; it < 31; ++it) {
      const int mid = wrap_add(lo, wrap_sub(hi, lo) >> 1);
      int cnt = 0;
#pragma unroll
      for (int p = 0; p < kPer; ++p) cnt += counted[p] && bits[p] >= mid;
      cnt = warp_sum(cnt);
      int* buf = sh.red[it & 1];
      if (lane == 0) buf[warp] = cnt;
      __syncthreads();
      int total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) total += buf[w];
      if (total >= k) lo = mid; else hi = mid;
    }
    prefix = lo;
  }
  const float thresh = daz_float(prefix);   // the k-th largest |x|

  // the float tests, and the ties in index order: (p, warp, lane)
  int n_gt = 0;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const float mag = daz_float(bits[p]);
    n_gt += counted[p] && mag > thresh;
    const unsigned ties = __ballot_sync(0xffffffffu, counted[p] && mag == thresh);
    if (lane == 0) sh.tie[p * kWarps + warp] = __popc(ties);
  }
  n_gt = warp_sum(n_gt);
  if (lane == 0) sh.gt[warp] = n_gt;
  __syncthreads();
  if (warp == 0) {            // exclusive scan of the 128 counts, 4 a lane
    int v[kTieEntries / 32], s = 0;
#pragma unroll
    for (int j = 0; j < kTieEntries / 32; ++j) {
      v[j] = sh.tie[lane * (kTieEntries / 32) + j];
      s += v[j];
    }
    int run = warp_incl_scan(s) - s;
#pragma unroll
    for (int j = 0; j < kTieEntries / 32; ++j) {
      sh.tie[lane * (kTieEntries / 32) + j] = run;
      run += v[j];
    }
    const int g = warp_sum(lane < kWarps ? sh.gt[lane] : 0);
    if (lane == 0) sh.total_gt = g;
  }
  __syncthreads();
  const int room = k - sh.total_gt;        // ties that still fit
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    // the ballot again: cheaper than holding kPer of them across barriers
    const float mag = daz_float(bits[p]);
    const bool equal = counted[p] && mag == thresh;
    const unsigned ties = __ballot_sync(0xffffffffu, equal);
    const int rank = sh.tie[p * kWarps + warp] + __popc(ties & below) + 1;
    keep[p] = (counted[p] && mag > thresh) || (equal && rank <= room);
  }
}

// The block in st.data sparsified in place: the k largest magnitudes of its
// n_lanes lanes kept (lanes of [valid, n_lanes) compete as zeros), the
// others set to +0.0. 1 <= k < n_lanes.
template <typename T>
__device__ __forceinline__ void sparsify(Stage<T>& st, SelectShared& sh,
                                         int shift, int valid, int n_lanes,
                                         int k) {
  const int tid = threadIdx.x;
  int bits[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int e = p * kThreads + tid;
    bits[p] = e < valid ? mag_bits(st.data[e + shift]) : 0;
  }
  bool keep[kPer];
  keep_mask(bits, n_lanes, k, sh, keep);
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int e = p * kThreads + tid;
    if (e < valid && !keep[p]) st.data[e + shift] = T(0);
  }
}

// A CTA's whole work on one block x[0, valid) of the tensor [lo, hi): stage
// it, keep every lane (`copy`, the same in every thread), every lane but a
// NaN (k >= n_lanes: the mask there), or the k largest magnitudes of its
// n_lanes lanes, and write it to out[0, valid).
template <typename T>
__device__ __forceinline__ void sparsify_block(const T* x, T* out, int valid,
                                               const T* lo, const T* hi,
                                               int n_lanes, int k, bool copy) {
  __shared__ Stage<T> stage;
  __shared__ SelectShared sel;
  __shared__ unsigned long long bar;               // the bulk load's mbarrier
  const int tid = threadIdx.x;
  const Window w = window_of(x, valid, lo, hi);
  const uint32_t bar_addr = smem_u32(&bar);
  if (tid == 0) mbar_init(bar_addr, 1);
  sel.hist[tid] = 0;                               // kThreads == kBins
  __syncthreads();
  if (tid == 0) start_load(x, w, stage, bar_addr);
  finish_load(x, w, stage, bar_addr);
  if (!copy) {
    if (k >= n_lanes) {
      for (int e = tid; e < valid; e += kThreads)
        if (mag_bits(stage.data[e + w.shift]) > 0x7f800000)
          stage.data[e + w.shift] = T(0);
    } else {
      sparsify(stage, sel, w.shift, valid, n_lanes, k < 1 ? 1 : k);
    }
  }
  __syncthreads();
  store_block(out, valid, w.shift, stage);
}

}  // namespace topk
