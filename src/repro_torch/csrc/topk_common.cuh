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
// Layout: a CTA of kThreads = 256 threads owns a block of at most
// Per * 256 lanes, Per (the lanes a thread holds, a template parameter) one
// of 1, 2, 4, 8 and 16, so up to kMaxBlock = 4096 lanes; a block of another
// width runs the smallest instance that holds it, the lanes past the block
// not counted. Thread t holds lanes t + 256 p (p < Per) in registers, so
// neighbouring threads read neighbouring shared words, and the passes and
// the tie scan never touch device memory again. The tie scan follows index
// order through (p, warp, lane): a ballot a (p, warp), an exclusive scan of
// the Per * 8 (p, warp) counts, a popcount below the lane. At 48 registers
// five such CTAs share an SM: while some select, others load or store, and
// the 398 blocks of the cross-silo exchange's vector run in one wave. (On
// the card, 1024 threads of 4 lanes, and a persistent grid of CTAs with a
// two-stage ring of blocks, each measured slower.)
//
// A block wider than kMaxBlock does not fit a CTA's registers: it is
// streamed (stream_block below). One CTA a block reads it from device
// memory once a pass (L2 keeps it between passes for a few blocks in
// flight): the same four digit passes (or the wrapped bisection), a pass
// that counts the lanes above the threshold, and a last pass in index
// order, 4096 lanes a tile, that writes the block with the ties ranked by
// the same (p, warp, lane) scan and a carry from the tiles before.
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

constexpr int kMaxBlock = 4096;               // lanes a CTA holds at most
constexpr int kThreads = 256;                 // a CTA
constexpr int kMaxPer = kMaxBlock / kThreads; // lanes a thread at most: 16
constexpr int kWarps = kThreads / 32;
constexpr int kMinCtas = 5;                   // CTAs an SM: 48 registers
constexpr int kPasses = 4;                    // digits 30..23, 22..15, 14..7, 6..0
constexpr int kBins = 256;                    // bins of an 8-bit digit
constexpr int kTile = kMaxBlock;              // lanes a tile of stream_block
// the widest streamed block: int lane indices with a tile to spare
constexpr int kMaxStreamBlock = INT_MAX - kTile;

// the lanes a thread holds in the smallest instance for a block of `block`
// lanes, or 0 where the block is streamed
__host__ __device__ constexpr int lanes_a_thread(long long block) {
  return block <= 256 ? 1 : block <= 512 ? 2 : block <= 1024 ? 4
       : block <= 2048 ? 8 : block <= kMaxBlock ? 16 : 0;
}

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

// An fp16 lane, passed as its 16-bit pattern: a type of its own beside the
// bf16 lane's uint16_t, so that mag_bits widens it as fp16. T(0) is +0.0.
struct f16_lane {
  uint16_t bits;
  f16_lane() = default;
  __host__ __device__ constexpr explicit f16_lane(int zero)
      : bits(static_cast<uint16_t>(zero)) {}
};

// bit pattern of |x| for an fp32 lane, a bf16 lane (its fp32 value is the
// bf16 bits shifted up 16, so the mask is the fp32 widening's) and an fp16
// lane: its exact fp32 value, as the reference's and the plain version's
// conversion to fp32 on the CPU gives it — a subnormal becomes a normal
// fp32 number (so the float tests keep it: it is no fp32 denormal), and a
// NaN keeps its payload with the quiet bit set
__device__ __forceinline__ int mag_bits(float v) {
  return __float_as_int(v) & 0x7fffffff;
}
__device__ __forceinline__ int mag_bits(uint16_t v) {
  return (static_cast<int>(v) << 16) & 0x7fffffff;
}
__device__ __forceinline__ int mag_bits(f16_lane v) {
  const int e = (v.bits >> 10) & 0x1f, f = v.bits & 0x3ff;
  if (e == 0x1f) return f ? 0x7fc00000 | (f << 13) : 0x7f800000;  // NaN, Inf
  if (e != 0) return ((e + 112) << 23) | (f << 13);
  if (f == 0) return 0;
  const int p = 31 - __clz(f);                 // the leading bit: 2^(p - 24)
  return ((p + 103) << 23) | ((f << (23 - p)) & 0x7fffff);
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
template <int Per>
struct SelectShared {
  static constexpr int kTies = Per * kWarps;   // (p, warp) tie counts
  unsigned hist[kBins];
  int part[kWarps];              // the bin scan's warp totals
  int tie[kTies];                // ties a (p, warp), then their exclusive scan
  int gt[kWarps];                // lanes above the threshold a warp
  int red[2][kWarps];            // the wrapped bisection's counts
  int result[2];                 // a pass's (digit, rank)
  int total_gt;
};

// One block staged in shared memory: lane e at data[e + shift]
template <typename T, int Per>
struct Stage {
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  alignas(16) T data[Per * kThreads + 2 * kVec];
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
template <typename T, int Per>
__device__ __forceinline__ void start_load(const T* x, const Window& w,
                                           Stage<T, Per>& st, uint32_t bar) {
  if (!w.bulk) return;
  mbar_expect_tx(bar, w.words * 16);
  bulk_load(smem_u32(st.data), x - w.shift, w.words * 16, bar);
}

// Every thread: wait for the window's bulk copy (the first phase of `bar`),
// or load its lanes one by one; either way the block is then visible to
// the thread.
template <typename T, int Per>
__device__ __forceinline__ void finish_load(const T* x, const Window& w,
                                            Stage<T, Per>& st, uint32_t bar) {
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
template <typename T, int Per>
__device__ __forceinline__ void store_block(T* out, int valid, int shift,
                                            const Stage<T, Per>& st) {
  constexpr int kVec = Stage<T, Per>::kVec;
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
// One digit of the radix select, from the histogram `hist` of its nb bins:
// the bin holding the kk-th largest pattern among the lanes counted, and
// the rank left inside it. Thread t owns bin nb - 1 - t (if any), so a scan
// over t sums the bins from the top; it zeroes its bin for the next pass.
// Every thread of the CTA calls it and gets the same (digit, rank).
__device__ __forceinline__ void pick_bin(unsigned* hist, int* part, int* result,
                                         int nb, int kk, int& digit,
                                         int& rank) {
  static_assert(kThreads == kBins, "one thread a bin in the scan");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = nb - 1 - tid;
  int cnt = 0;
  if (d >= 0) {
    cnt = hist[d];
    hist[d] = 0;
  }
  int incl = warp_incl_scan(cnt);
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) incl += part[w];
  const int excl = incl - cnt;
  if (excl < kk && kk <= incl) {      // one bin: cnt > 0 there
    result[0] = d;
    result[1] = kk - excl;
  }
  __syncthreads();
  digit = result[0];
  rank = result[1];
}

// warp 0: the exclusive scan, in place, of the n (p, warp) counts in
// tie[0, n), plus `carry`; returns (in lane 0 of warp 0) their total plus
// carry. The other warps return 0.
__device__ __forceinline__ int scan_ties(int* tie, int n, int carry) {
  const int lane = threadIdx.x & 31;
  if ((threadIdx.x >> 5) != 0) return 0;
  const int per = (n + 31) / 32;         // counts a lane: 1, 2 or 4
  int v[4], s = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = lane * per + j;
    v[j] = (j < per && i < n) ? tie[i] : 0;
    s += v[j];
  }
  const int incl = warp_incl_scan(s);
  int run = incl - s + carry;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = lane * per + j;
    if (j < per && i < n) tie[i] = run;
    run += v[j];
  }
  return __shfl_sync(0xffffffffu, incl, 31) + carry;
}

// keep[p] for lane p * kThreads + threadIdx.x. bits[p] is the pattern of |x|
// there (0 for a lane of the ragged tail, which competes as a zero); lanes
// >= n_lanes are not counted (bits 0). k < n_lanes <= Per * kThreads, and
// k may be 0 or negative (the rows entry's literal k): the bisection then
// keeps nothing, or, wrapped, every lane above its negative threshold.
// Every thread of the CTA calls it with the same k and n_lanes.
template <int Per>
__device__ __forceinline__ void keep_mask(const int (&bits)[Per], int n_lanes,
                                          int k, SelectShared<Per>& sh,
                                          bool (&keep)[Per]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  bool counted[Per];
  bool all_ones = false;
#pragma unroll
  for (int p = 0; p < Per; ++p) {
    counted[p] = p * kThreads + tid < n_lanes;
    all_ones |= bits[p] == 0x7fffffff;
  }
  // radix select: prefix holds the threshold's digits fixed so far, kk the
  // rank of the threshold among the lanes that share them
  int prefix = 0, kk = k;
  bool wrapped = false;
  if (k <= 0) {
    // the bisection's lo climbs to max(bits): no lane is above it and no
    // tie fits; +inf gives the same tests. Unless max + 1 wraps (below)
    wrapped = __syncthreads_or(all_ones);
    prefix = 0x7f800000;
  } else {
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
      const int shift = digit_shift(pass), width = digit_bits(pass);
      const int top = shift + width;
#pragma unroll
      for (int p = 0; p < Per; ++p)
        if (counted[p] && (bits[p] >> top) == prefix)
          atomicAdd(&sh.hist[(bits[p] >> shift) & ((1 << width) - 1)], 1u);
      if (pass == 0) {
        if (__syncthreads_or(all_ones)) {   // max(bits) = 0x7fffffff
          wrapped = true;
          break;
        }
      } else {
        __syncthreads();
      }
      int digit, rank;
      pick_bin(sh.hist, sh.part, sh.result, 1 << width, kk, digit, rank);
      prefix = (prefix << width) | digit;
      kk = rank;
    }
  }

  if (wrapped) {
    // the reference's bisection with hi = max + 1 wrapped to INT_MIN
    int lo = 0, hi = INT_MIN;
    for (int it = 0; it < 31; ++it) {
      const int mid = wrap_add(lo, wrap_sub(hi, lo) >> 1);
      int cnt = 0;
#pragma unroll
      for (int p = 0; p < Per; ++p) cnt += counted[p] && bits[p] >= mid;
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
  for (int p = 0; p < Per; ++p) {
    const float mag = daz_float(bits[p]);
    n_gt += counted[p] && mag > thresh;
    const unsigned ties = __ballot_sync(0xffffffffu, counted[p] && mag == thresh);
    if (lane == 0) sh.tie[p * kWarps + warp] = __popc(ties);
  }
  n_gt = warp_sum(n_gt);
  if (lane == 0) sh.gt[warp] = n_gt;
  __syncthreads();
  scan_ties(sh.tie, SelectShared<Per>::kTies, 0);
  if (warp == 0) {
    const int g = warp_sum(lane < kWarps ? sh.gt[lane] : 0);
    if (lane == 0) sh.total_gt = g;
  }
  __syncthreads();
  const int room = k - sh.total_gt;        // ties that still fit
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int p = 0; p < Per; ++p) {
    // the ballot again: cheaper than holding Per of them across barriers
    const float mag = daz_float(bits[p]);
    const bool equal = counted[p] && mag == thresh;
    const unsigned ties = __ballot_sync(0xffffffffu, equal);
    const int rank = sh.tie[p * kWarps + warp] + __popc(ties & below) + 1;
    keep[p] = (counted[p] && mag > thresh) || (equal && rank <= room);
  }
}

// The block in st.data sparsified in place: the k largest magnitudes of its
// n_lanes lanes kept (lanes of [valid, n_lanes) compete as zeros), the
// others set to +0.0. k < n_lanes.
template <typename T, int Per>
__device__ __forceinline__ void sparsify(Stage<T, Per>& st,
                                         SelectShared<Per>& sh, int shift,
                                         int valid, int n_lanes, int k) {
  const int tid = threadIdx.x;
  int bits[Per];
#pragma unroll
  for (int p = 0; p < Per; ++p) {
    const int e = p * kThreads + tid;
    bits[p] = e < valid ? mag_bits(st.data[e + shift]) : 0;
  }
  bool keep[Per];
  keep_mask<Per>(bits, n_lanes, k, sh, keep);
#pragma unroll
  for (int p = 0; p < Per; ++p) {
    const int e = p * kThreads + tid;
    if (e < valid && !keep[p]) st.data[e + shift] = T(0);
  }
}

// A CTA's whole work on one block x[0, valid) of the tensor [lo, hi), for a
// block of n_lanes <= Per * kThreads lanes: stage it, keep every lane
// (`copy`, the same in every thread), every lane but a NaN (k >= n_lanes:
// the mask there), or the k largest magnitudes of its n_lanes lanes, and
// write it to out[0, valid).
template <typename T, int Per>
__device__ __forceinline__ void sparsify_block(const T* x, T* out, int valid,
                                               const T* lo, const T* hi,
                                               int n_lanes, int k, bool copy) {
  __shared__ Stage<T, Per> stage;
  __shared__ SelectShared<Per> sel;
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
      sparsify(stage, sel, w.shift, valid, n_lanes, k);
    }
  }
  __syncthreads();
  store_block(out, valid, w.shift, stage);
}

// ---- the streaming select: a block wider than kMaxBlock -------------------
struct StreamShared {
  unsigned hist[kBins];
  int part[kWarps];
  int tie[kMaxPer * kWarps];     // a tile's (p, warp) tie counts, then scan
  int red[kWarps];
  int result[2];                 // pick_bin's (digit, rank)
  int carry;                     // ties in the tiles before
};

// the sum of v over the CTA, in every thread
__device__ __forceinline__ int cta_sum(int v, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += red[w];
  __syncthreads();
  return total;
}

// A CTA's whole work on one block x[0, valid) of n_lanes lanes (any width:
// lanes of [valid, n_lanes) compete as zeros and are not written), read
// from device memory in passes: keep every lane (`copy`), every lane but a
// NaN (k >= n_lanes), or the k largest magnitudes, writing out[0, valid).
// The same mask as keep_mask: the same digit passes, wrapped bisection,
// float tests and ties in index order (tile, p, warp, lane).
template <typename T>
__device__ __forceinline__ void stream_block(const T* __restrict__ x,
                                             T* __restrict__ out, int valid,
                                             int n_lanes, int k, bool copy) {
  __shared__ StreamShared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (copy || k >= n_lanes) {
    for (int e = tid; e < valid; e += kThreads) {
      const T v = x[e];
      out[e] = (!copy && mag_bits(v) > 0x7f800000) ? T(0) : v;
    }
    return;
  }
  const int pad = n_lanes - valid;             // zeros past the tail
  sh.hist[tid] = 0;
  __syncthreads();
  // pass 0 (the exponent, every lane) and the all-ones NaN test
  bool all_ones = false;
  for (int base = 0; base < valid; base += kThreads) {
    const int e = base + tid;
    const int b = e < valid ? mag_bits(x[e]) : -1;
    all_ones |= b == 0x7fffffff;
    if (k > 0) {
      // lanes of a warp that share a bin add once
      const int bin = b >= 0 ? b >> digit_shift(0) : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      if (bin >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&sh.hist[bin], static_cast<unsigned>(__popc(peers)));
    }
  }
  if (tid == 0 && pad > 0 && k > 0) atomicAdd(&sh.hist[0], static_cast<unsigned>(pad));
  const bool wrapped = __syncthreads_or(all_ones);
  int prefix = 0x7f800000;                     // k <= 0: as keep_mask
  if (wrapped) {
    // the reference's bisection with hi = max + 1 wrapped to INT_MIN
    int lo = 0, hi = INT_MIN;
    for (int it = 0; it < 31; ++it) {
      const int mid = wrap_add(lo, wrap_sub(hi, lo) >> 1);
      int cnt = 0;
      for (int e = tid; e < valid; e += kThreads) cnt += mag_bits(x[e]) >= mid;
      if (tid == 0 && 0 >= mid) cnt += pad;
      if (cta_sum(cnt, sh.red) >= k) lo = mid; else hi = mid;
    }
    prefix = lo;
  } else if (k > 0) {
    prefix = 0;
    int kk = k;
    for (int pass = 0; pass < kPasses; ++pass) {
      const int shift = digit_shift(pass), width = digit_bits(pass);
      const int top = shift + width, mask = (1 << width) - 1;
      if (pass > 0) {
        for (int base = 0; base < valid; base += kThreads) {
          const int e = base + tid;
          const int b = e < valid ? mag_bits(x[e]) : -1;
          const int bin = (b >= 0 && (b >> top) == prefix) ? (b >> shift) & mask : -1;
          const unsigned peers = __match_any_sync(0xffffffffu, bin);
          if (bin >= 0 && lane == __ffs(peers) - 1)
            atomicAdd(&sh.hist[bin], static_cast<unsigned>(__popc(peers)));
        }
        if (tid == 0 && pad > 0 && prefix == 0)
          atomicAdd(&sh.hist[0], static_cast<unsigned>(pad));
        __syncthreads();
      }
      int digit, rank;
      pick_bin(sh.hist, sh.part, sh.result, 1 << width, kk, digit, rank);
      prefix = (prefix << width) | digit;
      kk = rank;
    }
  }
  const float thresh = daz_float(prefix);      // the k-th largest |x|

  // the lanes above the threshold, the padding zeros among them
  int n_gt = 0;
  for (int e = tid; e < valid; e += kThreads)
    n_gt += daz_float(mag_bits(x[e])) > thresh;
  if (tid == 0 && 0.0f > thresh) n_gt += pad;
  const int room = k - cta_sum(n_gt, sh.red);  // ties that still fit

  // the write, a tile of kTile lanes at a time in index order; the padding
  // zeros come after every lane, so they never rank ahead of one
  const unsigned below = (1u << lane) - 1u;
  int carry = 0;
  for (int t0 = 0; t0 < valid; t0 += kTile) {
    T v[kMaxPer];
    unsigned gt = 0, eq = 0;                   // bit p: lane p's tests
#pragma unroll
    for (int p = 0; p < kMaxPer; ++p) {
      const int e = t0 + p * kThreads + tid;
      const bool in = e < valid;
      v[p] = in ? x[e] : T(0);
      const float mag = daz_float(in ? mag_bits(v[p]) : 0);
      gt |= static_cast<unsigned>(in && mag > thresh) << p;
      const bool equal = in && mag == thresh;
      eq |= static_cast<unsigned>(equal) << p;
      const unsigned ties = __ballot_sync(0xffffffffu, equal);
      if (lane == 0) sh.tie[p * kWarps + warp] = __popc(ties);
    }
    __syncthreads();
    const int next = scan_ties(sh.tie, kMaxPer * kWarps, carry);
    if (tid == 0) sh.carry = next;
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kMaxPer; ++p) {
      const int e = t0 + p * kThreads + tid;
      const bool equal = (eq >> p) & 1u;
      const unsigned ties = __ballot_sync(0xffffffffu, equal);
      const int rank = sh.tie[p * kWarps + warp] + __popc(ties & below) + 1;
      const bool keep = ((gt >> p) & 1u) || (equal && rank <= room);
      if (e < valid) out[e] = keep ? v[p] : T(0);
    }
    carry = sh.carry;
    __syncthreads();                           // sh.tie is the next tile's
  }
}

}  // namespace topk
