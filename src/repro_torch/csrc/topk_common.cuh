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
// max(bits) + 1 wraps to INT_MIN: the register tier runs that wrapped
// bisection itself, the other tiers take its closed form (below), to keep
// the reference's mask.
//
// Four tiers by block width, each one kernel of both files:
//   * register (256 to kMaxBlock = 4096 lanes; sparsify_block below): a CTA
//     of kThreads = 256 threads owns a block of at most Per * 256 lanes, Per
//     (the lanes a thread holds, a template parameter) one of 1, 2, 4, 8 and
//     16; a block of another width runs the smallest instance that holds
//     it, the lanes past the block not counted. Thread t holds lanes
//     t + 256 p (p < Per) in registers, so neighbouring threads read
//     neighbouring shared words, and the passes and the tie scan never touch
//     device memory again. The tie scan follows index order through (p, warp,
//     lane): a ballot a (p, warp), an exclusive scan of the Per * 8 (p, warp)
//     counts, a popcount below the lane. At 48 registers five such CTAs share
//     an SM: while some select, others load or store, and the 398 blocks of
//     the cross-silo exchange's vector run in one wave. (On the card, 1024
//     threads of 4 lanes, and a persistent grid of CTAs with a two-stage ring
//     of blocks, each measured slower.)
//   * narrow (1 to 255 lanes; narrow_blocks): a CTA takes a span of blocks,
//     each warp selecting its own with no CTA barrier.
//   * staged (wider, up to kStageBytes; staged_block): one CTA a block, the
//     block staged whole in dynamic shared memory, every pass read there.
//   * chunked (wider still; chunk_pass): chunks of kChunk lanes, one CTA a
//     chunk, one launch a pass, the block's histograms summed in a
//     workspace.
//
// Memory: a block (or span, or chunk) comes into shared memory by one bulk
// async copy (cp.async.bulk, completed on an mbarrier) of the 16-byte words
// that cover it (a row of odd length starts mid-word, so up to 12 bytes of
// each neighbour come along); only where those words would leave the tensor
// (its first or last block, when it starts or ends mid-word) is it loaded
// lane by lane. It goes back as one 16-byte store a thread, neighbouring
// threads on neighbouring words, the partial words at its ends lane by lane:
// only its own lanes are written.
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
constexpr int kNarrowMax = 255;               // the narrow tier's widest block
constexpr int kWarpSpan = 512;                // lanes a warp takes there, at most
constexpr int kStageBytes = 196608;           // the staged tier's widest block
constexpr int kChunk = 8192;                  // lanes a CTA of the chunked tier
// the widest block: int lane indices with a kMaxBlock tile to spare
constexpr int kMaxWidth = INT_MAX - kMaxBlock;

enum Tier { kTierNarrow, kTierRegister, kTierStaged, kTierChunked };

// the tier of a block of `block` lanes of `esize` bytes
__host__ __device__ constexpr Tier tier_of(long long block, int esize) {
  return block <= kNarrowMax ? kTierNarrow
       : block <= kMaxBlock ? kTierRegister
       : block * esize <= kStageBytes ? kTierStaged : kTierChunked;
}

// the lanes a thread holds in the register tier's smallest instance for a
// block of `block` lanes
__host__ __device__ constexpr int lanes_a_thread(long long block) {
  return block <= 256 ? 1 : block <= 512 ? 2 : block <= 1024 ? 4
       : block <= 2048 ? 8 : 16;
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

// One thread: start the bulk copy of the window into `stage` (16-byte
// aligned shared memory), completing on `bar` (nothing for a window that is
// not bulk).
template <typename T>
__device__ __forceinline__ void start_load(const T* x, const Window& w,
                                           T* stage, uint32_t bar) {
  if (!w.bulk) return;
  mbar_expect_tx(bar, w.words * 16);
  bulk_load(smem_u32(stage), x - w.shift, w.words * 16, bar);
}

// Every thread: wait for the window's bulk copy (the first phase of `bar`),
// or load its lanes one by one; either way the block is then visible to
// the thread.
template <typename T>
__device__ __forceinline__ void finish_load(const T* x, const Window& w,
                                            T* stage, uint32_t bar) {
  if (w.bulk) {
    mbar_wait(bar, 0);
  } else {
    for (int e = threadIdx.x; e < w.valid; e += kThreads)
      stage[e + w.shift] = x[e];
    __syncthreads();
  }
}

// Write `stage` (lane e at e + shift) to out[0, valid): its whole 16-byte
// words one a thread, neighbouring threads on neighbouring words, the
// partial words at either end lane by lane.
template <typename T>
__device__ __forceinline__ void store_block(T* out, int valid, int shift,
                                            const T* stage) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const int tid = threadIdx.x;
  const int out_shift =
      static_cast<int>((reinterpret_cast<uintptr_t>(out) & 15) / sizeof(T));
  const int head = min(valid, (kVec - out_shift) % kVec);
  const int n_words = (valid - head) / kVec;
  const int tail = head + n_words * kVec;
  uint4* dst = reinterpret_cast<uint4*>(out + head);
  if ((head + shift) % kVec == 0) {       // out and x start alike in a word
    const uint4* src = reinterpret_cast<const uint4*>(stage + head + shift);
    for (int j = tid; j < n_words; j += kThreads) dst[j] = src[j];
  } else {
    for (int j = tid; j < n_words; j += kThreads) {
      union { uint4 w; T v[kVec]; } u;
#pragma unroll
      for (int i = 0; i < kVec; ++i) u.v[i] = stage[head + shift + j * kVec + i];
      dst[j] = u.w;
    }
  }
  for (int e = tid; e < head; e += kThreads) out[e] = stage[e + shift];
  for (int e = tail + tid; e < valid; e += kThreads) out[e] = stage[e + shift];
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
  if (tid == 0) start_load(x, w, stage.data, bar_addr);
  finish_load(x, w, stage.data, bar_addr);
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
  store_block(out, valid, w.shift, stage.data);
}

// ---- the staged and chunked tiers: blocks wider than kMaxBlock -----------
// Neither holds its lanes in registers: a CTA reads them from shared memory,
// once a pass. The threshold comes from the same digits as keep_mask's, in
// closed forms where they end early:
//   * a block holding 0x7fffffff: the reference's bisection starts at
//     hi = INT_MIN, so every mid is negative, every count is the whole block
//     (>= k, as k < the block's width) and lo ends at INT_MIN + 1, whose
//     exponent field is 0: the threshold compares as 0.0;
//   * k <= 0 otherwise: the threshold is +Inf with no room (nothing kept);
//   * a top digit (the exponent) of 0: the threshold is a zero or a
//     denormal, which compares as 0.0 whatever its lower digits;
//   * else the four digits give the pattern T. A NaN T keeps nothing.
// The counts come from the histograms: at 0.0 the lanes above are those of
// a non-zero exponent less the NaNs (NaN fails every float test) and the
// ties those of exponent 0; at a normal T the lanes above are the k - rank
// patterns above T less the NaNs, and the ties the lanes of T's last bin.
// Ties are ranked in index order only where they do not all fit.
struct SelShared {
  unsigned hist[kBins];
  int part[kWarps];              // the bin scan's warp totals
  int red[kWarps];               // cta_sum's warp totals
  int result[3];                 // pick_digit's (digit, rank, count)
  int tie[kMaxPer * kWarps];     // a tile's (p, warp) tie counts, then scan
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

// pick_bin on a histogram that stays as it is (shared or device memory):
// the bin holding the kk-th largest pattern (1 <= kk <= the lanes counted),
// the rank left in it and the bin's count, in every thread of the CTA.
__device__ __forceinline__ void pick_digit(const unsigned* hist, int* part,
                                           int* result, int nb, int kk,
                                           int& digit, int& rank, int& count) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = nb - 1 - tid;
  const int cnt = d >= 0 ? static_cast<int>(hist[d]) : 0;
  int incl = warp_incl_scan(cnt);
  if (lane == 31) part[warp] = incl;
  __syncthreads();
  for (int w = 0; w < warp; ++w) incl += part[w];
  const int excl = incl - cnt;
  if (excl < kk && kk <= incl) {
    result[0] = d;
    result[1] = kk - excl;
    result[2] = cnt;
  }
  __syncthreads();
  digit = result[0];
  rank = result[1];
  count = result[2];
}

// How a block's select ended: still picking digits, at a threshold of 0.0,
// or keeping nothing (k <= 0 without the all-ones NaN)
enum Mode { kPicking, kAtZero, kNothing };

// The float tests' threshold, the ties that fit (k less the lanes above
// it) and the block's real lanes that tie with it.
struct Verdict {
  float thresh;
  int room, n_eq;
};

// at a threshold of 0.0: `zeros` lanes of exponent 0 (the `pad` padding
// zeros among them) of n_lanes, n_nan NaNs
__device__ __forceinline__ Verdict at_zero(int k, int n_lanes, int zeros,
                                           int pad, int n_nan) {
  return {0.0f, k - (n_lanes - zeros - n_nan), zeros - pad};
}

// after the four digits: pattern t, rank kk left in its bin of `count`
__device__ __forceinline__ Verdict at_pattern(int t, int kk, int count,
                                              int n_nan) {
  if (t > 0x7f800000) return {__int_as_float(t), 0, 0};   // NaN: none
  return {__int_as_float(t), kk + n_nan, count};
}

__device__ __forceinline__ Verdict nothing_kept(int k) {
  return {__int_as_float(0x7f800000), k, 0};
}

// every lane of data[0, valid) but a NaN kept (the mask at k >= the width)
template <typename T>
__device__ __forceinline__ void drop_nans(T* data, int valid) {
  for (int e = threadIdx.x; e < valid; e += kThreads)
    if (mag_bits(data[e]) > 0x7f800000) data[e] = T(0);
}

// data[0, valid) (lanes of a block, `carry` of the block's ties before
// them) with the lanes the verdict drops set to +0.0. Where every tie fits,
// or none does, no rank is needed; else the ties are ranked in index order
// a tile of kMaxBlock lanes at a time, as keep_mask ranks them: (p, warp,
// lane), the tiles' counts carried. Every thread of the CTA calls it.
template <typename T>
__device__ __forceinline__ void keep_lanes(T* data, int valid, const Verdict& v,
                                           int carry, SelShared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (v.room <= 0 || v.n_eq <= v.room) {
    const bool ties = v.room > 0;
    for (int e = tid; e < valid; e += kThreads) {
      const float mag = daz_float(mag_bits(data[e]));
      if (!(mag > v.thresh || (ties && mag == v.thresh))) data[e] = T(0);
    }
    return;
  }
  const unsigned below = (1u << lane) - 1u;
  for (int t0 = 0; t0 < valid; t0 += kMaxBlock) {
    unsigned gt = 0, eq = 0;                   // bit p: lane p's tests
#pragma unroll
    for (int p = 0; p < kMaxPer; ++p) {
      const int e = t0 + p * kThreads + tid;
      const bool in = e < valid;
      const float mag = daz_float(in ? mag_bits(data[e]) : 0);
      gt |= static_cast<unsigned>(in && mag > v.thresh) << p;
      const bool equal = in && mag == v.thresh;
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
      const bool keep = ((gt >> p) & 1u) || (equal && rank <= v.room);
      if (e < valid && !keep) data[e] = T(0);
    }
    carry = sh.carry;
    __syncthreads();                           // sh.tie is the next tile's
  }
}

// One thread's share of a pass over data[0, valid): digit `pass` of the
// lanes whose higher digits equal `prefix` (every lane at pass 0) into
// `hist`; at pass 0 also the thread's NaNs and whether it saw 0x7fffffff.
template <typename T>
__device__ __forceinline__ void histogram(const T* data, int valid, int pass,
                                          int prefix, unsigned* hist,
                                          bool& all_ones, int& nan) {
  const int shift = digit_shift(pass), width = digit_bits(pass);
  const int top = shift + width, mask = (1 << width) - 1;
  for (int e = threadIdx.x; e < valid; e += kThreads) {
    const int b = mag_bits(data[e]);
    if (pass == 0) {
      all_ones |= b == 0x7fffffff;
      nan += b > 0x7f800000;
    }
    if ((b >> top) == prefix) atomicAdd(&hist[(b >> shift) & mask], 1u);
  }
}

// (a) the staged tier: a block of up to kStageBytes, one CTA, staged whole
// in dynamic shared memory by one bulk copy. The select over data[0, valid)
// (lanes [valid, n_lanes) compete as zeros), k < n_lanes. Four passes over
// shared memory at most, each histogramming into one shared histogram.
template <typename T>
__device__ __forceinline__ Verdict staged_select(const T* data, int valid,
                                                 int n_lanes, int k,
                                                 SelShared& sh) {
  const int tid = threadIdx.x;
  const int pad = n_lanes - valid;
  sh.hist[tid] = 0;                            // kThreads == kBins
  __syncthreads();
  bool all_ones = false;
  int nan = 0;
  histogram(data, valid, 0, 0, sh.hist, all_ones, nan);
  if (tid == 0 && pad > 0) atomicAdd(&sh.hist[0], static_cast<unsigned>(pad));
  const int n_nan = cta_sum(nan, sh.red);      // its barrier ends the pass
  const bool wrapped = __syncthreads_or(all_ones);
  const int zeros = static_cast<int>(sh.hist[0]);
  if (wrapped) return at_zero(k, n_lanes, zeros, pad, n_nan);
  if (k <= 0) return nothing_kept(k);
  int prefix, kk, count;
  pick_digit(sh.hist, sh.part, sh.result, kBins, k, prefix, kk, count);
  if (prefix == 0) return at_zero(k, n_lanes, zeros, pad, n_nan);
  for (int pass = 1; pass < kPasses; ++pass) {
    sh.hist[tid] = 0;
    __syncthreads();
    histogram(data, valid, pass, prefix, sh.hist, all_ones, nan);
    __syncthreads();
    int digit;
    pick_digit(sh.hist, sh.part, sh.result, 1 << digit_bits(pass), kk, digit,
               kk, count);
    prefix = (prefix << digit_bits(pass)) | digit;
  }
  return at_pattern(prefix, kk, count, n_nan);
}

// bytes of dynamic shared memory that stage a block of `lanes` lanes of
// `esize` bytes: its covering 16-byte words
__host__ __device__ constexpr int stage_bytes(int lanes, int esize) {
  return (lanes * esize + 47) / 16 * 16;
}

// A CTA's whole work on one block x[0, valid) of n_lanes lanes
// (n_lanes * sizeof(T) <= kStageBytes): as sparsify_block, the select by
// staged_select.
template <typename T>
__device__ __forceinline__ void staged_block(const T* x, T* out, int valid,
                                             const T* lo, const T* hi,
                                             int n_lanes, int k, bool copy) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ SelShared sh;
  __shared__ unsigned long long bar;
  T* stage = reinterpret_cast<T*>(dyn_smem);
  const Window w = window_of(x, valid, lo, hi);
  const uint32_t bar_addr = smem_u32(&bar);
  if (threadIdx.x == 0) mbar_init(bar_addr, 1);
  __syncthreads();
  if (threadIdx.x == 0) start_load(x, w, stage, bar_addr);
  finish_load(x, w, stage, bar_addr);
  T* data = stage + w.shift;
  if (!copy) {
    if (k >= n_lanes) {
      drop_nans(data, valid);
    } else {
      const Verdict v = staged_select(data, valid, n_lanes, k, sh);
      keep_lanes(data, valid, v, 0, sh);
    }
  }
  __syncthreads();
  store_block(out, valid, w.shift, stage);
}

// (b) the chunked tier: a wider block cut into chunks of kChunk lanes, one
// CTA a chunk, in kPasses + 1 launches that each stage the chunk by one
// bulk copy: launch p < 4 adds the chunk's histogram of digit p (of the
// lanes that match the digits before, which every CTA picks again from the
// block's histograms) into the block's; launch 4 picks the last digit and
// writes the chunk, its ties ranked after the ties of the chunks before it
// (chunk order is index order) by counts each chunk left in the workspace.
// Workspace, unsigned words: a header a block (zeroed before launch 0 by a
// clear kernel) — the four histograms at kBins * p, the NaN count, the
// all-ones flag — then a record a chunk, written by its own CTA: its
// lanes of exponent 0 (launch 0), and its bins of the last digit (launch 3).
constexpr int kLastBins = 1 << digit_bits(kPasses - 1);
constexpr int kNanWord = (kPasses - 1) * kBins + kLastBins;
constexpr int kOnesWord = kNanWord + 1;
constexpr int kHeaderWords = 1024;
constexpr int kChunkWords = 1 + kLastBins;     // exponent-0 lanes, last bins
static_assert(kOnesWord < kHeaderWords, "a block's header holds its words");

__host__ __device__ constexpr long long chunks_a_block(long long block) {
  return (block + kChunk - 1) / kChunk;
}

// the chunked tier's workspace for n_blocks blocks of `block` lanes
__host__ __device__ constexpr long long chunk_ws_words(long long n_blocks,
                                                       long long block) {
  return n_blocks * (kHeaderWords + chunks_a_block(block) * kChunkWords);
}

// The picks of the first `passes` digits from a block's histograms: the
// same in every CTA of the block (every thread calls it).
struct Picked {
  Mode mode;
  int prefix, kk, count;
};

__device__ __forceinline__ Picked replay_picks(const unsigned* hdr, int k,
                                               int passes, SelShared& sh) {
  Picked s{kPicking, 0, k, 0};
  if (hdr[kOnesWord]) {
    s.mode = kAtZero;
    return s;
  }
  if (k <= 0) {
    s.mode = kNothing;
    return s;
  }
  for (int p = 0; p < passes; ++p) {
    int digit;
    pick_digit(hdr + kBins * p, sh.part, sh.result, 1 << digit_bits(p), s.kk,
               digit, s.kk, s.count);
    s.prefix = (s.prefix << digit_bits(p)) | digit;
    if (p == 0 && digit == 0) {
      s.mode = kAtZero;
      return s;
    }
  }
  return s;
}

// A block's place: its first lane in the tensor, its lanes there (the rest
// of its width competes as zeros) and its k.
struct Blk {
  long long start;
  int valid, k;
};

// One CTA of launch `pass` of the chunked tier: chunk c of block b (`blk`),
// `w` lanes wide, of a tensor of n_blocks blocks; `copy` keeps every lane.
template <typename T>
__device__ __forceinline__ void chunk_pass(const T* x, T* out, const T* lo,
                                           const T* hi, unsigned* ws,
                                           long long n_blocks, int w, int pass,
                                           long long b, int c, const Blk& blk,
                                           bool copy) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ SelShared sh;
  __shared__ unsigned long long bar;
  const int tid = threadIdx.x;
  const bool full = copy || blk.k >= w;
  if (pass < kPasses && full) return;
  unsigned* hdr = ws + b * kHeaderWords;
  unsigned* rec = ws + n_blocks * kHeaderWords +
                  (b * chunks_a_block(w) + c) * kChunkWords;
  Picked s{kPicking, 0, blk.k, 0};
  if (pass > 0 && !full) {
    s = replay_picks(hdr, blk.k, pass, sh);
    if (pass < kPasses && s.mode != kPicking) return;
  }
  // the chunk's lanes, staged
  const long long c0 = static_cast<long long>(c) * kChunk;
  const long long left = blk.valid - c0;
  const int valid = left <= 0 ? 0 : left < kChunk ? static_cast<int>(left) : kChunk;
  const T* xc = x + blk.start + c0;
  T* stage = reinterpret_cast<T*>(dyn_smem);
  const Window win = window_of(xc, valid, lo, hi);
  const uint32_t bar_addr = smem_u32(&bar);
  if (tid == 0) mbar_init(bar_addr, 1);
  sh.hist[tid] = 0;                            // kThreads == kBins
  __syncthreads();
  if (valid > 0) {
    if (tid == 0) start_load(xc, win, stage, bar_addr);
    finish_load(xc, win, stage, bar_addr);
  }
  T* data = stage + win.shift;

  bool all_ones = false;
  int nan = 0;
  if (pass < kPasses) histogram(data, valid, pass, s.prefix, sh.hist, all_ones, nan);
  if (pass == 0) {                             // the exponent, NaNs, all-ones
    nan = cta_sum(nan, sh.red);
    const bool ones = __syncthreads_or(all_ones);
    unsigned h = sh.hist[tid];
    if (tid == 0) {
      rec[0] = h;                              // the chunk's exponent-0 lanes
      if (c == 0) h += static_cast<unsigned>(w - blk.valid);   // padding
      if (nan) atomicAdd(&hdr[kNanWord], static_cast<unsigned>(nan));
      if (ones) atomicOr(&hdr[kOnesWord], 1u);
    }
    if (h) atomicAdd(&hdr[tid], h);
    return;
  }
  if (pass < kPasses) {                        // digit `pass` under the prefix
    __syncthreads();
    if (tid < (1 << digit_bits(pass))) {
      const unsigned h = sh.hist[tid];
      if (h) atomicAdd(&hdr[kBins * pass + tid], h);
      if (pass == kPasses - 1) rec[1 + tid] = h;
    }
    return;
  }

  // the write
  if (!full) {
    const int pad = w - blk.valid;
    const int n_nan = static_cast<int>(hdr[kNanWord]);
    const Verdict v =
        s.mode == kAtZero ? at_zero(blk.k, w, static_cast<int>(hdr[0]), pad, n_nan)
        : s.mode == kNothing ? nothing_kept(blk.k)
                             : at_pattern(s.prefix, s.kk, s.count, n_nan);
    int carry = 0;
    if (v.room > 0 && v.n_eq > v.room) {       // ties in the chunks before
      const int word = s.mode == kAtZero ? 0 : 1 + (s.prefix & (kLastBins - 1));
      const unsigned* first = rec - static_cast<long long>(c) * kChunkWords;
      int n = 0;
      for (int j = tid; j < c; j += kThreads) n += first[j * kChunkWords + word];
      carry = cta_sum(n, sh.red);
    }
    keep_lanes(data, valid, v, carry, sh);
  } else if (!copy) {
    drop_nans(data, valid);
  }
  __syncthreads();
  if (valid > 0) store_block(out + blk.start + c0, valid, win.shift, stage);
}

// Zero n words of the chunked tier's workspace (its block headers).
__device__ __forceinline__ void clear_words(unsigned* ws, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x)
    ws[i] = 0;
}

// ---- the narrow tier: blocks of 1 to kNarrowMax lanes, several a CTA ------
// Consecutive blocks tile the tensor, so a CTA's blocks are one contiguous
// span of at most kMaxBlock lanes: one bulk copy stages it and 16-byte
// stores write it back, as for one block. Each warp takes narrow_bpw blocks
// of the span (at most kWarpSpan lanes) and selects inside the warp, with
// no CTA barrier: a block of 33 lanes or more on the whole warp, lane e at
// (row e / 32, lane e % 32), narrow_per rows, one instance a row count;
// blocks of 32 lanes or fewer side by side, one to a segment of narrow_seg
// lanes (a power of two), 16 rows of them. The threshold takes the staged
// tier's closed forms for the all-ones NaN (0.0) and k <= 0 (nothing
// kept); else it is the k-th largest pattern: in a segment, the pattern of
// the lane that k - 1 others precede (larger patterns, or equal ones at a
// lower lane), each lane counting its predecessors over w shuffles; on the
// whole warp, a bisection of the patterns from 0 to max + 1, each count a
// warp reduction. Then the float tests and the ties in (row, lane) order,
// which is index order. A block with k >= its width keeps every lane but a
// NaN (the clipped k at width 1), and a warp whose blocks all do skips the
// select.
__host__ __device__ constexpr int narrow_seg(int w) {
  return w > 16 ? 32 : w > 8 ? 16 : w > 4 ? 8 : w > 2 ? 4 : w;
}
__host__ __device__ constexpr int narrow_per(int w) {
  return w <= 32 ? 1 : (w + 31) / 32;
}
// blocks a warp: 16 rows of 32 / narrow_seg segments, or kWarpSpan / w
__host__ __device__ constexpr int narrow_bpw(int w) {
  return w <= 32 ? kWarpSpan / narrow_seg(w) : kWarpSpan / w;
}

// One warp's blocks of at most 32 lanes, from block gw, the CTA's ending
// before g1; lane e of the span (from s0) at data[e].
template <typename T, typename Geo>
__device__ __forceinline__ void narrow_segments(T* data, long long gw,
                                                long long g1, long long s0,
                                                int w, const Geo& geo) {
  const int lane = threadIdx.x & 31;
  const int seg = narrow_seg(w), sid = lane / seg, pos = lane - sid * seg;
  const int base = lane - pos;                 // the segment's first lane
  const unsigned seg_mask =
      seg == 32 ? 0xffffffffu : ((1u << seg) - 1u) << base;
  const unsigned below = (1u << lane) - 1u;
  for (int r = 0; r < kWarpSpan / 32; ++r) {
    const long long g = gw + static_cast<long long>(r) * (32 / seg) + sid;
    const bool live = g < g1;
    Blk blk{s0, 0, w};
    if (live) blk = geo(g);
    const int e = static_cast<int>(blk.start - s0) + pos;
    const bool counted = live && pos < w;
    const bool real = live && pos < blk.valid;
    const int bits = real ? mag_bits(data[e]) : 0;
    bool keep = bits <= 0x7f800000;            // k >= w: all but a NaN
    if (__any_sync(0xffffffffu, counted && blk.k < w)) {
      int before = 0;                          // lanes ahead of this one
      for (int j = 0; j < w; ++j) {
        const int b = __shfl_sync(0xffffffffu, bits, base + j);
        before += b > bits || (b == bits && j < pos);
      }
      const unsigned kth =
          __ballot_sync(0xffffffffu, counted && before == blk.k - 1) & seg_mask;
      const int t = __shfl_sync(0xffffffffu, bits, __ffs(kth) - 1);
      const bool wrapped =
          (__ballot_sync(0xffffffffu, bits == 0x7fffffff) & seg_mask) != 0;
      const float thresh =
          daz_float(wrapped ? 0 : blk.k <= 0 ? 0x7f800000 : t);
      const float mag = daz_float(bits);
      const bool gt = counted && mag > thresh, eq = counted && mag == thresh;
      const int n_gt = __popc(__ballot_sync(0xffffffffu, gt) & seg_mask);
      const unsigned ties = __ballot_sync(0xffffffffu, eq) & seg_mask;
      if (blk.k < w)
        keep = gt || (eq && __popc(ties & below) + 1 <= blk.k - n_gt);
    }
    if (real && !keep) data[e] = T(0);
  }
}

// One warp's blocks of 33 to kNarrowMax lanes, Per = narrow_per(w) rows of
// 32, one block at a time.
template <int Per, typename T, typename Geo>
__device__ __forceinline__ void narrow_rows(T* data, long long gw,
                                            long long g1, long long s0, int w,
                                            const Geo& geo) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  for (int j = 0; j < narrow_bpw(w) && gw + j < g1; ++j) {
    const Blk blk = geo(gw + j);
    T* x = data + (blk.start - s0);
    int bits[Per];                             // -1 past the block's width
    bool all_ones = false;
#pragma unroll
    for (int p = 0; p < Per; ++p) {
      const int e = p * 32 + lane;
      bits[p] = e < blk.valid ? mag_bits(x[e]) : e < w ? 0 : -1;
      all_ones |= bits[p] == 0x7fffffff;
    }
    if (blk.k >= w) {
#pragma unroll
      for (int p = 0; p < Per; ++p)
        if (p * 32 + lane < blk.valid && bits[p] > 0x7f800000) x[p * 32 + lane] = T(0);
      continue;
    }
    int t = 0;                                 // the all-ones NaN: 0.0
    if (!__any_sync(0xffffffffu, all_ones)) {
      t = 0x7f800000;                          // k <= 0: nothing kept
      if (blk.k > 0) {
        int m = 0;
#pragma unroll
        for (int p = 0; p < Per; ++p) m = max(m, bits[p]);
        // count(bits >= lo) >= k > count(bits >= hi), every mid >= 0
        int lo = 0, hi = __reduce_max_sync(0xffffffffu, m) + 1;
        while (hi - lo > 1) {
          const int mid = lo + ((hi - lo) >> 1);
          int cnt = 0;
#pragma unroll
          for (int p = 0; p < Per; ++p) cnt += bits[p] >= mid;
          if (__reduce_add_sync(0xffffffffu, cnt) >= blk.k) lo = mid; else hi = mid;
        }
        t = lo;
      }
    }
    const float thresh = daz_float(t);
    int n_gt = 0;
#pragma unroll
    for (int p = 0; p < Per; ++p) n_gt += bits[p] >= 0 && daz_float(bits[p]) > thresh;
    const int room = blk.k - __reduce_add_sync(0xffffffffu, n_gt);
    int carry = 0;
#pragma unroll
    for (int p = 0; p < Per; ++p) {
      const int e = p * 32 + lane;
      const float mag = daz_float(bits[p]);
      const bool eq = bits[p] >= 0 && mag == thresh;
      const unsigned ties = __ballot_sync(0xffffffffu, eq);
      const bool keep = (bits[p] >= 0 && mag > thresh) ||
                        (eq && carry + __popc(ties & below) + 1 <= room);
      carry += __popc(ties);
      if (e < blk.valid && !keep) x[e] = T(0);
    }
  }
}

// A CTA's whole work on its blocks of the narrow tier: blocks
// [g0, g0 + kWarps * narrow_bpw(w)) of n_blocks, each `geo(g)`, in the
// tensor [lo, hi); `copy` keeps every lane.
template <typename T, typename Geo>
__device__ __forceinline__ void narrow_blocks(const T* x, T* out, const T* lo,
                                              const T* hi, long long n_blocks,
                                              int w, const Geo& geo, bool copy) {
  __shared__ Stage<T, kMaxPer> stage;
  __shared__ unsigned long long bar;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int bpw = narrow_bpw(w);
  const long long g0 = static_cast<long long>(blockIdx.x) * (kWarps * bpw);
  const long long g1 =
      g0 + kWarps * bpw < n_blocks ? g0 + kWarps * bpw : n_blocks;
  const Blk first = geo(g0), last = geo(g1 - 1);
  const long long s0 = first.start;
  const int span = static_cast<int>(last.start + last.valid - s0);
  const Window win = window_of(x + s0, span, lo, hi);
  const uint32_t bar_addr = smem_u32(&bar);
  if (tid == 0) mbar_init(bar_addr, 1);
  __syncthreads();
  if (tid == 0) start_load(x + s0, win, stage.data, bar_addr);
  finish_load(x + s0, win, stage.data, bar_addr);
  T* data = stage.data + win.shift;
  if (!copy) {
    const long long gw = g0 + static_cast<long long>(warp) * bpw;
    switch (narrow_per(w)) {
      case 1: narrow_segments(data, gw, g1, s0, w, geo); break;
      case 2: narrow_rows<2>(data, gw, g1, s0, w, geo); break;
      case 3: narrow_rows<3>(data, gw, g1, s0, w, geo); break;
      case 4: narrow_rows<4>(data, gw, g1, s0, w, geo); break;
      case 5: narrow_rows<5>(data, gw, g1, s0, w, geo); break;
      case 6: narrow_rows<6>(data, gw, g1, s0, w, geo); break;
      case 7: narrow_rows<7>(data, gw, g1, s0, w, geo); break;
      default: narrow_rows<8>(data, gw, g1, s0, w, geo); break;
    }
  }
  __syncthreads();
  store_block(out + s0, span, win.shift, stage.data);
}

}  // namespace topk
