// Causal / sliding-window GQA flash attention (forward) in bf16 and fp16 on
// Hopper's tensor cores (sm_90a): wgmma fed by TMA through mbarrier rings,
// with two consumer warpgroups and a producer warpgroup whose one thread
// loads. The kernels and their host-side launchers, templated on the element
// type E (__nv_bfloat16 or __half); the translation units instantiate them:
//   flash_attention_sm90.cu       bf16, head dims 8..256 (the entries
//                                 flash_attention_fwd_bf16 / _attrs_bf16)
//   flash_attention_sm90_f16.cu   fp16, head dims 8..256 (the entries
//                                 flash_attention_fwd_f16 / _attrs_f16)
//   flash_attention_sm90_wide.cu  both types, head dims 257..1,792 (the
//                                 wide kernel up to 320, a cluster above);
//                                 past 1,792 the split route of
//                                 flash_split.cuh
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// _flash_kernel (entry flash_attention_pallas) for bf16 and fp16 inputs;
// fp32 takes the SIMT kernel of flash_simt.cuh and, past a head dim of 128,
// the 3xTF32 kernel of flash_tf32.cuh (one TF32 product would not hold
// fp32's 1e-5; three do). In the port it runs on the
// flash branch of models/attention.attention_forward (sequences of 2048 or
// more), once per layer of a bf16 or fp16 prefill.
//
// q [B, Sq, H, D], k and v [B, Skv, KV, D], bf16 or fp16, contiguous, read in
// place (no transpose copy); o [B, Sq, H, D] of the same type; lse, when not
// null, [B, H, Sq] fp32 (the JAX package's [B, KV, G, Sq], h = kv G + g): the
// log-sum-exp of each row's scaled scores, m + log(max(l, 1e-30)), from the
// fp32 running max and sum (not from the rounded P), which the training
// path's backward (kernels/flash_attention/ref.py: flash_bwd_ref) reads. A
// null lse writes nothing, so the serve path does the work it did without
// it. Query head h reads KV head h / (H / KV). What it computes is the Pallas
// kernel's function:
//   S = Q K^T accumulated in fp32, then multiplied by 1/sqrt(D) in fp32;
//   a masked score (key > row when causal, row - key >= window) is -1e30,
//   not -inf; m, l and O are fp32 (online softmax, one rescale per tile of
//   keys); o = O / max(l, 1e-30), rounded to E.
// A row whose keys so far are all masked sums exp(0) = 1 terms, and the
// next visible key's correction exp(-1e30 - m) = 0 wipes them, as in the
// Pallas kernel; so key tiles wholly above the diagonal or wholly before
// the window are skipped without changing a bit. A row with no visible key
// at all (a window that ends before Skv: row >= Skv - 1 + window) is the
// mean of V over all Skv keys, as in the plain version; a query tile that
// holds such a row walks every key tile and skips none. TMA zero-fills
// rows past the tensor's end: a zero key scores 0, so keys >= Skv are set
// to -inf, which makes them absent (exp(-inf - m) = 0 even while m is
// -1e30); query rows >= Sq are computed but not stored.
// The one numeric change against the fp32 SIMT kernel: the probabilities P
// are rounded to E before O += P V (as SDPA and FA2/FA3 do; l sums the fp32
// P). chip_smoke.py holds both types to the plain version (fp32 P) at 2e-2.
// fp16 differs from bf16 only in its wgmma type (.f16), its TMA data type,
// and the rounding of P and o (10 mantissa bits against 7).
//
// What bounds it on an H100 SXM at the serve path's shapes (B = 4, H = 32,
// KV = 4, S = 2048, D = 64, causal): 2 * 2 * B * H * D * S(S+1)/2 = 6.87e10
// operations, 0.069 ms at 989 TFLOP/s of bf16 or fp16 tensor cores, against
// 75.5 MB of q, k, v and o, 0.023 ms at 3.35 TB/s: operations. So the
// products run on the tensor cores, and the design keeps them fed:
//   * a CTA owns a 128-row query tile of one (batch, head): consumer
//     warpgroup c (c = 0, 1) its rows 64c .. 64c + 63, plus one producer
//     warpgroup of which one thread issues every TMA load; setmaxnreg moves
//     registers from the producer (24) to the consumers (240);
//   * Q is loaded once; K and V tiles of BK keys (128 for DP <= 64, 64 up
//     to 160, 32 above) stream through a ring of kStages stages in dynamic shared
//     memory, each stage guarded by a "full" mbarrier (expect_tx bytes) and
//     an "empty" one (one arrival per consumer warp);
//   * the tensor maps are 4-D over (D, heads, S, B) with a box of
//     (D-chunk, 1, rows, 1): one head's rows at stride heads * D load as a
//     dense tile. A chunk is 64 columns (128 B, 128-byte swizzle) when the
//     computed width DP is a multiple of 64, else 32 columns (64 B, 64-byte
//     swizzle): DP = 32 loads one chunk, 64 one, 96 three, 128 two, 160
//     five, 192 three, 224 seven, 256 four. The wgmma descriptors name the
//     same swizzle;
//   * S = Q K^T is wgmma m64n{BK}k16 with both operands in shared memory
//     (K's rows are keys with D contiguous: K-major); O += P V is wgmma
//     m64n{DP}k16 (DP = D rounded up to 32) with P from registers (the
//     accumulator layout of S is the A-fragment layout of the next product)
//     and V read through the descriptor's transpose (V is MN-major for this
//     product, its chunks a leading byte offset of BK * SW apart): no copy;
//   * row max and row sum are shuffles across the four threads of a row;
//     the mask is applied only on tiles that cross the diagonal, the window
//     edge or Skv;
//   * the grid is (B * H, ceil(Sq / 128)) with the heavy (late) causal query
//     tiles launched first across all heads, so the short tiles fill the
//     tail of the wave. B * H is on grid x (up to 2^31 - 1), the query tiles
//     on y (up to 65,535: Sq up to 8,388,480).
// Head dims up to 256. The kernel is compiled for a computed width DP = D
// rounded up to 32 (32, 64, ..., 256) and takes D, a multiple of 8 (the
// TMA's 16-byte row stride), at run time (each DP also has an EXACT instance
// for D == DP, whose D is a compile-time constant); the wrapper zero-pads q,
// k and v of any other D to the next multiple of 8 and slices o
// (kernels/flash_attention/ops.py). The tensor maps' innermost extent stays
// D, so the TMA zero-fills columns D..DP-1 of each row's last box (and
// counts the whole box in expect_tx); those zeros add exact zeros to every
// score, give zero columns of O, and only the D real columns are stored; the
// scale stays the wrapper's 1/sqrt(D). DP a multiple of 64 (64, 128, 192,
// 256) takes 64-column chunks under the 128-byte swizzle; the others (32,
// 96, 160, 224) 32-column chunks under the 64-byte swizzle: D = 96 is the D
// = 32 layout three times, 160 and 224 the same five and seven times. P V is
// wgmma m64n{DP}k16 with V MN-major across the CHUNKS swizzle atoms, a
// leading byte offset of one chunk apart. Keys come in tiles of 128 at DP <=
// 64, of 64 up to DP = 160 and of 32 above: ptxas allocates a consumer
// thread the launch's 168 registers (not setmaxnreg's 240), and at 64 keys
// the 32 fp32 scores beside O's DP / 2 accumulators spilled at DP = 224 and
// 256 (252 and 288 bytes) and serialized the wgmma at 192; at 32 keys they
// hold 16. At DP = 256 the Q tile (64 KB) and two stages of K and V tiles
// (64 KB) fit the 227 KB of shared memory. At D < DP at most D / DP of the
// bound's rate is reachable.
// Head dims above 256. wgmma caps P V's N at 256, O's DP / 2 accumulators a
// thread fill the consumers' registers at 256, and a resident Q tile grows
// with D past the shared memory. So O is cut into NG = ceil(D / 224) column
// groups of GW = ceil(D / NG) rounded up to 32 columns (160, 192 or 224: one
// instance each, whatever D), one group a CTA on grid z; the last group's
// columns past D are zero-filled or never loaded, and are not stored. (A
// group of 256 columns spilled 192 bytes a thread in the wide kernel's chunk
// loop, beside O's 128 accumulators, and ran D = 512 in 11.5 ms on an NVIDIA
// H100 80GB HBM3 at 700 W against the 3.1 ms its operations scale to from
// D = 256; the DP = 256 instance above, with no chunk loop, still spills 128
// bytes: groups stop at 224.)
// From D = 321 to 1,792 (NG <= 8, the portable cluster size;
// flash_fwd_sm90_cluster) the NG CTAs of a query tile are one thread-block
// cluster (1, 1, NG), and S = Q K^T is computed once:
//   * CTA g holds Q's GW columns of its group, resident (loaded once: at most
//     56 KB), and streams the K and V tiles of its columns (32 x GW, the
//     Cfg<GW> layout) through a ring of three stages. Chunks wholly past D
//     are never loaded; Q's and K's are zeroed once, so QK^T reads zeros
//     there, and V's reach only O columns that are not stored;
//   * per key tile t, each consumer warpgroup computes its 64 x 32 partial
//     scores over its group's columns (wgmma m64n32k16, GW / 16 k-steps on
//     one accumulator), writes them to the next of four partial tiles in its
//     shared memory, and (after a warpgroup barrier) one thread arrives on
//     that tile's "full" mbarrier in every CTA of the cluster (mapa, then
//     mbarrier.arrive.shared::cluster). Then it takes tile t - 1's S: it
//     waits on its own barrier (acquire at cluster scope), reads the NG
//     partials through ld.shared::cluster, adds them in the order g = 0, 1,
//     ..., runs the online softmax and O += P V over its GW columns (wgmma
//     m64n{GW}k16), and releases t - 1's stage. So the peers' arrivals
//     travel while t's QK^T runs, and every CTA holds the same S, m, l and P,
//     bit for bit; group 0 alone writes lse. A partial tile is reused four
//     exchanges later: by then every peer has published the exchange two
//     back, which it does only after it read the one four back, so no
//     "empty" barrier is needed. The exchange runs per warpgroup, on the
//     tiles it does not skip: warpgroup w of every CTA skips the same tiles
//     (same q0), so its barriers' phases advance alike;
//   * every thread, the producer warpgroup's too, meets a cluster barrier
//     after the mbarriers are initialised and again before it exits: no CTA
//     leaves while a peer may still read its partials or arrive on its
//     barriers;
//   * the arrivals are at CTA scope: a fence.acq_rel.cluster before them
//     (the PTX model's cluster-scope release) took D = 1,024 from 15.24 to
//     16.44 ms, and arrivals with release at cluster scope from every warp
//     took it to 28.8 (NVIDIA H100 80GB HBM3, 700 W;
//     scripts/flash16_variants.py); the partial tile is in the writer's
//     shared memory once the warpgroup barrier has passed;
//   * what bounds it: each partial tile (8 KB) is read by the NG - 1 other
//     CTAs, (NG - 1) x 8 KB a warpgroup a tile over distributed shared
//     memory. A reduce-scatter (each CTA summing 1 / NG of the tile in the
//     fixed order, then everyone reading the sums) moves 2 (NG - 1) / NG of a
//     tile but takes two exchanges a tile: on the same card it ran D = 264
//     3.28 against 2.67 ms, 512 6.78 against 5.21, 1,024 14.77 against
//     15.24, 1,792 24.97 against 28.29 (scripts/flash16_variants.py, A B B
//     A; PERF.md), so the kernel reads every partial. Shared memory a CTA: Q,
//     three stages of K and V, eight partial tiles (64 KB): 164 KB at GW =
//     160, 184 KB at 192, 204 KB at 224;
//   * up to D = 320 (two groups of 160) the wide kernel below ran faster
//     (2.10 against 2.72 ms at D = 264), so it keeps those head dims.
// Up to 320 (flash_fwd_sm90_wide):
//   * every CTA computes the full score tile S = Q K^T over all of D, in
//     chunks of 64 columns taken in order (wgmma m64n{BK}k16, four k-steps
//     a chunk, chained on one accumulator): Q's and K's chunks come through
//     TMA boxes of one chunk each into a ring of kA stages (a 16 KB Q chunk
//     and a BK x 64 K chunk a stage), so shared memory does not grow with D;
//     the chunk ring's stage is released when the products that read it have
//     completed (wgmma.wait_group 1 keeps the next chunk's in flight);
//   * every group computes the same S, m and l, bit for bit, and runs the
//     same online softmax; each accumulates only its own GW columns of O
//     (wgmma m64n{GW}k16 from a ring of kV V tiles of BK x GW), and group 0
//     alone writes lse; V chunks wholly past D are not loaded;
//   * QK^T is repeated once a group, and Q is read again for every key tile:
//     at two groups the products are 1.5x the bound's operations (the kernel
//     took D = 512, three groups of 192, at 2x until the cluster did). Keys
//     come in tiles of 64 at GW = 160 and of 32 above, as
//     for DP (O's GW / 2 accumulators beside S's BK / 2). Shared memory a
//     CTA: kA = 4 chunk stages (20 KB each at BK = 32, 24 KB at BK = 64)
//     and kV = 2 V stages (BK x GW x 2 bytes: 12 to 20 KB), 104 to 136 KB
//     of the 227 KB. (Q read once into the shared memory the rings leave,
//     where it fits, ran D = 512 no faster on an NVIDIA H100 80GB HBM3 at
//     700 W, 6.46 against 6.32 ms: the L2 traffic of the streamed Q is not
//     what bounds it);
//   * D is taken at run time (a multiple of 8, as above); the grid is
//     (B * H, ceil(Sq / 128), 2).
// Past 1,792 (more than 8 groups: no portable cluster) the split route
// (flash_split.cuh) computes the scores once into a workspace in device
// memory and P V by group from it.
// Left for later: ping-pong scheduling of the two consumers, overlap of the
// softmax (and, in a cluster, the exchange) with the next tile's QK^T, one
// K/V tile shared by the query heads of a GQA group, and fewer waits in the
// wide kernel's chunk loop: a key tile of 32 takes a barrier wait and a wgmma
// wait for every 64 columns of D.
//
// A wait on an mbarrier that does not complete within ~2^31 cycles (about a
// second) traps, so a protocol fault ends the launch with an error instead
// of hanging the card.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// The instances past 256 (flash_attention_sm90_wide.cu: the wide kernel up
// to 320, the cluster kernel to 1,792) behind the entries of both types:
// dtype 0 = bf16, 1 = fp16; 256 < D <= 1,792 (the split route, past it, has
// an entry of its own).
extern "C" int flash_sm90_wide_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int Sq, int Skv, int H, int KV, int D,
                                   int causal, int window, float scale,
                                   void* stream);
extern "C" int flash_sm90_wide_attrs(int dtype, int D, int* out);

namespace {

template <typename E>
constexpr bool kIsHalf = std::is_same_v<E, __half>;

constexpr int kRowsWG = 64;                 // query rows per consumer warpgroup
constexpr int kConsumers = 2;               // consumer warpgroups per CTA
constexpr int kRows = kRowsWG * kConsumers;  // query rows per CTA
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducer = 128 * kConsumers;  // the thread that issues TMA
constexpr int kStages = 2;
constexpr int kMaxWidth = 256;              // the widest O (DP) a CTA holds
constexpr int kMaxGroup = 224;              // the widest column group above it
constexpr int kMaxCluster = 8;              // the portable cluster size
constexpr int kMaxClusterDim = kMaxGroup * kMaxCluster;   // 1,792
// Two groups of 160 (D <= 320) ran faster on the wide kernel than in a
// cluster (scripts/kernel_ab.py): the cluster kernel takes D from 321.
constexpr int kMinClusterDim = 321;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int DP_>
struct Cfg {
  static_assert(DP_ % 32 == 0 && DP_ <= kMaxWidth, "DP: a multiple of 32 up to 256");
  static constexpr int DP = DP_;                       // computed columns
  // keys per tile: 32 from DP = 192, where S's 32 fp32 registers at 64 keys
  // beside O's DP / 2 would spill
  static constexpr int BK = DP <= 64 ? 128 : DP <= 160 ? 64 : 32;
  static constexpr int SW = DP % 64 == 0 ? 128 : 64;   // bytes per chunk row
  static constexpr int COLS = SW / 2;                  // columns per chunk
  static constexpr int CHUNKS = DP / COLS;
  static constexpr int Q_BYTES = kRows * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;         // one K or V tile
  static constexpr int TILE_BYTES = Q_BYTES + 2 * kStages * KV_BYTES;
  static constexpr int N_BARS = 1 + 2 * kStages;
  static constexpr int SMEM = 1024 + TILE_BYTES + 8 * N_BARS;  // + alignment
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;  // wgmma swizzle code
};

// The cluster kernel's tiles (256 < D <= 1,792): Q's GW columns resident,
// K and V tiles of BK x GW through a ring of three stages, and four partial
// score tiles (64 x BK fp32) for each consumer warpgroup, used in turn. The
// layout of Q, K and V is Cfg<GW>'s.
template <int GW_>
struct ClusterCfg {
  static_assert(GW_ % 32 == 0 && GW_ >= 160 && GW_ <= kMaxGroup,
                "GW: a multiple of 32 in 160..224");
  static constexpr int GW = GW_;
  static constexpr int BK = 32;                        // keys a tile
  static constexpr int SW = GW % 64 == 0 ? 128 : 64;   // bytes per chunk row
  static constexpr int COLS = SW / 2;                  // columns per chunk
  static constexpr int CHUNKS = GW / COLS;
  static constexpr int STAGES = 3;
  static constexpr int SLOTS = 4;
  static constexpr int Q_BYTES = kRows * GW * 2;
  static constexpr int KV_BYTES = BK * GW * 2;         // one K or V tile
  static constexpr int X_BYTES = kRowsWG * BK * 4;     // one partial tile
  static constexpr int V_OFF = Q_BYTES + STAGES * KV_BYTES;
  static constexpr int X_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int TILE_BYTES = X_OFF + SLOTS * kConsumers * X_BYTES;
  // q_full, full and empty a stage, full a partial tile
  static constexpr int N_BARS = 1 + 2 * STAGES + SLOTS * kConsumers;
  static constexpr int SMEM = 1024 + TILE_BYTES + 8 * N_BARS;  // + alignment
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;  // wgmma swizzle code
};

// The wide kernel's tiles (256 < D <= 320): O's GW columns a
// CTA, S over D chunks of 64 columns (128-byte rows, 128-byte swizzle)
// through a ring of kA (Q chunk, K chunk) stages, V tiles of BK x GW
// through a ring of kV.
template <int GW_>
struct WideCfg {
  static_assert(GW_ % 32 == 0 && GW_ >= 160 && GW_ <= kMaxGroup,
                "GW: a multiple of 32 in 160..224");
  static constexpr int GW = GW_;
  static constexpr int BK = GW <= 160 ? 64 : 32;       // as Cfg<GW>
  static constexpr int SC = 64;                        // columns of a chunk
  static constexpr int SW_V = GW % 64 == 0 ? 128 : 64; // bytes per V chunk row
  static constexpr int COLS_V = SW_V / 2;
  static constexpr int V_CHUNKS = GW / COLS_V;
  static constexpr int QC_BYTES = kRows * SC * 2;      // 16 KB
  static constexpr int KC_BYTES = BK * SC * 2;
  static constexpr int A_BYTES = QC_BYTES + KC_BYTES;  // a stage of the chunk ring
  static constexpr int V_BYTES = BK * GW * 2;          // a stage of the V ring
  static constexpr int kA = 4;
  static constexpr int kV = 2;
  static constexpr int TILE_BYTES = kA * A_BYTES + kV * V_BYTES;
  static constexpr int N_BARS = 2 * (kA + kV);
  static constexpr int SMEM = 1024 + TILE_BYTES + 8 * N_BARS;  // + alignment
  static constexpr uint64_t LAYOUT_V = SW_V == 128 ? 1 : 2;
};

// O's column groups above 256: ng groups of gw columns (gw a multiple of 32
// in 160..224), as ops.column_groups computes them
inline void column_groups(int D, int* ng, int* gw) {
  *ng = (D + kMaxGroup - 1) / kMaxGroup;
  *gw = ((D + *ng - 1) / *ng + 31) / 32 * 32;
}

// ---- PTX wrappers ---------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
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

// Wait until the phase of parity `parity` has completed; trap after ~2^31
// cycles rather than hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1LL << 31)) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ---- the cluster's wrappers: barrier, distributed shared memory, remote
// mbarrier arrivals
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the address of the same shared-memory byte in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr) : "memory");
  return v;
}

// one arrival on the mbarrier at `addr`, a shared::cluster address (this
// CTA's or a peer's)
__device__ __forceinline__ void mbar_arrive_remote(uint32_t addr) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(addr) : "memory");
}

// the 128 threads of a warpgroup meet at named barrier `id` (1, 2, ...)
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// mbar_wait with acquire at cluster scope: what the peers wrote before they
// arrived is visible after it
__device__ __forceinline__ bool mbar_try_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait_cluster(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait_cluster(bar, parity)) {
    if (clock64() - t0 > (1LL << 31)) __trap();
  }
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle code in bits 62-63.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// all but the newest committed group complete
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// Pin accumulator registers at this point of the program: the compiler may
// not move their reads or writes across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to E (round to nearest even), lo in the low half
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsHalf<E>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// ---- wgmma m64n{32,64,...,256}k16, E x E -> fp32 (TY: "bf16" or "f16") ----
// d[0..16) (+)= A(desc) * B(desc), m64n32k16, B K-major
#define WGMMA_SS_N32(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "l"(a), "l"(b), "r"(scale_d))
template <typename E>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (kIsHalf<E>) WGMMA_SS_N32("f16");
  else WGMMA_SS_N32("bf16");
}

// d[0..32) (+)= A(desc) * B(desc), m64n64k16, B K-major
#define WGMMA_SS_N64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "l"(a), "l"(b), "r"(scale_d))
template <typename E>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (kIsHalf<E>) WGMMA_SS_N64("f16");
  else WGMMA_SS_N64("bf16");
}

// d[0..64) (+)= A(desc) * B(desc), m64n128k16, B K-major
#define WGMMA_SS_N128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "l"(a), "l"(b), "r"(scale_d))
template <typename E>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (kIsHalf<E>) WGMMA_SS_N128("f16");
  else WGMMA_SS_N128("bf16");
}

// d[0..16) += A(registers) * B(desc), m64n32k16, B MN-major (transposed)
#define WGMMA_RS_N32(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
template <typename E>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kIsHalf<E>) WGMMA_RS_N32("f16");
  else WGMMA_RS_N32("bf16");
}

// d[0..32) += A(registers) * B(desc), m64n64k16, B MN-major (transposed)
#define WGMMA_RS_N64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
template <typename E>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kIsHalf<E>) WGMMA_RS_N64("f16");
  else WGMMA_RS_N64("bf16");
}

// d[0..48) += A(registers) * B(desc), m64n96k16, B MN-major (transposed)
#define WGMMA_RS_N96(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n96k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
template <typename E>
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kIsHalf<E>) WGMMA_RS_N96("f16");
  else WGMMA_RS_N96("bf16");
}

// d[0..64) += A(registers) * B(desc), m64n128k16, B MN-major (transposed)
#define WGMMA_RS_N128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
template <typename E>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kIsHalf<E>) WGMMA_RS_N128("f16");
  else WGMMA_RS_N128("bf16");
}

// d[0..80) += A(registers) * B(desc), m64n160k16, B MN-major (transposed)
#define WGMMA_RS_N160(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n160k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
template <typename E>
__device__ __forceinline__ void wgmma_rs_n160(float (&d)[80], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kIsHalf<E>) WGMMA_RS_N160("f16");
  else WGMMA_RS_N160("bf16");
}

// d[0..96) += A(registers) * B(desc), m64n192k16, B MN-major (transposed)
#define WGMMA_RS_N192(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n192k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
template <typename E>
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kIsHalf<E>) WGMMA_RS_N192("f16");
  else WGMMA_RS_N192("bf16");
}

// d[0..112) += A(registers) * B(desc), m64n224k16, B MN-major (transposed)
#define WGMMA_RS_N224(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %117, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n224k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111}, {%112, %113, %114, %115}, %116, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
template <typename E>
__device__ __forceinline__ void wgmma_rs_n224(float (&d)[112], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kIsHalf<E>) WGMMA_RS_N224("f16");
  else WGMMA_RS_N224("bf16");
}

// d[0..128) += A(registers) * B(desc), m64n256k16, B MN-major (transposed)
#define WGMMA_RS_N256(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n" \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1))
template <typename E>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kIsHalf<E>) WGMMA_RS_N256("f16");
  else WGMMA_RS_N256("bf16");
}


template <typename E, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (N == 32) wgmma_ss_n32<E>(d, a, b, scale_d);
  else if constexpr (N == 64) wgmma_ss_n64<E>(d, a, b, scale_d);
  else wgmma_ss_n128<E>(d, a, b, scale_d);
}
template <typename E, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 32) wgmma_rs_n32<E>(d, a, b);
  else if constexpr (N == 64) wgmma_rs_n64<E>(d, a, b);
  else if constexpr (N == 96) wgmma_rs_n96<E>(d, a, b);
  else if constexpr (N == 128) wgmma_rs_n128<E>(d, a, b);
  else if constexpr (N == 160) wgmma_rs_n160<E>(d, a, b);
  else if constexpr (N == 192) wgmma_rs_n192<E>(d, a, b);
  else if constexpr (N == 224) wgmma_rs_n224<E>(d, a, b);
  else wgmma_rs_n256<E>(d, a, b);
}

// ---- the wide kernel's softmax, epilogue and key range ----------------------
// The same arithmetic as the narrow kernel's inline code below, which keeps
// its own copy: through these functions its DP = 64 instance ran 4.7-5.2%
// slower (scripts/kernel_ab.py, serve and train shapes, every turn, on an
// NVIDIA H100 80GB HBM3 at 700 W).
//
// The online softmax of one key tile.
// sc: the tile's raw scores (rows row0: sc[4j], sc[4j+1]; row1: sc[4j+2],
// sc[4j+3]; key k0 + 8 j + col (+1)); scaled, masked, turned into P in
// place; m, l and acc (O, NA accumulators) rescaled.
template <int BK, int NA>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], float (&acc)[NA],
                                             float& m0, float& m1, float& l0,
                                             float& l1, bool need_mask, int k0,
                                             int row0, int row1, int col, int Skv,
                                             int causal, int window, float scale) {
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      float x = sc[4 * j + v] * scale;
      if (need_mask) {
        const int row = v < 2 ? row0 : row1;
        const int key = k0 + 8 * j + col + (v & 1);
        const bool vis = (!causal || key <= row) &&
                         (window <= 0 || row - key < window);
        x = key >= Skv ? -INFINITY : vis ? x : kNegInf;
      }
      sc[4 * j + v] = x;
    }
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float corr0 = ex2((m0 - mx0) * kLog2e);
  const float corr1 = ex2((m1 - mx1) * kLog2e);
  m0 = mx0;
  m1 = mx1;
  l0 *= corr0;
  l1 *= corr1;
#pragma unroll
  for (int j = 0; j < NA / 4; ++j) {
    acc[4 * j] *= corr0;
    acc[4 * j + 1] *= corr0;
    acc[4 * j + 2] *= corr1;
    acc[4 * j + 3] *= corr1;
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    sc[4 * j] = ex2((sc[4 * j] - m0) * kLog2e);
    sc[4 * j + 1] = ex2((sc[4 * j + 1] - m0) * kLog2e);
    sc[4 * j + 2] = ex2((sc[4 * j + 2] - m1) * kLog2e);
    sc[4 * j + 3] = ex2((sc[4 * j + 3] - m1) * kLog2e);
    l0 += sc[4 * j] + sc[4 * j + 1];
    l1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
}

// The epilogue: full row sums, divide in fp32, store rows <
// Sq and the real columns c0 + 8 j + col (+1) < D of o (ob: o at this (b,
// h) and column c0; D is a multiple of 8), and (with lse) the row's
// log-sum-exp. m is the scaled scores' running max in natural-log units
// (the exponentials take (x - m) log2 e); the four threads of a row hold it.
template <typename E, int NA>
__device__ __forceinline__ void store_rows(const float (&acc)[NA], float m0,
                                           float m1, float l0, float l1,
                                           E* ob, float* lb, int row0, int row1,
                                           int col, int lane, int Sq,
                                           long long row_stride, int width) {
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  if (row0 < Sq) {
#pragma unroll
    for (int j = 0; j < NA / 4; ++j)
      if (8 * j < width)
        *reinterpret_cast<uint32_t*>(ob + row0 * row_stride + 8 * j + col) =
            pack2<E>(acc[4 * j] / d0, acc[4 * j + 1] / d0);
  }
  if (row1 < Sq) {
#pragma unroll
    for (int j = 0; j < NA / 4; ++j)
      if (8 * j < width)
        *reinterpret_cast<uint32_t*>(ob + row1 * row_stride + 8 * j + col) =
            pack2<E>(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
  }
  if (lb != nullptr && lane % 4 == 0) {
    if (row0 < Sq) lb[row0] = m0 + logf(d0);
    if (row1 < Sq) lb[row1] = m1 + logf(d1);
  }
}

// the key tiles [k_begin, k_end) that hold a visible key for some row of the
// query tile at q0 (all of them when some row sees no key: orphans)
struct KeyRange {
  int k_begin, n_tiles;
  bool orphans;
};

__device__ __forceinline__ KeyRange key_range(int q0, int Sq, int Skv, int causal,
                                              int window, int BK) {
  const int q_last = min(q0 + kRows, Sq) - 1;
  KeyRange r;
  r.orphans = window > 0 && q_last >= Skv - 1 + window;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;
  int k_begin = window > 0 && !r.orphans ? max(0, q0 - window + 1) : 0;
  r.k_begin = (k_begin / BK) * BK;
  r.n_tiles = k_end > r.k_begin ? (k_end - r.k_begin + BK - 1) / BK : 0;
  return r;
}

// ---- the kernel, head dims up to 256 -----------------------------------------
// EXACT: D == DP, a compile-time width (the instance a multiple of 32 runs;
// its code is that of a kernel compiled for D)
template <typename E, int DP_, bool EXACT>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               E* __restrict__ o, float* __restrict__ lse, int Sq,
               int Skv, int H, int KV, int D, int causal, int window,
               float scale) {
  if constexpr (EXACT) D = DP_;
  using C = Cfg<DP_>;
  constexpr int BK = C::BK, SW = C::SW, COLS = C::COLS, DP = C::DP;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms: 1024 B
  const uint32_t q_s = base;
  const uint32_t k_s = base + C::Q_BYTES;                       // + s * KV_BYTES
  const uint32_t v_s = k_s + kStages * C::KV_BYTES;             // + s * KV_BYTES
  const uint32_t bars = base + C::TILE_BYTES;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + kStages + s); };

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // late tiles first

  // key tiles that hold a visible key for some row of this query tile
  // (all of them when some row sees no key)
  const int q_last = min(q0 + kRows, Sq) - 1;
  const bool orphans = window > 0 && q_last >= Skv - 1 + window;
  const int k_end = causal ? min(Skv, q_last + 1) : Skv;
  int k_begin = window > 0 && !orphans ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * kConsumers);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kProducer) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      for (int c = 0; c < C::CHUNKS; ++c)
        tma_load_4d(q_s + c * kRows * SW, &tm_q, q_full, c * COLS, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        mbar_wait(empty(s), ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * C::KV_BYTES);
        const int k0 = k_begin + t * BK;
        for (int c = 0; c < C::CHUNKS; ++c) {
          tma_load_4d(k_s + s * C::KV_BYTES + c * BK * SW, &tm_k, full(s),
                      c * COLS, kvh, k0, b);
          tma_load_4d(v_s + s * C::KV_BYTES + c * BK * SW, &tm_v, full(s),
                      c * COLS, kvh, k0, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: query rows q0 + 64 wg .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int r_lo = q0 + wg * kRowsWG;                 // the warpgroup's rows
  const int r_hi = r_lo + kRowsWG - 1;
  const int row0 = r_lo + warp * 16 + lane / 4;       // this thread's rows
  const int row1 = row0 + 8;
  const int col = 2 * (lane % 4);                     // + 8 j (+ 1)
  const bool dead = r_lo >= Sq;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int k0 = k_begin + t * BK;
    mbar_wait(full(s), (t / kStages) & 1);
    const bool skip = dead || (!orphans && ((causal && k0 > r_hi) ||
                      (window > 0 && k0 + BK - 1 < r_lo - window + 1)));
    if (!skip) {
      // S = Q K^T: both operands K-major in shared memory
      float sc[BK / 2];
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int c = (kk * 16) / COLS, off = (kk * 16) % COLS * 2;
        const uint64_t da = make_desc(q_s + c * kRows * SW + wg * kRowsWG * SW + off,
                                      16, 8 * SW, C::LAYOUT);
        const uint64_t db = make_desc(k_s + s * C::KV_BYTES + c * BK * SW + off,
                                      16, 8 * SW, C::LAYOUT);
        wgmma_ss<E, BK>(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // scale, mask, online softmax (rows row0: sc[4j], sc[4j+1];
      // row1: sc[4j+2], sc[4j+3]; key k0 + 8 j + col (+1))
      const bool need_mask = k0 + BK > Skv || (causal && k0 + BK - 1 > r_lo) ||
                             (window > 0 && r_hi - k0 >= window);
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          float x = sc[4 * j + v] * scale;
          if (need_mask) {
            const int row = v < 2 ? row0 : row1;
            const int key = k0 + 8 * j + col + (v & 1);
            const bool vis = (!causal || key <= row) &&
                             (window <= 0 || row - key < window);
            x = key >= Skv ? -INFINITY : vis ? x : kNegInf;
          }
          sc[4 * j + v] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float corr0 = ex2((m0 - mx0) * kLog2e);
      const float corr1 = ex2((m1 - mx1) * kLog2e);
      m0 = mx0;
      m1 = mx1;
      l0 *= corr0;
      l1 *= corr1;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        acc[4 * j] *= corr0;
        acc[4 * j + 1] *= corr0;
        acc[4 * j + 2] *= corr1;
        acc[4 * j + 3] *= corr1;
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        sc[4 * j] = ex2((sc[4 * j] - m0) * kLog2e);
        sc[4 * j + 1] = ex2((sc[4 * j + 1] - m0) * kLog2e);
        sc[4 * j + 2] = ex2((sc[4 * j + 2] - m1) * kLog2e);
        sc[4 * j + 3] = ex2((sc[4 * j + 3] - m1) * kLog2e);
        l0 += sc[4 * j] + sc[4 * j + 1];
        l1 += sc[4 * j + 2] + sc[4 * j + 3];
      }

      // O += P V: P (E) from registers, V through the transposed
      // (MN-major) descriptor, 16 keys a step
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t pa[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[r] = pack2<E>(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
        const uint64_t dv = make_desc(v_s + s * C::KV_BYTES + kk * 16 * SW,
                                      BK * SW, 8 * SW, C::LAYOUT);
        wgmma_rs<E, DP>(acc, pa, dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));   // this warp is done with stage s
  }

  // epilogue: full row sums, divide in fp32, store rows < Sq and the D
  // real columns (8 j + col + 1 < D iff 8 j < D: D is a multiple of 8)
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const long long row_stride = static_cast<long long>(H) * D;
  E* ob = o + (static_cast<long long>(b) * Sq * H + h) * D;
  if (row0 < Sq) {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      if (8 * j < D)
        *reinterpret_cast<uint32_t*>(ob + row0 * row_stride + 8 * j + col) =
            pack2<E>(acc[4 * j] / d0, acc[4 * j + 1] / d0);
  }
  if (row1 < Sq) {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      if (8 * j < D)
        *reinterpret_cast<uint32_t*>(ob + row1 * row_stride + 8 * j + col) =
            pack2<E>(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
  }
  // m is the scaled scores' running max in natural-log units (the
  // exponentials take (x - m) log2 e); the four threads of a row hold it
  if (lse != nullptr && lane % 4 == 0) {
    float* lb = lse + (static_cast<long long>(b) * H + h) * Sq;
    if (row0 < Sq) lb[row0] = m0 + logf(d0);
    if (row1 < Sq) lb[row1] = m1 + logf(d1);
  }
}

// ---- the kernel, head dims 257..1,792: column group blockIdx.z of O, the
// NG groups of a query tile one thread-block cluster that computes S once --
template <typename E, int GW_>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_cluster(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       E* __restrict__ o, float* __restrict__ lse, int Sq,
                       int Skv, int H, int KV, int D, int causal, int window,
                       float scale) {
  using C = ClusterCfg<GW_>;
  constexpr int BK = C::BK, SW = C::SW, COLS = C::COLS, GW = C::GW;
  constexpr int STAGES = C::STAGES, SLOTS = C::SLOTS;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms: 1024 B
  uint8_t* const sm = smem_raw + (base - raw);
  const uint32_t q_s = base;
  const uint32_t k_s = base + C::Q_BYTES;                       // + s * KV_BYTES
  const uint32_t v_s = base + C::V_OFF;                         // + s * KV_BYTES
  const uint32_t bars = base + C::TILE_BYTES;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  // partial tile `slot` of consumer warpgroup w: its offset and barrier
  auto x_buf = [&](int w, int slot) {
    return C::X_OFF + (slot * kConsumers + w) * C::X_BYTES;
  };
  auto xfull = [&](int w, int slot) {
    return bars + 8u * (1 + 2 * STAGES + slot * kConsumers + w);
  };

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // late tiles first
  // the cluster spans grid z: CTA rank g of the cluster holds group g
  const int g = blockIdx.z, ng = gridDim.z;
  const int c0 = g * GW;                                 // the group's first column
  // chunks that hold a column < D: the ones loaded
  const int n_ld = min(C::CHUNKS, (D - c0 + COLS - 1) / COLS);
  const KeyRange kr = key_range(q0, Sq, Skv, causal, window, BK);
  const int k_begin = kr.k_begin, n_tiles = kr.n_tiles;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * kConsumers);   // one arrival per consumer warp
    }
    for (int slot = 0; slot < SLOTS; ++slot)
      for (int w = 0; w < kConsumers; ++w)
        mbar_init(xfull(w, slot), ng);        // one arrival per CTA
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (n_ld < C::CHUNKS) {
    // Q's and the K stages' chunks past D are never loaded: zeros for QK^T
    auto zero = [&](int off, int bytes) {
      for (int i = threadIdx.x; i < bytes / 16; i += kThreads)
        reinterpret_cast<uint4*>(sm + off)[i] = make_uint4(0u, 0u, 0u, 0u);
    };
    zero(n_ld * kRows * SW, (C::CHUNKS - n_ld) * kRows * SW);
    for (int s = 0; s < STAGES; ++s)
      zero(C::Q_BYTES + s * C::KV_BYTES + n_ld * BK * SW, (C::CHUNKS - n_ld) * BK * SW);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  cluster_sync();   // every CTA's barriers initialised before any peer arrives

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kProducer) {
      mbar_expect_tx(q_full, n_ld * kRows * SW);
      for (int c = 0; c < n_ld; ++c)
        tma_load_4d(q_s + c * kRows * SW, &tm_q, q_full, c0 + c * COLS, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(empty(s), ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * n_ld * BK * SW);
        const int k0 = k_begin + t * BK;
        for (int c = 0; c < n_ld; ++c) {
          tma_load_4d(k_s + s * C::KV_BYTES + c * BK * SW, &tm_k, full(s),
                      c0 + c * COLS, kvh, k0, b);
          tma_load_4d(v_s + s * C::KV_BYTES + c * BK * SW, &tm_v, full(s),
                      c0 + c * COLS, kvh, k0, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroup wg: query rows q0 + 64 wg .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int r_lo = q0 + wg * kRowsWG;                 // the warpgroup's rows
    const int r_hi = r_lo + kRowsWG - 1;
    const int row0 = r_lo + warp * 16 + lane / 4;       // this thread's rows
    const int row1 = row0 + 8;
    const int col = 2 * (lane % 4);                     // + 8 j (+ 1)
    const bool dead = r_lo >= Sq;

    float acc[GW / 2];
#pragma unroll
    for (int i = 0; i < GW / 2; ++i) acc[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    // exchanges published; the pending one (published, its S not yet
    // taken): its index, stage and first key (ps < 0: none)
    int xc = 0, px = 0, ps = -1, pk0 = 0;

    mbar_wait(q_full, 0);
    // Tile t's partial is published, then tile t - 1's S is taken: the
    // peers' partials of t - 1 have been on their way while t's QK^T ran.
    for (int t = 0; t <= n_tiles; ++t) {
      bool published = false;
      const int s = t % STAGES;
      const int k0 = k_begin + t * BK;
      if (t < n_tiles) {
        mbar_wait(full(s), (t / STAGES) & 1);
        const bool skip = dead || (!kr.orphans && ((causal && k0 > r_hi) ||
                          (window > 0 && k0 + BK - 1 < r_lo - window + 1)));
        if (!skip) {
          // this group's partial S = Q_g K_g^T over its GW columns
          float sc[BK / 2];
          fence_regs(sc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < GW / 16; ++kk) {
            const int c = (kk * 16) / COLS, off = (kk * 16) % COLS * 2;
            const uint64_t da = make_desc(q_s + c * kRows * SW + wg * kRowsWG * SW + off,
                                          16, 8 * SW, C::LAYOUT);
            const uint64_t db = make_desc(k_s + s * C::KV_BYTES + c * BK * SW + off,
                                          16, 8 * SW, C::LAYOUT);
            wgmma_ss<E, BK>(sc, da, db, kk > 0);
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(sc);
          // to partial tile xc % SLOTS, in the registers' own order (float4 j
          // of thread tid at 16 (128 j + tid)); the tile it held four
          // exchanges ago has been read by every peer, which has published
          // exchange xc - 2 since; then one arrival on each CTA's barrier
          const int slot = xc % SLOTS;
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
            *reinterpret_cast<float4*>(sm + x_buf(wg, slot) + 16 * tid + 2048 * j) =
                make_float4(sc[4 * j], sc[4 * j + 1], sc[4 * j + 2], sc[4 * j + 3]);
          named_sync(1 + wg);
          if (tid == 0) {
            for (int r = 0; r < ng; ++r) mbar_arrive_remote(peer_addr(xfull(wg, slot), r));
          }
          published = true;
        }
      }
      if (ps >= 0) {
        // the pending tile's S: the partials of groups 0, 1, ..., ng - 1
        // added in that order, each group's four float4 loads in flight
        const int slot = px % SLOTS;
        mbar_wait_cluster(xfull(wg, slot), (px / SLOTS) & 1);
        const uint32_t xa = base + x_buf(wg, slot) + 16 * tid;
        float sp[BK / 2];
        for (int r = 0; r < ng; ++r) {
          const uint32_t pa = peer_addr(xa, r);
          float4 v[BK / 8];
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) v[j] = ld_cluster_f4(pa + 2048 * j);
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
            if (r == 0) {
              sp[4 * j] = v[j].x;
              sp[4 * j + 1] = v[j].y;
              sp[4 * j + 2] = v[j].z;
              sp[4 * j + 3] = v[j].w;
            } else {
              sp[4 * j] += v[j].x;
              sp[4 * j + 1] += v[j].y;
              sp[4 * j + 2] += v[j].z;
              sp[4 * j + 3] += v[j].w;
            }
          }
        }
        const bool need_mask = pk0 + BK > Skv || (causal && pk0 + BK - 1 > r_lo) ||
                               (window > 0 && r_hi - pk0 >= window);
        softmax_tile<BK>(sp, acc, m0, m1, l0, l1, need_mask, pk0, row0, row1, col,
                         Skv, causal, window, scale);

        // O[:, c0 .. c0 + GW) += P V_g
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t pa[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            pa[r] = pack2<E>(sp[8 * kk + 2 * r], sp[8 * kk + 2 * r + 1]);
          const uint64_t dv = make_desc(v_s + ps * C::KV_BYTES + kk * 16 * SW,
                                        BK * SW, 8 * SW, C::LAYOUT);
          wgmma_rs<E, GW>(acc, pa, dv);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(ps));   // this warp is done with stage ps
        ps = -1;
      }
      if (published) {
        px = xc++;
        ps = s;
        pk0 = k0;
      } else if (t < n_tiles) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty(s));    // a skipped tile's stage
      }
    }

    const long long row_stride = static_cast<long long>(H) * D;
    store_rows<E>(acc, m0, m1, l0, l1,
                  o + (static_cast<long long>(b) * Sq * H + h) * D + c0,
                  lse == nullptr || g != 0
                      ? nullptr : lse + (static_cast<long long>(b) * H + h) * Sq,
                  row0, row1, col, lane, Sq, row_stride, D - c0);
  }
  // no CTA leaves while a peer may still read its partials or arrive on its
  // barriers
  __syncwarp();
  cluster_sync();
}

// ---- the kernel, head dims 257..320: column group blockIdx.z of O ----------
template <typename E, int GW_>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_wide(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    E* __restrict__ o, float* __restrict__ lse, int Sq,
                    int Skv, int H, int KV, int D, int causal, int window,
                    float scale) {
  using C = WideCfg<GW_>;
  constexpr int BK = C::BK, GW = C::GW, SC = C::SC, SW_V = C::SW_V;
  constexpr int kA = C::kA, kV = C::kV;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms: 1024 B
  const uint32_t a_s = base;                      // + s * A_BYTES: Q chunk, K chunk
  const uint32_t v_s = base + kA * C::A_BYTES;    // + s * V_BYTES
  const uint32_t bars = base + C::TILE_BYTES;
  auto full_a = [&](int s) { return bars + 8u * s; };
  auto empty_a = [&](int s) { return bars + 8u * (kA + s); };
  auto full_v = [&](int s) { return bars + 8u * (2 * kA + s); };
  auto empty_v = [&](int s) { return bars + 8u * (2 * kA + kV + s); };

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // late tiles first
  const int c0 = blockIdx.z * GW;                        // the group's first column
  const int n_chunks = (D + SC - 1) / SC;
  // V chunks that hold a column < D (those wholly past D stay unloaded:
  // they reach only O columns that are not stored)
  const int v_chunks = min(C::V_CHUNKS, (D - c0 + C::COLS_V - 1) / C::COLS_V);
  const KeyRange kr = key_range(q0, Sq, Skv, causal, window, BK);
  const int k_begin = kr.k_begin, n_tiles = kr.n_tiles;
  const bool orphans = kr.orphans;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kA; ++s) {
      mbar_init(full_a(s), 1);
      mbar_init(empty_a(s), 4 * kConsumers);   // one arrival per consumer warp
    }
    for (int s = 0; s < kV; ++s) {
      mbar_init(full_v(s), 1);
      mbar_init(empty_v(s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer warpgroup: one thread issues every load, in the order the
    // consumers read them: a tile's D chunks of (Q, K), then its V tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kProducer) {
      for (int t = 0; t < n_tiles; ++t) {
        const int k0 = k_begin + t * BK;
        for (int c = 0; c < n_chunks; ++c) {
          const int a = t * n_chunks + c, s = a % kA;
          mbar_wait(empty_a(s), ((a / kA) & 1) ^ 1);
          mbar_expect_tx(full_a(s), C::A_BYTES);
          tma_load_4d(a_s + s * C::A_BYTES, &tm_q, full_a(s), c * SC, h, q0, b);
          tma_load_4d(a_s + s * C::A_BYTES + C::QC_BYTES, &tm_k, full_a(s),
                      c * SC, kvh, k0, b);
        }
        const int sv = t % kV;
        mbar_wait(empty_v(sv), ((t / kV) & 1) ^ 1);
        mbar_expect_tx(full_v(sv), v_chunks * BK * SW_V);
        for (int vc = 0; vc < v_chunks; ++vc)
          tma_load_4d(v_s + sv * C::V_BYTES + vc * BK * SW_V, &tm_v, full_v(sv),
                      c0 + vc * C::COLS_V, kvh, k0, b);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: query rows q0 + 64 wg .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int r_lo = q0 + wg * kRowsWG;                 // the warpgroup's rows
  const int r_hi = r_lo + kRowsWG - 1;
  const int row0 = r_lo + warp * 16 + lane / 4;       // this thread's rows
  const int row1 = row0 + 8;
  const int col = 2 * (lane % 4);                     // + 8 j (+ 1)
  const bool dead = r_lo >= Sq;

  float acc[GW / 2];
#pragma unroll
  for (int i = 0; i < GW / 2; ++i) acc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * BK;
    const bool skip = dead || (!orphans && ((causal && k0 > r_hi) ||
                      (window > 0 && k0 + BK - 1 < r_lo - window + 1)));
    // S = Q K^T over the D chunks in order, chained on one accumulator; a
    // chunk's stage is released once the products that read it completed
    float sc[BK / 2];
    if (!skip) {
      fence_regs(sc);
      wgmma_fence();
    }
    for (int c = 0; c < n_chunks; ++c) {
      const int a = t * n_chunks + c, s = a % kA;
      mbar_wait(full_a(s), (a / kA) & 1);
      if (skip) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_a(s));
        continue;
      }
      const uint32_t qa = a_s + s * C::A_BYTES + wg * kRowsWG * 128;
      const uint32_t ka = a_s + s * C::A_BYTES + C::QC_BYTES;
#pragma unroll
      for (int kk = 0; kk < SC / 16; ++kk) {
        const uint64_t da = make_desc(qa + kk * 32, 16, 8 * 128, 1);
        const uint64_t db = make_desc(ka + kk * 32, 16, 8 * 128, 1);
        wgmma_ss<E, BK>(sc, da, db, c > 0 || kk > 0);
      }
      wgmma_commit();
      if (c > 0) {
        wgmma_wait_one();              // chunk c - 1's products are done
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_a((a - 1) % kA));
      }
    }
    if (!skip) {
      wgmma_wait_all();
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_a((t * n_chunks + n_chunks - 1) % kA));

      const bool need_mask = k0 + BK > Skv || (causal && k0 + BK - 1 > r_lo) ||
                             (window > 0 && r_hi - k0 >= window);
      softmax_tile<BK>(sc, acc, m0, m1, l0, l1, need_mask, k0, row0, row1, col,
                       Skv, causal, window, scale);
    }

    // O[:, c0 .. c0 + GW) += P V_group
    const int sv = t % kV;
    mbar_wait(full_v(sv), (t / kV) & 1);
    if (!skip) {
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t pa[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[r] = pack2<E>(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
        const uint64_t dv = make_desc(v_s + sv * C::V_BYTES + kk * 16 * SW_V,
                                      BK * SW_V, 8 * SW_V, C::LAYOUT_V);
        wgmma_rs<E, GW>(acc, pa, dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_v(sv));   // this warp is done with V stage sv
  }

  const long long row_stride = static_cast<long long>(H) * D;
  store_rows<E>(acc, m0, m1, l0, l1,
                o + (static_cast<long long>(b) * Sq * H + h) * D + c0,
                lse == nullptr || blockIdx.z != 0
                    ? nullptr : lse + (static_cast<long long>(b) * H + h) * Sq,
                row0, row1, col, lane, Sq, row_stride, D - c0);
}

// ---- host side ------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime's entry-point
// query (no -lcuda on the link line).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over (D, heads, S, B) of a contiguous [B, S, heads, D] tensor of
// E, box (cols, 1, rows, 1), swizzled by the chunk's row bytes. A box past
// column D (the last chunk when D < DP) is zero-filled there.
template <typename E>
cudaError_t make_map(CUtensorMap* map, const void* ptr, int D, int heads,
                     int S, int B, int cols, int rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 2;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = cols * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                                : CU_TENSOR_MAP_SWIZZLE_64B;
  CUresult r = enc(map, kIsHalf<E> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                   4, const_cast<void*>(ptr), dims, strides, box, elem,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename E, int DP, bool EXACT>
cudaError_t launch_instance(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int Sq, int Skv, int H,
                            int KV, int D, int causal, int window, float scale,
                            cudaStream_t stream) {
  using C = Cfg<DP>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_sm90<E, DP, EXACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_map<E>(&mq, q, D, H, Sq, B, C::COLS, kRows);
  if (err == cudaSuccess) err = make_map<E>(&mk, k, D, KV, Skv, B, C::COLS, C::BK);
  if (err == cudaSuccess) err = make_map<E>(&mv, v, D, KV, Skv, B, C::COLS, C::BK);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + kRows - 1) / kRows);
  flash_fwd_sm90<E, DP, EXACT><<<grid, kThreads, C::SMEM, stream>>>(
      mq, mk, mv, static_cast<E*>(o), static_cast<float*>(lse), Sq,
      Skv, H, KV, D, causal, window, scale);
  return cudaGetLastError();
}

template <typename E, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int Sq, int Skv, int H, int KV, int D,
                   int causal, int window, float scale, cudaStream_t stream) {
  return D == DP
      ? launch_instance<E, DP, true>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, scale, stream)
      : launch_instance<E, DP, false>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, scale, stream);
}

// registers, local bytes, static and dynamic shared bytes, the cluster size
// (1: none) and the clusters the card holds at once (0: no cluster)
inline void fill_attrs(const cudaFuncAttributes& a, int smem, int* out) {
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = smem;
  out[4] = 1;
  out[5] = 0;
}

template <typename E, int DP>
cudaError_t attrs(int D, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = D == DP
      ? cudaFuncGetAttributes(&a, flash_fwd_sm90<E, DP, true>)
      : cudaFuncGetAttributes(&a, flash_fwd_sm90<E, DP, false>);
  if (err == cudaSuccess) fill_attrs(a, Cfg<DP>::SMEM, out);
  return err;
}

// The C entries of one type: head dims 8..256 (a multiple of 8) on the
// instances of the including unit, 257..1,792 on the wide unit's
template <typename E>
int entry_attrs(int D, int* out) {
  if (D > kMaxWidth) return flash_sm90_wide_attrs(kIsHalf<E> ? 1 : 0, D, out);
  switch ((D + 31) / 32 * 32) {
    case 32: return attrs<E, 32>(D, out);
    case 64: return attrs<E, 64>(D, out);
    case 96: return attrs<E, 96>(D, out);
    case 128: return attrs<E, 128>(D, out);
    case 160: return attrs<E, 160>(D, out);
    case 192: return attrs<E, 192>(D, out);
    case 224: return attrs<E, 224>(D, out);
    case 256: return attrs<E, 256>(D, out);
    default: return cudaErrorInvalidValue;
  }
}

template <typename E>
int entry_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int B,
        int Sq, int Skv, int H, int KV, int D, int causal, int window,
        float scale, void* stream) {
  if (D < 8 || D % 8) return cudaErrorInvalidValue;
  if (D > kMaxWidth)
    return flash_sm90_wide_fwd(kIsHalf<E> ? 1 : 0, q, k, v, o, lse, B, Sq, Skv,
                               H, KV, D, causal, window, scale, stream);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 31) / 32 * 32) {
    case 32: return launch<E, 32>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, scale, s);
    case 64: return launch<E, 64>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, scale, s);
    case 96: return launch<E, 96>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, scale, s);
    case 128: return launch<E, 128>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, scale, s);
    case 160: return launch<E, 160>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, scale, s);
    case 192: return launch<E, 192>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, scale, s);
    case 224: return launch<E, 224>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, scale, s);
    case 256: return launch<E, 256>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
