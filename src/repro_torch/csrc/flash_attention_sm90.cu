// Causal / sliding-window GQA flash attention (forward) in bf16 on Hopper's
// tensor cores (sm_90a): wgmma fed by TMA through an mbarrier ring, with two
// consumer warpgroups and a producer warpgroup whose one thread loads.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// _flash_kernel (entry flash_attention_pallas) for bf16 inputs; fp32 keeps
// the SIMT kernel of flash_attention.cu (wgmma takes no fp32 operands, and
// TF32 would not hold fp32's 1e-5). In the port it runs on the flash branch
// of models/attention.attention_forward (sequences of 2048 or more), once
// per layer of a bf16 prefill.
//
// q [B, Sq, H, D], k and v [B, Skv, KV, D], bf16, contiguous, read in place
// (no transpose copy); o [B, Sq, H, D] bf16; lse, when not null, [B, H, Sq]
// fp32 (the JAX package's [B, KV, G, Sq], h = kv G + g): the log-sum-exp of
// each row's scaled scores, m + log(max(l, 1e-30)), from the fp32 running
// max and sum (not from the bf16-rounded P), which the training path's
// backward (kernels/flash_attention/ref.py: flash_bwd_ref) reads. A null
// lse writes nothing, so the serve path does the work it did without it.
// Query head h reads KV head h / (H / KV). What it computes is the Pallas kernel's function:
//   S = Q K^T accumulated in fp32, then multiplied by 1/sqrt(D) in fp32;
//   a masked score (key > row when causal, row - key >= window) is -1e30,
//   not -inf; m, l and O are fp32 (online softmax, one rescale per tile of
//   keys); o = O / max(l, 1e-30), rounded to bf16.
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
// are rounded to bf16 before O += P V (as SDPA and FA2/FA3 do; l sums the
// fp32 P). chip_smoke.py holds it to the plain version (fp32 P) at 2e-2.
//
// What bounds it on an H100 SXM at the serve path's shapes (B = 4, H = 32,
// KV = 4, S = 2048, D = 64, causal): 2 * 2 * B * H * D * S(S+1)/2 = 6.87e10
// operations, 0.069 ms at 989 TFLOP/s of bf16 tensor cores, against 75.5 MB
// of q, k, v and o, 0.023 ms at 3.35 TB/s: operations. So the products run
// on the tensor cores, and the design keeps them fed:
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
//     tail of the wave.
// Head dims. The kernel is compiled for a computed width DP = D rounded up
// to 32 (32, 64, ..., 256) and takes D, a multiple of 8 (the TMA's 16-byte
// row stride), at run time (each DP also has an EXACT instance for D ==
// DP, whose D is a compile-time constant); the wrapper zero-pads q, k and v of any other D
// to the next multiple of 8 and slices o (kernels/flash_attention/ops.py).
// The tensor maps' innermost extent stays D, so the TMA zero-fills columns
// D..DP-1 of each row's last box (and counts the whole box in expect_tx);
// those zeros add exact zeros to every score, give zero columns of O, and
// only the D real columns are stored; the scale stays the wrapper's
// 1/sqrt(D). DP a multiple of 64 (64, 128, 192, 256) takes 64-column
// chunks under the 128-byte swizzle; the others (32, 96, 160, 224) 32-column
// chunks under the 64-byte swizzle: D = 96 is the D = 32 layout three
// times, 160 and 224 the same five and seven times. P V is wgmma
// m64n{DP}k16 with V MN-major across the CHUNKS swizzle atoms, a leading
// byte offset of one chunk apart. Keys come in tiles of 128 at DP <= 64, of
// 64 up to DP = 160 and of 32 above: ptxas allocates a consumer thread the
// launch's 168 registers (not setmaxnreg's 240), and at 64 keys the 32 fp32
// scores beside O's DP / 2 accumulators spilled at DP = 224 and 256 (252
// and 288 bytes) and serialized the wgmma at 192; at 32 keys they hold 16.
// At DP = 256 the Q tile (64 KB) and two stages of K and V tiles (64 KB)
// fit the 227 KB of shared memory. At D < DP at most D / DP of the bound's
// rate is reachable.
// Left for later: ping-pong scheduling of the two consumers, overlap of the
// softmax with the next tile's QK^T, and one K/V tile shared by the query
// heads of a GQA group.
//
// A wait on an mbarrier that does not complete within ~2^31 cycles (about a
// second) traps, so a protocol fault ends the launch with an error instead
// of hanging the card.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowsWG = 64;                 // query rows per consumer warpgroup
constexpr int kConsumers = 2;               // consumer warpgroups per CTA
constexpr int kRows = kRowsWG * kConsumers;  // query rows per CTA
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducer = 128 * kConsumers;  // the thread that issues TMA
constexpr int kStages = 2;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int DP_>
struct Cfg {
  static_assert(DP_ % 32 == 0 && DP_ <= 256, "DP: a multiple of 32 up to 256");
  static constexpr int DP = DP_;                       // computed columns
  // keys per tile: 32 from DP = 192, where S's 32 fp32 registers at 64 keys
  // beside O's DP / 2 would spill
  static constexpr int BK = DP <= 64 ? 128 : DP <= 160 ? 64 : 32;
  static constexpr int SW = DP % 64 == 0 ? 128 : 64;   // bytes per chunk row
  static constexpr int COLS = SW / 2;                  // bf16 columns per chunk
  static constexpr int CHUNKS = DP / COLS;
  static constexpr int Q_BYTES = kRows * DP * 2;
  static constexpr int KV_BYTES = BK * DP * 2;         // one K or V tile
  static constexpr int TILE_BYTES = Q_BYTES + 2 * kStages * KV_BYTES;
  static constexpr int N_BARS = 1 + 2 * kStages;
  static constexpr int SMEM = 1024 + TILE_BYTES + 8 * N_BARS;  // + alignment
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;  // wgmma swizzle code
};

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- wgmma m64n{32,64,...,256}k16, bf16 x bf16 -> fp32 ------------------
// d[0..16) += A(desc) * B(desc), m64n32k16, B K-major
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}
// d[0..16) += A(registers) * B(desc), m64n32k16, B MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[0..32) += A(desc) * B(desc), m64n64k16, B K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}
// d[0..32) += A(registers) * B(desc), m64n64k16, B MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[0..48) += A(registers) * B(desc), m64n96k16, B MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[0..64) += A(desc) * B(desc), m64n128k16, B K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}
// d[0..64) += A(registers) * B(desc), m64n128k16, B MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[0..80) += A(registers) * B(desc), m64n160k16, B MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n160(float (&d)[80],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[0..96) += A(registers) * B(desc), m64n192k16, B MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[0..112) += A(registers) * B(desc), m64n224k16, B MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n224(float (&d)[112],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %117, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111}, {%112, %113, %114, %115}, %116, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[0..128) += A(registers) * B(desc), m64n256k16, B MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}



template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (N == 32) wgmma_ss_n32(d, a, b, scale_d);
  else if constexpr (N == 64) wgmma_ss_n64(d, a, b, scale_d);
  else wgmma_ss_n128(d, a, b, scale_d);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 32) wgmma_rs_n32(d, a, b);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, b);
  else if constexpr (N == 96) wgmma_rs_n96(d, a, b);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, b);
  else if constexpr (N == 160) wgmma_rs_n160(d, a, b);
  else if constexpr (N == 192) wgmma_rs_n192(d, a, b);
  else if constexpr (N == 224) wgmma_rs_n224(d, a, b);
  else wgmma_rs_n256(d, a, b);
}

// ---- the kernel -----------------------------------------------------------
// EXACT: D == DP, a compile-time width (the instance a multiple of 32 runs;
// its code is that of a kernel compiled for D)
template <int DP_, bool EXACT>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int Sq,
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
        wgmma_ss<BK>(sc, da, db, kk > 0);
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

      // O += P V: P (bf16) from registers, V through the transposed
      // (MN-major) descriptor, 16 keys a step
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t pa[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
        const uint64_t dv = make_desc(v_s + s * C::KV_BYTES + kk * 16 * SW,
                                      BK * SW, 8 * SW, C::LAYOUT);
        wgmma_rs<DP>(acc, pa, dv);
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
  __nv_bfloat16* ob = o + (static_cast<long long>(b) * Sq * H + h) * D;
  if (row0 < Sq) {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      if (8 * j < D)
        *reinterpret_cast<uint32_t*>(ob + row0 * row_stride + 8 * j + col) =
            pack_bf16(acc[4 * j] / d0, acc[4 * j + 1] / d0);
  }
  if (row1 < Sq) {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      if (8 * j < D)
        *reinterpret_cast<uint32_t*>(ob + row1 * row_stride + 8 * j + col) =
            pack_bf16(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
  }
  // m is the scaled scores' running max in natural-log units (the
  // exponentials take (x - m) log2 e); the four threads of a row hold it
  if (lse != nullptr && lane % 4 == 0) {
    float* lb = lse + (static_cast<long long>(b) * H + h) * Sq;
    if (row0 < Sq) lb[row0] = m0 + logf(d0);
    if (row1 < Sq) lb[row1] = m1 + logf(d1);
  }
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
EncodeTiled encode_tiled() {
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

// A 4-D map over (D, heads, S, B) of a contiguous [B, S, heads, D] bf16
// tensor, box (cols, 1, rows, 1), swizzled by the chunk's row bytes. A box
// past column D (the last chunk when D < DP) is zero-filled there.
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
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                   const_cast<void*>(ptr), dims, strides, box, elem,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int DP, bool EXACT>
cudaError_t launch_instance(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int Sq, int Skv, int H,
                            int KV, int D, int causal, int window, float scale,
                            cudaStream_t stream) {
  using C = Cfg<DP>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_sm90<DP, EXACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_map(&mq, q, D, H, Sq, B, C::COLS, kRows);
  if (err == cudaSuccess) err = make_map(&mk, k, D, KV, Skv, B, C::COLS, C::BK);
  if (err == cudaSuccess) err = make_map(&mv, v, D, KV, Skv, B, C::COLS, C::BK);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + kRows - 1) / kRows);
  flash_fwd_sm90<DP, EXACT><<<grid, kThreads, C::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), Sq,
      Skv, H, KV, D, causal, window, scale);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int Sq, int Skv, int H, int KV, int D,
                   int causal, int window, float scale, cudaStream_t stream) {
  return D == DP
      ? launch_instance<DP, true>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, scale, stream)
      : launch_instance<DP, false>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, scale, stream);
}

template <int DP>
cudaError_t attrs(int D, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = D == DP
      ? cudaFuncGetAttributes(&a, flash_fwd_sm90<DP, true>)
      : cudaFuncGetAttributes(&a, flash_fwd_sm90<DP, false>);
  if (err == cudaSuccess) {
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
    out[2] = static_cast<int>(a.sharedSizeBytes);
    out[3] = Cfg<DP>::SMEM;
  }
  return err;
}

}  // namespace

// The compiled instance for head dim D (computed width DP = D rounded up to
// 32; the EXACT one when D == DP): its registers a thread (at launch, before setmaxnreg), local (spill)
// bytes a thread, static and dynamic shared bytes a CTA, into out[0..3].
extern "C" int flash_attention_attrs_bf16(int D, int* out) {
  switch ((D + 31) / 32 * 32) {
    case 32: return attrs<32>(D, out);
    case 64: return attrs<64>(D, out);
    case 96: return attrs<96>(D, out);
    case 128: return attrs<128>(D, out);
    case 160: return attrs<160>(D, out);
    case 192: return attrs<192>(D, out);
    case 224: return attrs<224>(D, out);
    case 256: return attrs<256>(D, out);
    default: return cudaErrorInvalidValue;
  }
}

// bf16 q, k, v, o, fp32 lse (null: not written); window <= 0 means no
// window. Returns the launch's cudaError_t (cudaErrorInvalidValue for a
// head_dim that is not a multiple of 8 in 8..256, or a tensor the TMA
// cannot map).
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int B, int Sq, int Skv, int H, int KV,
                                        int D, int causal, int window,
                                        float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D < 8 || D % 8) return cudaErrorInvalidValue;
  switch ((D + 31) / 32 * 32) {
    case 32: return launch<32>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, scale, s);
    case 64: return launch<64>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, scale, s);
    case 96: return launch<96>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, scale, s);
    case 128: return launch<128>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, scale, s);
    case 160: return launch<160>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, scale, s);
    case 192: return launch<192>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, scale, s);
    case 224: return launch<224>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, scale, s);
    case 256: return launch<256>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
