// Causal / sliding-window GQA flash attention (forward) past the clusters'
// reach, the split route: fp32 past D = 2,048 (3xTF32 on mma.sync) and bf16
// and fp16 past 1,792 (wgmma). Two kernels a piece of the call, S = Q K^T
// computed once on the tensor cores:
//   1. the scores: one CTA a 128-row query tile x a key tile of one (batch,
//      head); Q and K stream through D in TMA boxes; the scaled, masked fp32
//      scores go to a workspace in device memory, with each row's maximum
//      over the tile;
//   2. P V by column group: one CTA a (query tile, column group of O); a
//      row's m is the maximum of its tile maxima (exact, whatever the order),
//      the score tiles come back through TMA beside the group's V tiles, P =
//      exp(s - m), l sums P in fp32, O += P V; o = O / max(l, 1e-30), and
//      group 0 writes lse = m + log(max(l, 1e-30)).
// The translation unit flash_attention_split.cu instantiates them behind the
// C entry flash_attention_split, which the wrapper
// (kernels/flash_attention/ops.py: flash_attention_split_cuda) calls once a
// piece with the workspace it allocated.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// _flash_kernel (entry flash_attention_pallas), which takes any D, at the
// head dims no cluster of the other tensor-core kernels reaches (8 CTAs,
// the portable size). In the port it runs on the flash branch of
// models/attention.attention_forward for a ModelConfig(head_dim=...) past
// them.
//
// What it computes is each type's kernels' function (flash_sm90.cuh for bf16
// and fp16, flash_tf32.cuh for fp32):
//   * bf16 / fp16: S = Q K^T on wgmma m64n128k16, chained on one accumulator
//     over D in chunks of 64 columns, times 1/sqrt(D) in fp32; P = ex2((s -
//     m) log2 e), rounded to the input's type before P V (wgmma m64n{GW}k16,
//     V through the transposed descriptor), l sums the fp32 P;
//   * fp32: q times scale in fp32, each operand split into TF32 hi (rounded
//     to nearest: split_rn) and lo, three mma.sync.m16n8k8 a step of 8
//     columns (lo hi, hi lo, hi hi), each 32-column box's 12 mma chained on
//     the running compensation of the boxes' sum, which adds them in order
//     (Fast2Sum: the score is the sum plus its compensation); P = expf(s -
//     m), split, and each key tile's P V (12 mma for 8 columns of O) on a
//     fresh accumulator added to O (the tensor core rounds each mma's sum
//     toward zero, flash_tf32.cuh);
//   * masked scores are -1e30 and keys past Skv -inf (written by kernel 1);
//     a row that sees no key (a window that ends before Skv) has m = -1e30
//     and P = 1 on every key < Skv: the mean of V over every key, as in the
//     plain version;
//   * l: each thread adds, a key tile at a time, its keys 8 j + 2 t and
//     8 j + 2 t + 1 (t = lane % 4) as one pair sum; the four shares are added
//     through two xor shuffles. No online rescale: every column group computes
//     the same m and l, bit for bit, from the same operations in the same
//     order.
// Kernel 1 skips the key tiles wholly above a query tile's diagonal or
// before its window (flash_sm90.cuh: key_range; none where a row of the
// tile sees no key); kernel 2 walks the same range in tiles of 32 keys, and
// a warp (fp32: 32 rows) or warpgroup (16-bit: 64 rows) skips the tiles
// wholly masked for its rows, whose P is 0. Query rows past Sq are computed
// (zero-filled by the TMA) and not stored.
//
// Workspace: a piece is whole query tiles of every (batch, head), or where
// one query tile of every (batch, head) does not fit, one query tile of a
// range of (batch, head) (ops.split_pieces); its scores are rows (bl nt + tl)
// 128 + r, bl and tl the (batch, head) and query tile within the piece, of
// ld = Skv rounded up to 128 fp32 keys (at most 1 GiB a piece), and its tile
// maxima the same rows of ld / 64 floats. Only the tiles kernel 1 computes
// are written and read.
//
// What bounds it on an H100 SXM at [4, 2048, 32 | 4, D] causal: the
// products (2.209e12 operations at D = 2,056: 13.39 ms in 3xTF32 at 495
// TFLOP/s; 1.934e12 at D = 1,800: 1.955 ms at 989 TFLOP/s of bf16) against
// q, k, v and o (4.9 GB in fp32, 2.1 GB in 16 bits) and the visible scores
// written once and read once a column group (1.1 GB, mostly from L2: the NG
// CTAs of a query tile are launched next to each other, x = group). So the
// products run on the tensor cores once, and the scores' round trip costs
// bytes instead of a QK^T a group:
//   * 16-bit kernel 1: a producer warpgroup (one thread) and two consumer
//     warpgroups of 64 rows, a ring of four (Q chunk 128 x 64, K chunk 128 x
//     64) stages under the 128-byte swizzle, wgmma m64n128k16 four k-steps a
//     chunk; shared memory does not grow with D;
//   * 16-bit kernel 2: the same warpgroups, a ring of four (score box 128 x
//     32 fp32 under the 128-byte swizzle, V tile 32 x GW) stages; P from
//     registers;
//   * fp32 kernel 1: 8 warps of 32 rows x 32 keys of a 128 x 64 tile, a ring
//     of four (Q box 128 x 32, K box 64 x 32) stages, thread 0 issuing the
//     next box after the barrier that frees a slot; two CTAs an SM;
//   * fp32 kernel 2: 8 warps of 32 rows x GW / 2 columns (a V fragment feeds
//     two m16 tiles), a ring of three (score box, GW / 32 V boxes of 32 x 32)
//     stages.
// Left for later: persistent CTAs (each CTA's ring fills anew), multicast of
// the score tiles to a query tile's groups, and scores in fewer bytes.
#pragma once

#include "flash_tf32.cuh"   // flash_sm90.cuh's wrappers, key_range, make_map;
                            // tf32::mma_tf32, make_map_f32

// the route's entry (flash_attention_split.cu): dtype 0 = bf16, 1 = fp16,
// 2 = fp32; D > 256
extern "C" int flash_attention_split(int dtype, const void* q, const void* k,
                                     const void* v, void* o, void* lse, void* ws,
                                     void* maxes, int B, int Sq, int Skv, int H,
                                     int KV, int D, int causal, int window,
                                     float scale, int bh0, int nbh, int t0, int nt,
                                     int ld, void* stream);
extern "C" int flash_attention_split_attrs(int dtype, int D, int* out);

namespace {
namespace split {

constexpr int kKeyPad = 128;       // the workspace's keys a row: Skv rounded up
constexpr int kMaxStride = 64;     // ld / 64 tile maxima a row
constexpr int kBK = 32;            // kernel 2's keys a tile (one 128-byte box row)
constexpr int kBoxBytes = kRows * kBK * 4;   // a score box: 16 KB
constexpr int kWarps = 8;          // fp32 kernels
constexpr int kThreads32 = 32 * kWarps;

// ---- bf16 / fp16 ------------------------------------------------------------
struct Scores16 {
  static constexpr int BN = 128;                      // keys a tile
  static constexpr int SC = 64;                       // columns of a chunk
  static constexpr int QC_BYTES = kRows * SC * 2;     // 16 KB
  static constexpr int KC_BYTES = BN * SC * 2;        // 16 KB
  static constexpr int STAGE = QC_BYTES + KC_BYTES;
  static constexpr int STAGES = 4;
  static constexpr int TILE_BYTES = STAGES * STAGE;
  static constexpr int SMEM = 1024 + TILE_BYTES + 8 * 2 * STAGES;
};

template <int GW_>
struct Pv16 {
  static_assert(GW_ % 32 == 0 && GW_ >= 160 && GW_ <= kMaxGroup,
                "GW: a multiple of 32 in 160..224");
  static constexpr int GW = GW_;
  static constexpr int SW_V = GW % 64 == 0 ? 128 : 64;  // bytes a V chunk row
  static constexpr int COLS_V = SW_V / 2;
  static constexpr int V_CHUNKS = GW / COLS_V;
  static constexpr int V_BYTES = kBK * GW * 2;
  static constexpr int STAGE = kBoxBytes + V_BYTES;    // a multiple of 1 KB
  static constexpr int STAGES = 4;
  static constexpr int TILE_BYTES = STAGES * STAGE;
  static constexpr int SMEM = 1024 + TILE_BYTES + 8 * 2 * STAGES;
  static constexpr uint64_t LAYOUT_V = SW_V == 128 ? 1 : 2;
};

// The piece's query tile of blockIdx (local tile tl, (batch, head) bl): its
// first row q0 and its first row in the workspace
struct TileAt {
  int b, h, kvh, q0, tl;
  long long row;
};

__device__ __forceinline__ TileAt tile_at(int tl, int bl, int bh0, int t0, int nt,
                                          int H, int KV) {
  TileAt t;
  const int bh = bh0 + bl;
  t.b = bh / H;
  t.h = bh % H;
  t.kvh = t.h / (H / KV);
  t.tl = tl;
  t.q0 = (t0 + tl) * kRows;
  t.row = (static_cast<long long>(bl) * nt + tl) * kRows;
  return t;
}

// ---- kernel 1, bf16 / fp16: the scores of query tile blockIdx.y, key tile
// blockIdx.x, (batch, head) blockIdx.z of the piece
template <typename E>
__global__ void __launch_bounds__(kThreads, 1)
scores_16(const __grid_constant__ CUtensorMap tm_q,
          const __grid_constant__ CUtensorMap tm_k, float* __restrict__ ws,
          float* __restrict__ maxes, int Sq, int Skv, int H, int KV, int D,
          int causal, int window, float scale, int bh0, int t0, int nt, int ld) {
  using C = Scores16;
  constexpr int BN = C::BN, STAGES = C::STAGES;
  const TileAt at = tile_at(blockIdx.y, blockIdx.z, bh0, t0, nt, H, KV);
  const int q0 = at.q0;
  const KeyRange kr = key_range(q0, Sq, Skv, causal, window, BN);
  const int kt = blockIdx.x;
  if (kt < kr.k_begin / BN || kt >= kr.k_begin / BN + kr.n_tiles) return;
  const int k0 = kt * BN;
  const int n_chunks = (D + C::SC - 1) / C::SC;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // swizzle atoms: 1024 B
  const uint32_t bars = base + C::TILE_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * kConsumers);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer warpgroup: one thread loads the D chunks of Q and K
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kProducer) {
      for (int c = 0; c < n_chunks; ++c) {
        const int s = c % STAGES;
        mbar_wait(empty(s), ((c / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), C::STAGE);
        tma_load_4d(base + s * C::STAGE, &tm_q, full(s), c * C::SC, at.h, q0, at.b);
        tma_load_4d(base + s * C::STAGE + C::QC_BYTES, &tm_k, full(s), c * C::SC,
                    at.kvh, k0, at.b);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: rows q0 + 64 wg .. + 63, S over the D chunks
  // in order on one accumulator; a chunk's stage is released once the
  // products that read it completed
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int r_lo = q0 + wg * kRowsWG, r_hi = r_lo + kRowsWG - 1;
  const int row0 = r_lo + warp * 16 + lane / 4, row1 = row0 + 8;
  const int col = 2 * (lane % 4);                     // + 8 j (+ 1)
  float acc[BN / 2];
  fence_regs(acc);
  wgmma_fence();
  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % STAGES;
    mbar_wait(full(s), (c / STAGES) & 1);
    const uint32_t qa = base + s * C::STAGE + wg * kRowsWG * 128;
    const uint32_t ka = base + s * C::STAGE + C::QC_BYTES;
#pragma unroll
    for (int kk = 0; kk < C::SC / 16; ++kk) {
      const uint64_t da = make_desc(qa + kk * 32, 16, 8 * 128, 1);
      const uint64_t db = make_desc(ka + kk * 32, 16, 8 * 128, 1);
      wgmma_ss<E, BN>(acc, da, db, c > 0 || kk > 0);
    }
    wgmma_commit();
    if (c > 0) {
      wgmma_wait_one();              // chunk c - 1's products are done
      __syncwarp();
      if (lane == 0) mbar_arrive(empty((c - 1) % STAGES));
    }
  }
  wgmma_wait_all();
  fence_regs(acc);

  // scale, mask (flash_sm90.cuh: softmax_tile's rule), the rows' maxima,
  // and the tile to the workspace (rows row0: acc[4j], acc[4j+1]; row1:
  // acc[4j+2], acc[4j+3]; keys k0 + 8 j + col (+1))
  const bool need_mask = k0 + BN > Skv || (causal && k0 + BN - 1 > r_lo) ||
                         (window > 0 && r_hi - k0 >= window);
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      float x = acc[4 * j + v] * scale;
      if (need_mask) {
        const int row = v < 2 ? row0 : row1;
        const int key = k0 + 8 * j + col + (v & 1);
        const bool vis = (!causal || key <= row) && (window <= 0 || row - key < window);
        x = key >= Skv ? -INFINITY : vis ? x : kNegInf;
      }
      acc[4 * j + v] = x;
    }
    mx0 = fmaxf(mx0, fmaxf(acc[4 * j], acc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(acc[4 * j + 2], acc[4 * j + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const long long w0 = at.row + (row0 - q0), w1 = w0 + 8;
  float* s0 = ws + w0 * ld + k0 + col;
  float* s1 = ws + w1 * ld + k0 + col;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    *reinterpret_cast<float2*>(s0 + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(s1 + 8 * j) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  if (lane % 4 == 0) {
    const int ldm = ld / kMaxStride;
    maxes[w0 * ldm + kt] = mx0;
    maxes[w1 * ldm + kt] = mx1;
  }
}

// ---- kernel 2, bf16 / fp16: column group blockIdx.x of O, query tile
// nt - 1 - blockIdx.y (late tiles first), (batch, head) blockIdx.z
template <typename E, int GW_>
__global__ void __launch_bounds__(kThreads, 1)
pv_16(const __grid_constant__ CUtensorMap tm_s, const __grid_constant__ CUtensorMap tm_v,
      const float* __restrict__ maxes, E* __restrict__ o, float* __restrict__ lse,
      int Sq, int Skv, int H, int KV, int D, int causal, int window, int bh0, int t0,
      int nt, int ld) {
  using C = Pv16<GW_>;
  constexpr int GW = C::GW, SW_V = C::SW_V, STAGES = C::STAGES, BK = kBK;
  const TileAt at = tile_at(nt - 1 - blockIdx.y, blockIdx.z, bh0, t0, nt, H, KV);
  const int q0 = at.q0;
  const int c0 = blockIdx.x * GW;                       // the group's first column
  // V chunks that hold a column < D (those wholly past D stay unloaded: they
  // reach only O columns that are not stored)
  const int v_chunks = min(C::V_CHUNKS, (D - c0 + C::COLS_V - 1) / C::COLS_V);
  const KeyRange kr = key_range(q0, Sq, Skv, causal, window, BK);

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* const sm = smem_raw + (base - raw);
  const uint32_t bars = base + C::TILE_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ---- producer warpgroup: a key tile's score box and its V tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kProducer) {
      for (int t = 0; t < kr.n_tiles; ++t) {
        const int s = t % STAGES, k0 = kr.k_begin + t * BK;
        const uint32_t st = base + s * C::STAGE;
        mbar_wait(empty(s), ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), kBoxBytes + v_chunks * BK * SW_V);
        tma_load_4d(st, &tm_s, full(s), k0, static_cast<int>(at.row), 0, 0);
        for (int vc = 0; vc < v_chunks; ++vc)
          tma_load_4d(st + kBoxBytes + vc * BK * SW_V, &tm_v, full(s),
                      c0 + vc * C::COLS_V, at.kvh, k0, at.b);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: query rows q0 + 64 wg .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int r_lo = q0 + wg * kRowsWG, r_hi = r_lo + kRowsWG - 1;
  const int lr0 = wg * kRowsWG + warp * 16 + lane / 4;   // rows in the tile
  const int row0 = q0 + lr0, row1 = row0 + 8;
  const int col = 2 * (lane % 4);                     // + 8 j (+ 1)
  const bool dead = r_lo >= Sq;

  // m: the rows' maxima over the tiles kernel 1 computed, the four threads
  // of a row taking every fourth
  float m0 = kNegInf, m1 = kNegInf;
  if (!dead) {
    const KeyRange k1 = key_range(q0, Sq, Skv, causal, window, Scores16::BN);
    const int ldm = ld / kMaxStride;
    const float* p0 = maxes + (at.row + lr0) * ldm + k1.k_begin / Scores16::BN;
    const float* p1 = p0 + 8 * ldm;
    for (int i = lane % 4; i < k1.n_tiles; i += 4) {
      m0 = fmaxf(m0, p0[i]);
      m1 = fmaxf(m1, p1[i]);
    }
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
  }

  float acc[GW / 2];
#pragma unroll
  for (int i = 0; i < GW / 2; ++i) acc[i] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  for (int t = 0; t < kr.n_tiles; ++t) {
    const int s = t % STAGES, k0 = kr.k_begin + t * BK;
    mbar_wait(full(s), (t / STAGES) & 1);
    const bool skip = dead || (!kr.orphans && ((causal && k0 > r_hi) ||
                      (window > 0 && k0 + BK - 1 < r_lo - window + 1)));
    if (!skip) {
      // P from the score box: row r's keys 8 j + col (+1) in 16-byte unit
      // (2 j + col / 4) ^ (r % 8) (the 128-byte swizzle; r % 8 = lane / 4)
      const uint8_t* box = sm + s * C::STAGE;
      float sc[BK / 2];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const int off = (((2 * j + col / 4) ^ (lane / 4)) << 4) + (col % 4) * 4;
        const float2 a = *reinterpret_cast<const float2*>(box + lr0 * 128 + off);
        const float2 c = *reinterpret_cast<const float2*>(box + (lr0 + 8) * 128 + off);
        sc[4 * j] = ex2((a.x - m0) * kLog2e);
        sc[4 * j + 1] = ex2((a.y - m0) * kLog2e);
        sc[4 * j + 2] = ex2((c.x - m1) * kLog2e);
        sc[4 * j + 3] = ex2((c.y - m1) * kLog2e);
        l0 += sc[4 * j] + sc[4 * j + 1];
        l1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      // O[:, c0 .. c0 + GW) += P V_group, P (E) from registers
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t pa[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[r] = pack2<E>(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
        const uint64_t dv = make_desc(base + s * C::STAGE + kBoxBytes + kk * 16 * SW_V,
                                      BK * SW_V, 8 * SW_V, C::LAYOUT_V);
        wgmma_rs<E, GW>(acc, pa, dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));   // this warp is done with stage s
  }

  const long long row_stride = static_cast<long long>(H) * D;
  store_rows<E>(acc, m0, m1, l0, l1,
                o + (static_cast<long long>(at.b) * Sq * H + at.h) * D + c0,
                lse == nullptr || blockIdx.x != 0
                    ? nullptr : lse + (static_cast<long long>(at.b) * H + at.h) * Sq,
                row0, row1, col, lane, Sq, row_stride, D - c0);
}

// ---- fp32 (3xTF32) ------------------------------------------------------------
struct Scores32 {
  static constexpr int BN = 64;                       // keys a tile
  static constexpr int Q_BYTES = kRows * 128;         // a 32-column box of Q
  static constexpr int K_BYTES = BN * 128;
  static constexpr int STAGE = Q_BYTES + K_BYTES;     // 24 KB
  static constexpr int STAGES = 4;
  static constexpr int RED_OFF = STAGES * STAGE;      // the two key halves' maxima
  static constexpr int TILE_BYTES = RED_OFF + 2 * kRows * 4;
  static constexpr int SMEM = 1024 + TILE_BYTES + 8 * STAGES;
};

template <int GW_>
struct Pv32 {
  static_assert(GW_ % 32 == 0 && GW_ >= 160 && GW_ <= tf32::kMaxGroup,
                "GW: a multiple of 32 in 160..256");
  static constexpr int GW = GW_;
  static constexpr int NCH = GW / 32;                 // 32-column V boxes
  static constexpr int V_BYTES = NCH * kBK * 128;
  static constexpr int STAGE = kBoxBytes + V_BYTES;
  static constexpr int STAGES = 3;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 8 * STAGES;
  static constexpr int NH = GW / 16;                  // a warp's 8-column tiles
};

// the 128-byte swizzle's byte offset of 16-byte unit u in a row r (r % 8 = g)
__device__ __forceinline__ int swz(int u, int g) { return (u ^ g) << 4; }

// x = hi + lo, hi x rounded to the nearest TF32 pattern (an integer add and
// a mask: ties away from zero) and lo = x - hi, exact: |lo| <= 2^-11 |x|,
// half tf32::split's bound, so the tensor core's read of lo through its top
// 19 bits and the dropped lo lo product lose 2x and 4x less
__device__ __forceinline__ void split_rn(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b in 3xTF32: lo hi, hi lo, hi hi (flash_tf32.cuh's order)
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  tf32::mma_tf32(d[0], d[1], d[2], d[3], al[0], al[1], al[2], al[3], bh0, bh1);
  tf32::mma_tf32(d[0], d[1], d[2], d[3], ah[0], ah[1], ah[2], ah[3], bl0, bl1);
  tf32::mma_tf32(d[0], d[1], d[2], d[3], ah[0], ah[1], ah[2], ah[3], bh0, bh1);
}

// ---- kernel 1, fp32: as scores_16, a 128 x 64 tile; warp w owns rows
// 32 (w / 2) .. + 31 and keys 32 (w % 2) .. + 31 (2 x 4 mma tiles)
__global__ void __launch_bounds__(kThreads32, 2)
scores_32(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
          float* __restrict__ ws, float* __restrict__ maxes, int Sq, int Skv, int H,
          int KV, int D, int causal, int window, float scale, int bh0, int t0, int nt,
          int ld) {
  using C = Scores32;
  constexpr int BN = C::BN, STAGES = C::STAGES;
  const TileAt at = tile_at(blockIdx.y, blockIdx.z, bh0, t0, nt, H, KV);
  const int q0 = at.q0;
  const KeyRange kr = key_range(q0, Sq, Skv, causal, window, BN);
  const int kt = blockIdx.x;
  if (kt < kr.k_begin / BN || kt >= kr.k_begin / BN + kr.n_tiles) return;
  const int k0 = kt * BN;
  const int nbox = (D + 31) / 32;

  extern __shared__ uint8_t split_smem[];
  const uint32_t raw = smem_u32(split_smem);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;   // swizzle atoms: 1024 B
  uint8_t* const sm = split_smem + pad;
  const uint32_t base = raw + pad;
  const uint32_t bars = base + C::TILE_BYTES;
  auto full = [&](int s) { return bars + 8u * s; };
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const CUtensorMap* const mq = &tm_q;
  const CUtensorMap* const mk = &tm_k;
  auto load = [&](int c) {
    const int s = c % STAGES;
    mbar_expect_tx(full(s), C::STAGE);
    tma_load_4d(base + s * C::STAGE, mq, full(s), 32 * c, at.h, q0, at.b);
    tma_load_4d(base + s * C::STAGE + C::Q_BYTES, mk, full(s), 32 * c, at.kvh, k0, at.b);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int c = 0; c < min(STAGES, nbox); ++c) load(c);

  const int rw = 32 * (warp / 2), kw = 32 * (warp % 2);   // the warp's rows, keys
  auto lds = [&](int off) { return *reinterpret_cast<const float*>(sm + off); };
  // ss: the boxes' sum; cs: its compensation, which starts the next box's
  // chain (Fast2Sum: the low bits each add loses go into the next box)
  float ss[2][4][4], cs[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ss[i][n][e] = cs[i][n][e] = 0.f;
  for (int c = 0; c < nbox; ++c) {
    const int s = c % STAGES;
    mbar_wait(full(s), (c / STAGES) & 1);
    __syncwarp();          // mma.sync is .aligned
    // Q's rows rw + 16 i + gq (+8), K's keys kw + 8 n + gq, at column
    // 8 kq + tq (+4) of the box: unit 2 kq (+1), swizzled by the row's gq
    const int qb = s * C::STAGE + (rw + gq) * 128 + 4 * tq;
    const int kb = s * C::STAGE + C::Q_BYTES + (kw + gq) * 128 + 4 * tq;
#pragma unroll
    for (int kq = 0; kq < 4; ++kq) {
      if (32 * c + 8 * kq >= D) break;         // zeros past D
      const int u = 2 * kq;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qi = qb + 16 * i * 128;
        split_rn(lds(qi + swz(u, gq)) * scale, ah[i][0], al[i][0]);
        split_rn(lds(qi + 8 * 128 + swz(u, gq)) * scale, ah[i][1], al[i][1]);
        split_rn(lds(qi + swz(u + 1, gq)) * scale, ah[i][2], al[i][2]);
        split_rn(lds(qi + 8 * 128 + swz(u + 1, gq)) * scale, ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int kn = kb + 8 * n * 128;
        uint32_t bh0, bl0, bh1, bl1;
        split_rn(lds(kn + swz(u, gq)), bh0, bl0);
        split_rn(lds(kn + swz(u + 1, gq)), bh1, bl1);
#pragma unroll
        for (int i = 0; i < 2; ++i) mma3(cs[i][n], ah[i], al[i], bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float sum = ss[i][n][e] + cs[i][n][e];
          cs[i][n][e] = (ss[i][n][e] - sum) + cs[i][n][e];
          ss[i][n][e] = sum;
        }
    __syncthreads();       // every warp is done with stage s
    if (tid == 0 && c + STAGES < nbox) load(c + STAGES);
  }

  // the scores ss + cs; mask (flash_tf32.cuh's rule), the rows' maxima over
  // the warp's 32 keys, the tile to the workspace (rows rw + 16 i + gq (+8):
  // ss[i][n][0..1] (..2..3); keys kw + 8 n + 2 tq (+1))
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ss[i][n][e] += cs[i][n][e];
  const int r_lo = q0 + rw, r_hi = r_lo + 31, k0w = k0 + kw;
  const bool need_mask = k0w + 32 > Skv || (causal && k0w + 31 > r_lo) ||
                         (window > 0 && r_hi - k0w >= window);
  float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (need_mask) {
          const int row = r_lo + 16 * i + gq + (e < 2 ? 0 : 8);
          const int key = k0w + 8 * n + 2 * tq + (e & 1);
          if (key >= Skv)
            ss[i][n][e] = -INFINITY;
          else if ((causal && key > row) || (window > 0 && row - key >= window))
            ss[i][n][e] = tf32::kMasked;
        }
        mx[i][e / 2] = fmaxf(mx[i][e / 2], ss[i][n][e]);
      }
  float* red = reinterpret_cast<float*>(sm + C::RED_OFF);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float x = mx[i][hh];
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const int lr = rw + 16 * i + 8 * hh + gq;
      if (tq == 0) red[(warp % 2) * kRows + lr] = x;
      float* sp = ws + (at.row + lr) * ld + k0w + 2 * tq;
#pragma unroll
      for (int n = 0; n < 4; ++n)
        *reinterpret_cast<float2*>(sp + 8 * n) =
            make_float2(ss[i][n][2 * hh], ss[i][n][2 * hh + 1]);
    }
  __syncthreads();
  if (tid < kRows)
    maxes[(at.row + tid) * (ld / kMaxStride) + kt] = fmaxf(red[tid], red[kRows + tid]);
}

// ---- kernel 2, fp32: as pv_16; warp w owns rows 32 (w / 2) .. + 31 and the
// group's columns (w % 2) GW / 2 .. + GW / 2 - 1
template <int GW_>
__global__ void __launch_bounds__(kThreads32, 1)
pv_32(const __grid_constant__ CUtensorMap tm_s, const __grid_constant__ CUtensorMap tm_v,
      const float* __restrict__ maxes, float* __restrict__ o, float* __restrict__ lse,
      int Sq, int Skv, int H, int KV, int D, int causal, int window, int bh0, int t0,
      int nt, int ld) {
  using C = Pv32<GW_>;
  constexpr int GW = C::GW, NH = C::NH, STAGES = C::STAGES, BK = kBK;
  const TileAt at = tile_at(nt - 1 - blockIdx.y, blockIdx.z, bh0, t0, nt, H, KV);
  const int q0 = at.q0;
  const int g = blockIdx.x, c0 = g * GW;
  const int dv = min(GW, D - c0);            // the group's real columns (> 0)
  const int nch = (dv + 31) / 32;            // V boxes loaded: columns < D
  const KeyRange kr = key_range(q0, Sq, Skv, causal, window, BK);

  extern __shared__ uint8_t split_smem[];
  const uint32_t raw = smem_u32(split_smem);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  uint8_t* const sm = split_smem + pad;
  const uint32_t base = raw + pad;
  const uint32_t bars = base + STAGES * C::STAGE;
  auto full = [&](int s) { return bars + 8u * s; };
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const CUtensorMap* const ms = &tm_s;
  const CUtensorMap* const mv = &tm_v;
  auto load = [&](int t) {
    const int s = t % STAGES, k0 = kr.k_begin + t * BK;
    const uint32_t st = base + s * C::STAGE;
    mbar_expect_tx(full(s), kBoxBytes + nch * BK * 128);
    tma_load_4d(st, ms, full(s), k0, static_cast<int>(at.row), 0, 0);
    for (int c = 0; c < nch; ++c)
      tma_load_4d(st + kBoxBytes + c * BK * 128, mv, full(s), c0 + 32 * c, at.kvh, k0,
                  at.b);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int t = 0; t < min(STAGES, kr.n_tiles); ++t) load(t);

  const int rw = 32 * (warp / 2), cw = (warp % 2) * (GW / 2);   // rows, columns
  const int r_lo = q0 + rw, r_hi = r_lo + 31;
  const bool dead = r_lo >= Sq;
  auto lds = [&](int off) { return *reinterpret_cast<const float*>(sm + off); };

  // m of rows rw + 16 i + 8 hh + gq: the maximum of their tile maxima, the
  // four threads of a row taking every fourth
  float m[2][2] = {{tf32::kMasked, tf32::kMasked}, {tf32::kMasked, tf32::kMasked}};
  if (!dead) {
    const KeyRange k1 = key_range(q0, Sq, Skv, causal, window, Scores32::BN);
    const int ldm = ld / kMaxStride;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float* p = maxes + (at.row + rw + 16 * i + 8 * hh + gq) * ldm +
                         k1.k_begin / Scores32::BN;
        float x = m[i][hh];
        for (int j = tq; j < k1.n_tiles; j += 4) x = fmaxf(x, p[j]);
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        m[i][hh] = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      }
  }

  float acc[2][NH][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < NH; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.f;
  float l[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int t = 0; t < kr.n_tiles; ++t) {
    const int s = t % STAGES, k0 = kr.k_begin + t * BK;
    mbar_wait(full(s), (t / STAGES) & 1);
    __syncwarp();
    const bool skip = dead || (!kr.orphans && ((causal && k0 > r_hi) ||
                      (window > 0 && k0 + BK - 1 < r_lo - window + 1)));
    if (!skip) {
      // P's A fragments of key group j: rows gq, gq + 8 at keys 8 j + 2 tq
      // (+1), which are the k-step's columns tq (tq + 4); the score box's
      // row r holds key 8 j + 2 tq in unit (2 j + tq / 2) ^ (r % 8)
      uint32_t ph[2][4][4], pl[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int off = s * C::STAGE + (rw + 16 * i + gq) * 128 +
                          swz(2 * j + tq / 2, gq) + 8 * (tq % 2);
          const float2 a = *reinterpret_cast<const float2*>(sm + off);
          const float2 b = *reinterpret_cast<const float2*>(sm + off + 8 * 128);
          const float p00 = expf(a.x - m[i][0]), p01 = expf(a.y - m[i][0]);
          const float p10 = expf(b.x - m[i][1]), p11 = expf(b.y - m[i][1]);
          l[i][0] += p00 + p01;
          l[i][1] += p10 + p11;
          split_rn(p00, ph[i][j][0], pl[i][j][0]);
          split_rn(p10, ph[i][j][1], pl[i][j][1]);
          split_rn(p01, ph[i][j][2], pl[i][j][2]);
          split_rn(p11, ph[i][j][3], pl[i][j][3]);
        }
      // 8 columns of O at a time: the tile's 32 keys (12 mma) on a fresh
      // accumulator, then added to O; V's keys 8 j + 2 tq (+1) at column
      // 8 n + gq of its box: unit (2 (n % 4) + gq / 4) ^ (2 tq (+1))
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const int cn = cw + 8 * n;
        if (cn >= dv) break;                    // columns past D: not stored
        const int vn = s * C::STAGE + kBoxBytes + (cn / 32) * BK * 128 +
                       2 * tq * 128 + 4 * (gq & 3);
        const int u = 2 * ((cn / 8) % 4) + gq / 4;
        float t4[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int vj = vn + 8 * j * 128;
          uint32_t bh0, bl0, bh1, bl1;
          split_rn(lds(vj + swz(u, 2 * tq)), bh0, bl0);
          split_rn(lds(vj + 128 + swz(u, 2 * tq + 1)), bh1, bl1);
#pragma unroll
          for (int i = 0; i < 2; ++i) mma3(t4[i], ph[i][j], pl[i][j], bh0, bh1, bl0, bl1);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][n][e] += t4[i][e];
      }
    }
    __syncthreads();       // every warp is done with stage s
    if (tid == 0 && t + STAGES < kr.n_tiles) load(t + STAGES);
  }

  // epilogue: full row sums, divide, store rows < Sq and the real columns
  // (cw + 8 n + 2 tq + 1 < dv iff cw + 8 n + 2 tq < dv: D is a multiple of 4)
  const long long row_stride = static_cast<long long>(H) * D;
  float* ob = o + (static_cast<long long>(at.b) * Sq * H + at.h) * D + c0;
  float* lb = lse == nullptr || g != 0 || cw != 0
                  ? nullptr : lse + (static_cast<long long>(at.b) * H + at.h) * Sq;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float x = l[i][hh];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      const float d = fmaxf(x, 1e-30f);
      const int row = r_lo + 16 * i + 8 * hh + gq;
      if (row >= Sq) continue;
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        const int cn = cw + 8 * n + 2 * tq;
        if (cn >= dv) break;
        *reinterpret_cast<float2*>(ob + row * row_stride + cn) =
            make_float2(acc[i][n][2 * hh] / d, acc[i][n][2 * hh + 1] / d);
      }
      if (lb != nullptr && tq == 0) lb[row] = m[i][hh] + logf(d);
    }
}

// ---- host side ------------------------------------------------------------
// A 4-D map over a piece's score rows (ld keys, rows, 1, 1) of fp32, box (32
// keys, 128 rows) under the 128-byte swizzle
inline cudaError_t make_map_scores(CUtensorMap* map, const void* ws, int ld, long long rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(ld), static_cast<cuuint64_t>(rows),
                              1, 1};
  const cuuint64_t row = static_cast<cuuint64_t>(ld) * 4;
  const cuuint64_t strides[3] = {row, row * rows, row * rows};
  const cuuint32_t box[4] = {kBK, kRows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ws), dims,
                   strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// fp32's column groups: ng = ceil(D / 256) groups of gw = ceil(D / ng)
// rounded up to 32 columns, as ops.column_groups computes them
inline void groups32(int D, int* ng, int* gw) {
  *ng = (D + tf32::kMaxGroup - 1) / tf32::kMaxGroup;
  *gw = ((D + *ng - 1) / *ng + 31) / 32 * 32;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// The arguments of a piece's two launches
struct Piece {
  const void *q, *k, *v;
  void *o, *lse;
  float *ws, *maxes;
  int B, Sq, Skv, H, KV, D, causal, window;
  float scale;
  int bh0, nbh, t0, nt, ld;
  cudaStream_t stream;
};

template <typename E, int GW>
cudaError_t launch_pv_16(const Piece& p, const CUtensorMap& ms, int ng) {
  using C = Pv16<GW>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = allow_smem(pv_16<E, GW>, C::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap mv;
  const cudaError_t err = make_map<E>(&mv, p.v, p.D, p.KV, p.Skv, p.B, C::COLS_V, kBK);
  if (err != cudaSuccess) return err;
  pv_16<E, GW><<<dim3(ng, p.nt, p.nbh), kThreads, C::SMEM, p.stream>>>(
      ms, mv, p.maxes, static_cast<E*>(p.o), static_cast<float*>(p.lse), p.Sq, p.Skv,
      p.H, p.KV, p.D, p.causal, p.window, p.bh0, p.t0, p.nt, p.ld);
  return cudaGetLastError();
}

template <typename E>
cudaError_t piece_16(const Piece& p) {
  using C = Scores16;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = allow_smem(scores_16<E>, C::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap mq, mk, ms;
  cudaError_t err = make_map<E>(&mq, p.q, p.D, p.H, p.Sq, p.B, C::SC, kRows);
  if (err == cudaSuccess) err = make_map<E>(&mk, p.k, p.D, p.KV, p.Skv, p.B, C::SC, C::BN);
  if (err == cudaSuccess)
    err = make_map_scores(&ms, p.ws, p.ld, static_cast<long long>(p.nbh) * p.nt * kRows);
  if (err != cudaSuccess) return err;
  scores_16<E><<<dim3(p.ld / C::BN, p.nt, p.nbh), kThreads, C::SMEM, p.stream>>>(
      mq, mk, p.ws, p.maxes, p.Sq, p.Skv, p.H, p.KV, p.D, p.causal, p.window, p.scale,
      p.bh0, p.t0, p.nt, p.ld);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int ng, gw;
  column_groups(p.D, &ng, &gw);
  switch (gw) {
    case 160: return launch_pv_16<E, 160>(p, ms, ng);
    case 192: return launch_pv_16<E, 192>(p, ms, ng);
    case 224: return launch_pv_16<E, 224>(p, ms, ng);
    default: return cudaErrorInvalidValue;
  }
}

template <int GW>
cudaError_t launch_pv_32(const Piece& p, const CUtensorMap& ms, int ng) {
  using C = Pv32<GW>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = allow_smem(pv_32<GW>, C::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap mv;
  const cudaError_t err = tf32::make_map_f32(&mv, p.v, p.D, p.KV, p.Skv, p.B, kBK);
  if (err != cudaSuccess) return err;
  pv_32<GW><<<dim3(ng, p.nt, p.nbh), kThreads32, C::SMEM, p.stream>>>(
      ms, mv, p.maxes, static_cast<float*>(p.o), static_cast<float*>(p.lse), p.Sq,
      p.Skv, p.H, p.KV, p.D, p.causal, p.window, p.bh0, p.t0, p.nt, p.ld);
  return cudaGetLastError();
}

inline cudaError_t piece_32(const Piece& p) {
  using C = Scores32;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = allow_smem(scores_32, C::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap mq, mk, ms;
  cudaError_t err = tf32::make_map_f32(&mq, p.q, p.D, p.H, p.Sq, p.B, kRows);
  if (err == cudaSuccess) err = tf32::make_map_f32(&mk, p.k, p.D, p.KV, p.Skv, p.B, C::BN);
  if (err == cudaSuccess)
    err = make_map_scores(&ms, p.ws, p.ld, static_cast<long long>(p.nbh) * p.nt * kRows);
  if (err != cudaSuccess) return err;
  scores_32<<<dim3(p.ld / C::BN, p.nt, p.nbh), kThreads32, C::SMEM, p.stream>>>(
      mq, mk, p.ws, p.maxes, p.Sq, p.Skv, p.H, p.KV, p.D, p.causal, p.window, p.scale,
      p.bh0, p.t0, p.nt, p.ld);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int ng, gw;
  groups32(p.D, &ng, &gw);
  switch (gw) {
    case 160: return launch_pv_32<160>(p, ms, ng);
    case 192: return launch_pv_32<192>(p, ms, ng);
    case 224: return launch_pv_32<224>(p, ms, ng);
    case 256: return launch_pv_32<256>(p, ms, ng);
    default: return cudaErrorInvalidValue;
  }
}

// registers, local bytes, static and dynamic shared bytes of a kernel
template <typename K>
cudaError_t kernel_attrs(K kernel, int smem, int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess) {
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
    out[2] = static_cast<int>(a.sharedSizeBytes);
    out[3] = smem;
  }
  return err;
}

template <typename E>
cudaError_t attrs_16(int D, int* out) {
  cudaError_t err = kernel_attrs(scores_16<E>, Scores16::SMEM, out);
  if (err != cudaSuccess) return err;
  int ng, gw;
  column_groups(D, &ng, &gw);
  switch (gw) {
    case 160: return kernel_attrs(pv_16<E, 160>, Pv16<160>::SMEM, out + 4);
    case 192: return kernel_attrs(pv_16<E, 192>, Pv16<192>::SMEM, out + 4);
    case 224: return kernel_attrs(pv_16<E, 224>, Pv16<224>::SMEM, out + 4);
    default: return cudaErrorInvalidValue;
  }
}

inline cudaError_t attrs_32(int D, int* out) {
  cudaError_t err = kernel_attrs(scores_32, Scores32::SMEM, out);
  if (err != cudaSuccess) return err;
  int ng, gw;
  groups32(D, &ng, &gw);
  switch (gw) {
    case 160: return kernel_attrs(pv_32<160>, Pv32<160>::SMEM, out + 4);
    case 192: return kernel_attrs(pv_32<192>, Pv32<192>::SMEM, out + 4);
    case 224: return kernel_attrs(pv_32<224>, Pv32<224>::SMEM, out + 4);
    case 256: return kernel_attrs(pv_32<256>, Pv32<256>::SMEM, out + 4);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace split
}  // namespace
