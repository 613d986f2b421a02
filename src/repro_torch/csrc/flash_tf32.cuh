// Causal / sliding-window GQA flash attention (forward) in fp32 on Hopper's
// tensor cores in 3xTF32 (sm_90a): the kernel and its launchers; the
// translation units instantiate them:
//   flash_attention_tf32.cu       computed widths DP = 160, 192, 224, 256
//                                 (one CTA a query tile)
//   flash_attention_tf32_wide.cu  head dims 257..2,048 (a thread-block
//                                 cluster of one CTA a column group)
// Both are reached through the fp32 entries of flash_attention.cu, which
// keeps DP <= 128 on the SIMT kernel (flash_simt.cuh); past 2,048 the split
// route (flash_split.cuh) runs this header's split and mma_tf32 in a scores
// kernel and a P V kernel.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// _flash_kernel (entry flash_attention_pallas) for fp32 inputs at these
// head dims. In the port it runs on the flash branch of
// models/attention.attention_forward for fp32 models with head_dim past 128
// (Gemma's 256, and any ModelConfig(head_dim=...) up to 2,048).
//
// What it computes is the SIMT kernel's function (flash_simt.cuh: q times
// scale = 1/sqrt(D) in fp32 before QK^T, masked scores -1e30, keys past Skv
// -inf, fp32 m, l and O, one rescale a key tile, o = O / max(l, 1e-30), lse
// = m + log(max(l, 1e-30)) when lse is not null), with the products on the
// tensor cores: mma.sync.m16n8k8 .tf32 with fp32 accumulators. Each fp32
// operand x is split in registers into hi = x with its low 13 bits cleared
// and lo = x - hi (exact in fp32, |lo| < 2^-10 |x|), and each product is
// taken as lo_a hi_b + hi_a lo_b + hi_a hi_b (3xTF32), chained in that
// order on one accumulator for every 8 values of the summed index; lo_a lo_b
// (below 2^-20 of the product) is dropped. hi is cleared explicitly, so the
// result does not rest on how the tensor core treats an operand's low 13
// bits (it reads lo through its top 19 bits).
// The tensor core rounds each mma's sum toward zero, so a long chain of
// them on one accumulator drifts: one chain over D = 256 put the output
// 5.8e-6 from softmax attention in float64 on an NVIDIA H100 80GB HBM3 at
// 700 W (the plain version 1.9e-6; scripts/flash_probe.py), and one over
// D = 1,024 2.7e-5 in the CPU model. So each score's chain runs over one
// 32-column box (12 mma) into a fresh accumulator, and the boxes are added
// on the CUDA cores (round to nearest); likewise P V takes each key tile's
// 12 mma for 8 columns of O on a fresh accumulator and adds it to O (12 mma
// a tile onto the running O drifted with the sequence: a smoke model's
// fp32 logits at 2,048 tokens and D = 256 moved 2.7e-5 from the CPU's).
// The CPU model (tests/torch_flash_models.py: tf32_model, each mma rounded
// toward zero) puts it 1.5e-6 to 3e-6 from float64 at D = 160 to 2,048;
// the gate is fp32's 1e-5.
//
// What bounds it on an H100 SXM at Gemma-7B's call ([2, 2048, 16 | 16, 256],
// causal): 2 * 2 * B * H * D * S(S+1)/2 = 6.88e10 operations: 1.026 ms on
// the CUDA cores' 67 TFLOP/s of fp32, 0.417 ms in 3xTF32 (3 products each at
// the tensor cores' 495 TFLOP/s of TF32); 50 MB of q, k, v and o, 0.015 ms at
// 3.35 TB/s. So the products bound it, and the design feeds the tensor cores:
//   * a CTA of 8 warps owns a 128-row query tile of one (batch, head), warp
//     w its rows 16 w .. 16 w + 15 (one m16 tile: O's DP / 2 accumulators a
//     thread, 128 at DP = 256); Q is loaded once by TMA and scaled once in
//     shared memory; K and V stream in tiles of 32 keys, one slot each: the
//     next K tile is loaded while the softmax and P V of this one run, the
//     next V tile while the next QK^T runs. A thread issues the TMA loads
//     right after the barrier that frees a slot (no producer warp: in a
//     cluster every thread of every CTA takes part in the cluster barrier);
//   * the TMA boxes are 32 columns of fp32 (128-byte rows) under the
//     128-byte swizzle, so every fragment load (a thread's LDS.32 of Q, K or
//     V) is free of bank conflicts: Q's and K's rows g = lane / 4 read 16-byte
//     units u ^ g; V's keys are taken in the order 2 t, 2 t + 1 (t = lane %
//     4) for the k-step's columns t, t + 4, which is P's own accumulator
//     layout, so P needs no shuffle and V's reads fall on units u ^ 2t;
//   * S = Q K^T: per 8 columns of D a thread loads Q's A fragment once and
//     K's B fragment per 8 keys, splits both and issues 3 mma a key group,
//     on a fresh accumulator a 32-column box; O += P V: P split in
//     registers, V's B fragment per 8 keys and 8 columns of O, each 8
//     columns' tile sum on a fresh accumulator;
//   * row max and row sum are shuffles across the four threads of a row; the
//     mask is applied only on tiles that cross the diagonal, the window edge
//     or Skv; a warp skips the key tiles wholly above its diagonal or before
//     its window (none when some row of the CTA sees no key: that row is the
//     mean of V over every key, as in the plain version);
//   * the heavy (late) causal query tiles are launched first; the grid is
//     (B * H, ceil(Sq / 128), NG).
// Past D = 256 (CLUSTER): O is cut into NG = ceil(D / 256) column groups of
// GW columns (ops.column_groups: 160, 192, 224 or 256), one CTA a group, the
// NG CTAs of a query tile one thread-block cluster (grid z, cluster (1, 1,
// NG), NG <= 8). CTA g holds Q's and K's columns of its own group only, and
// computes the partial scores over them; the partial tiles are exchanged
// through distributed shared memory (each CTA writes its own to a double
// buffer, a cluster barrier, then every CTA reads the NG partials and sums
// them in the fixed order g = 0, 1, ...). So S is computed once, every
// CTA holds the same S, m, l and P bit for bit, and group 0 alone writes
// lse. Q's slice is read once and scaled once; each of the 32 x 32 partial
// tiles crosses the cluster NG - 1 times a CTA. Past 2,048 (NG > 8, the
// portable cluster size) the split route takes over (flash_split.cuh).
// Shared memory a CTA: Q 512 * GW bytes, K and V tiles 128 * GW each, in a
// cluster two 16 KB partial tiles: 192 KB at DP = 256, 224 KB in a cluster
// of GW = 256; one CTA an SM.
// Why mma.sync and not wgmma: wgmma would read B from shared memory once a
// warpgroup instead of once a warp, but its tf32 operands must be K-major,
// so P V needs V transposed, and the hi and lo parts of K and of V^T do not
// fit beside a resident Q tile at DP >= 224 (227 KB). QK^T alone on wgmma
// (K split once a tile into hi and lo in shared memory, Q's A fragments
// split in registers, 12 wgmma m64n32k8 a 32-column box on a fresh
// accumulator) ran Gemma-7B's call in 1.76-1.77 ms against this kernel's
// 1.59 and D = 160 in 1.30 against 1.04 (spilling 304 bytes), on an NVIDIA
// H100 80GB HBM3 at 700 W, A B B A in one call (scripts/flash_probe.py):
// each box waits on its wgmma group with no registers left to load the next
// box's fragments meanwhile. Left for later: that pipelining, and overlapping
// the cluster exchange with the next tile's products.
#pragma once

#include "flash_sm90.cuh"   // mbarrier, TMA and cluster wrappers, key_range,
                            // encode_tiled

// the cluster instances (flash_attention_tf32_wide.cu): 256 < D <= 2,048
extern "C" int flash_tf32_wide_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int Sq, int Skv,
                                   int H, int KV, int D, int causal, int window,
                                   float scale, void* stream);
extern "C" int flash_tf32_wide_attrs(int D, int* out);

namespace {
namespace tf32 {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int BQ = 16 * kWarps;           // query rows a CTA (flash_sm90's kRows)
constexpr int BK = 32;                    // keys a tile
constexpr int kRowBytes = 128;            // a box row: 32 fp32 columns
constexpr int kMaxGroup = 256;            // the widest O a CTA holds
constexpr int kMaxWideDim = kMaxGroup * kMaxCluster;   // 2,048
constexpr float kMasked = -1e30f;
static_assert(BQ == kRows, "key_range takes flash_sm90's 128-row query tiles");

template <int GW_, bool CLUSTER_>
struct Cfg {
  static_assert(GW_ % 32 == 0 && GW_ >= 160 && GW_ <= kMaxGroup,
                "GW: a multiple of 32 in 160..256");
  static constexpr int GW = GW_;
  static constexpr bool CLUSTER = CLUSTER_;
  static constexpr int NCH = GW / 32;                  // 32-column boxes a row
  static constexpr int Q_BYTES = NCH * BQ * kRowBytes;
  static constexpr int KV_BYTES = NCH * BK * kRowBytes;
  static constexpr int X_BYTES = BQ * BK * 4;          // a partial score tile
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + KV_BYTES;
  static constexpr int X_OFF = V_OFF + KV_BYTES;
  static constexpr int TILE_BYTES = X_OFF + (CLUSTER ? 2 * X_BYTES : 0);
  static constexpr int SMEM = 1024 + TILE_BYTES + 8 * 3;   // + alignment, 3 bars
};

// ---- PTX wrappers ---------------------------------------------------------
// d += a * b, m16n8k8, tf32 operands (a: 4 registers, b: 2), fp32 accumulators
__device__ __forceinline__ void mma_tf32(float& d0, float& d1, float& d2, float& d3,
                                         uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// x = hi + lo: hi is x with its low 13 bits cleared (a TF32 pattern), lo the
// exact rest. (Rounding hi to nearest with cvt.rna.tf32.f32 took Gemma-7B's
// call from 1.76 to 2.15 ms on an NVIDIA H100 80GB HBM3 at 700 W: a
// conversion runs at a quarter of the integer rate.)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// ---- the kernel -------------------------------------------------------------
// Group blockIdx.z of O (columns c0 = z GW ..); CLUSTER: the grid's z is one
// cluster of gridDim.z CTAs, whose partial scores are summed.
template <int GW, bool CLUSTER>
__global__ void __launch_bounds__(kThreads, 1)
flash_tf32_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  float* __restrict__ o, float* __restrict__ lse, int Sq,
                  int Skv, int H, int KV, int D, int causal, int window,
                  float scale) {
  using C = Cfg<GW, CLUSTER>;
  extern __shared__ uint8_t tf32_smem[];
  const uint32_t raw = smem_u32(tf32_smem);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;   // swizzle atoms: 1024 B
  uint8_t* const sm = tf32_smem + pad;
  const uint32_t base = raw + pad;
  const uint32_t q_full = base + C::TILE_BYTES;
  const uint32_t k_full = q_full + 8, v_full = q_full + 16;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // late tiles first
  const int g = blockIdx.z, ng = gridDim.z;
  const int c0 = g * GW;
  const int dv = min(GW, D - c0);          // the group's real columns (> 0)
  const int nch = (dv + 31) / 32;          // boxes loaded: columns < D
  const KeyRange kr = key_range(q0, Sq, Skv, causal, window, BK);
  const int k_begin = kr.k_begin, n_tiles = kr.n_tiles;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;

  auto load_kv = [&](const CUtensorMap* map, int off, uint32_t bar, int k0) {
    mbar_expect_tx(bar, nch * BK * kRowBytes);
    for (int c = 0; c < nch; ++c)
      tma_load_4d(base + off + c * BK * kRowBytes, map, bar, c0 + 32 * c, kvh, k0, b);
  };

  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(k_full, 1);
    mbar_init(v_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_full, nch * BQ * kRowBytes);
    for (int c = 0; c < nch; ++c)
      tma_load_4d(base + C::Q_OFF + c * BQ * kRowBytes, &tm_q, q_full, c0 + 32 * c,
                  h, q0, b);
    if (n_tiles > 0) {
      load_kv(&tm_k, C::K_OFF, k_full, k_begin);
      load_kv(&tm_v, C::V_OFF, v_full, k_begin);
    }
  }

  // Q's slice times scale, once (rows past Sq and columns past D are zeros)
  mbar_wait(q_full, 0);
  for (int i = tid; i < nch * BQ * 8; i += kThreads) {
    float4* p = reinterpret_cast<float4*>(sm + C::Q_OFF) + i;
    float4 x = *p;
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    *p = x;
  }
  __syncthreads();

  const int r_lo = q0 + 16 * warp, r_hi = r_lo + 15;   // the warp's rows
  const int row0 = r_lo + gq, row1 = row0 + 8;         // this thread's rows
  const bool dead = r_lo >= Sq;
  // fragment bases (bytes from sm): Q's rows 16 w + g (+8) and K's keys 8 j +
  // g at column 8 kk + t (+4) of box kk / 4, unit (2 (kk % 4) (+1)) ^ g; V's
  // keys 8 j + 2 t (+1) at column 8 n + g of box n / 4, unit
  // (2 (n % 4) + g / 4) ^ (2 t (+1))
  const int q_frag = C::Q_OFF + (16 * warp + gq) * kRowBytes + 4 * tq;
  const int k_frag = C::K_OFF + gq * kRowBytes + 4 * tq;
  const int v_frag = C::V_OFF + 2 * tq * kRowBytes + 4 * (gq & 3);
  auto swz = [&](int u) { return (u ^ gq) << 4; };
  auto swz_v = [&](int n4, int e) { return ((2 * n4 + (gq >> 2)) ^ (2 * tq + e)) << 4; };
  auto lds = [&](int off) { return *reinterpret_cast<const float*>(sm + off); };

  float acc[GW / 8][4];
#pragma unroll
  for (int n = 0; n < GW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * BK;
    const bool skip = dead || (!kr.orphans && ((causal && k0 > r_hi) ||
                      (window > 0 && k0 + BK - 1 < r_lo - window + 1)));
    // S (this group's part) = (q scale) K^T: rows g, g + 8 in sc[4 j + 0..1],
    // sc[4 j + 2..3], keys k0 + 8 j + 2 t (+1)
    float sc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] = 0.f;
    mbar_wait(k_full, t & 1);
    __syncwarp();          // mma.sync and barrier.cluster are .aligned
    if (!skip) {
#pragma unroll
      for (int box = 0; box < GW / 32; ++box) {
        if (32 * box >= dv) break;               // zeros past D
        // this box's 32 columns: 4 steps of 8, 12 mma a key group on a fresh
        // accumulator (the tensor core rounds toward zero), then added
        float bs[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) bs[i] = 0.f;
        const int qb = q_frag + box * BQ * kRowBytes;
        const int kb = k_frag + box * BK * kRowBytes;
#pragma unroll
        for (int kq = 0; kq < 4; ++kq) {
          if (32 * box + 8 * kq >= dv) break;
          const int u = 2 * kq;
          uint32_t ah[4], al[4];
          split(lds(qb + swz(u)), ah[0], al[0]);
          split(lds(qb + 8 * kRowBytes + swz(u)), ah[1], al[1]);
          split(lds(qb + swz(u + 1)), ah[2], al[2]);
          split(lds(qb + 8 * kRowBytes + swz(u + 1)), ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
            uint32_t bh0, bl0, bh1, bl1;
            split(lds(kb + 8 * j * kRowBytes + swz(u)), bh0, bl0);
            split(lds(kb + 8 * j * kRowBytes + swz(u + 1)), bh1, bl1);
            float* s4 = bs + 4 * j;
            mma_tf32(s4[0], s4[1], s4[2], s4[3], al[0], al[1], al[2], al[3], bh0, bh1);
            mma_tf32(s4[0], s4[1], s4[2], s4[3], ah[0], ah[1], ah[2], ah[3], bl0, bl1);
            mma_tf32(s4[0], s4[1], s4[2], s4[3], ah[0], ah[1], ah[2], ah[3], bh0, bh1);
          }
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) sc[i] += bs[i];
      }
      if constexpr (CLUSTER) {
        // this group's partial tile, in the registers' own order
        float4* x = reinterpret_cast<float4*>(sm + C::X_OFF + (t & 1) * C::X_BYTES);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          x[j * kThreads + tid] = make_float4(sc[4 * j], sc[4 * j + 1],
                                              sc[4 * j + 2], sc[4 * j + 3]);
      }
    }
    // every warp is done with the K tile (in a cluster: every CTA's partial
    // tile is written), so its slot takes the next one
    if constexpr (CLUSTER) cluster_sync(); else __syncthreads();
    if (tid == 0 && t + 1 < n_tiles) load_kv(&tm_k, C::K_OFF, k_full, k0 + BK);

    if (!skip) {
      if constexpr (CLUSTER) {
        // S = the partials of groups 0, 1, ..., ng - 1, summed in that order
        const uint32_t xa = base + C::X_OFF + (t & 1) * C::X_BYTES + 16 * tid;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float4 s = ld_cluster_f4(peer_addr(xa + 16 * j * kThreads, 0));
          for (int r = 1; r < ng; ++r) {
            const float4 p = ld_cluster_f4(peer_addr(xa + 16 * j * kThreads, r));
            s.x += p.x;
            s.y += p.y;
            s.z += p.z;
            s.w += p.w;
          }
          sc[4 * j] = s.x;
          sc[4 * j + 1] = s.y;
          sc[4 * j + 2] = s.z;
          sc[4 * j + 3] = s.w;
        }
      }
      // masks, then the online softmax of rows row0 and row1 over the four
      // threads of each
      const bool need_mask = k0 + BK > Skv || (causal && k0 + BK - 1 > r_lo) ||
                             (window > 0 && r_hi - k0 >= window);
      if (need_mask) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = e < 2 ? row0 : row1;
            const int key = k0 + 8 * j + 2 * tq + (e & 1);
            if (key >= Skv) {
              sc[4 * j + e] = -INFINITY;
            } else if ((causal && key > row) || (window > 0 && row - key >= window)) {
              sc[4 * j + e] = kMasked;
            }
          }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float corr0 = expf(m0 - mx0), corr1 = expf(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[4 * j] = expf(sc[4 * j] - m0);
        sum0 += sc[4 * j];
        sc[4 * j + 1] = expf(sc[4 * j + 1] - m0);
        sum0 += sc[4 * j + 1];
        sc[4 * j + 2] = expf(sc[4 * j + 2] - m1);
        sum1 += sc[4 * j + 2];
        sc[4 * j + 3] = expf(sc[4 * j + 3] - m1);
        sum1 += sc[4 * j + 3];
      }
      l0 = l0 * corr0 + sum0;
      l1 = l1 * corr1 + sum1;
#pragma unroll
      for (int n = 0; n < GW / 8; ++n) {
        acc[n][0] *= corr0;
        acc[n][1] *= corr0;
        acc[n][2] *= corr1;
        acc[n][3] *= corr1;
      }
    }

    // O += P V over the group's columns: P's keys 8 j + 2 t, 8 j + 2 t + 1
    // are the k-step's columns t, t + 4
    mbar_wait(v_full, t & 1);
    __syncwarp();
    if (!skip) {
      // P's A fragments, key group j: registers 4 j .. 4 j + 3
      uint32_t ph[16], pl[16];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split(sc[4 * j], ph[4 * j], pl[4 * j]);
        split(sc[4 * j + 2], ph[4 * j + 1], pl[4 * j + 1]);
        split(sc[4 * j + 1], ph[4 * j + 2], pl[4 * j + 2]);
        split(sc[4 * j + 3], ph[4 * j + 3], pl[4 * j + 3]);
      }
      // 8 columns of O at a time: the tile's 32 keys (12 mma) on a fresh
      // accumulator, then added to O (the tensor core rounds toward zero)
#pragma unroll
      for (int n = 0; n < GW / 8; ++n) {
        if (8 * n >= dv) break;                 // columns past D: not stored
        const int vn = v_frag + (n >> 2) * BK * kRowBytes;
        float t4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int vj = vn + 8 * j * kRowBytes;
          uint32_t bh0, bl0, bh1, bl1;
          split(lds(vj + swz_v(n & 3, 0)), bh0, bl0);
          split(lds(vj + kRowBytes + swz_v(n & 3, 1)), bh1, bl1);
          const uint32_t* h = ph + 4 * j;
          const uint32_t* l = pl + 4 * j;
          mma_tf32(t4[0], t4[1], t4[2], t4[3], l[0], l[1], l[2], l[3], bh0, bh1);
          mma_tf32(t4[0], t4[1], t4[2], t4[3], h[0], h[1], h[2], h[3], bl0, bl1);
          mma_tf32(t4[0], t4[1], t4[2], t4[3], h[0], h[1], h[2], h[3], bh0, bh1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += t4[e];
      }
    }
    __syncthreads();       // every warp is done with the V tile
    if (tid == 0 && t + 1 < n_tiles) load_kv(&tm_v, C::V_OFF, v_full, k0 + BK);
  }
  // no CTA leaves while a peer may still read its partial tiles
  if constexpr (CLUSTER) cluster_sync();

  // epilogue: full row sums, divide, store rows < Sq and the real columns
  // (8 n + 2 t + 1 < dv iff 8 n + 2 t < dv: D is a multiple of 4)
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const long long row_stride = static_cast<long long>(H) * D;
  float* ob = o + (static_cast<long long>(b) * Sq * H + h) * D + c0;
#pragma unroll
  for (int n = 0; n < GW / 8; ++n) {
    const int col = 8 * n + 2 * tq;
    if (col >= dv) break;
    if (row0 < Sq)
      *reinterpret_cast<float2*>(ob + row0 * row_stride + col) =
          make_float2(acc[n][0] / d0, acc[n][1] / d0);
    if (row1 < Sq)
      *reinterpret_cast<float2*>(ob + row1 * row_stride + col) =
          make_float2(acc[n][2] / d1, acc[n][3] / d1);
  }
  // m is in units of the scaled scores (q was scaled before QK^T)
  if (lse != nullptr && g == 0 && tq == 0) {
    float* lb = lse + (static_cast<long long>(b) * H + h) * Sq;
    if (row0 < Sq) lb[row0] = m0 + logf(d0);
    if (row1 < Sq) lb[row1] = m1 + logf(d1);
  }
}

// ---- host side ------------------------------------------------------------
// A 4-D map over (D, heads, S, B) of a contiguous fp32 [B, S, heads, D]
// tensor, box (32, 1, rows, 1) under the 128-byte swizzle; boxes past column
// D or row S are zero-filled.
inline cudaError_t make_map_f32(CUtensorMap* map, const void* ptr, int D, int heads,
                                int S, int B, int rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(D) * 4;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {32, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr),
                   dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// One launch: ng column groups of GW (ng == 1 without a cluster)
template <int GW, bool CLUSTER>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   int B, int Sq, int Skv, int H, int KV, int D, int ng, int causal,
                   int window, float scale, cudaStream_t stream) {
  using C = Cfg<GW, CLUSTER>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_tf32_kernel<GW, CLUSTER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_map_f32(&mq, q, D, H, Sq, B, BQ);
  if (err == cudaSuccess) err = make_map_f32(&mk, k, D, KV, Skv, B, BK);
  if (err == cudaSuccess) err = make_map_f32(&mv, v, D, KV, Skv, B, BK);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H, (Sq + BQ - 1) / BQ, ng);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = CLUSTER ? ng : 1;
  cfg.attrs = attr;
  cfg.numAttrs = CLUSTER ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, flash_tf32_kernel<GW, CLUSTER>, mq, mk, mv,
                           static_cast<float*>(o), static_cast<float*>(lse), Sq,
                           Skv, H, KV, D, causal, window, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// registers, local bytes, static and dynamic shared bytes, the cluster size
// (1: none) and, for a cluster, how many such clusters the card holds at once
template <int GW, bool CLUSTER>
cudaError_t attrs(int ng, int* out) {
  using C = Cfg<GW, CLUSTER>;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, flash_tf32_kernel<GW, CLUSTER>);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = C::SMEM;
  out[4] = CLUSTER ? ng : 1;
  out[5] = 0;
  if (CLUSTER) {
    err = cudaFuncSetAttribute(flash_tf32_kernel<GW, CLUSTER>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(1, 1, ng);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = C::SMEM;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = ng;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, flash_tf32_kernel<GW, CLUSTER>, &cfg);
    out[5] = clusters;
  }
  return err;
}

}  // namespace tf32
}  // namespace
