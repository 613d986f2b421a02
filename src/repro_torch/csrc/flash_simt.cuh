// Causal / sliding-window GQA flash attention (forward) in fp32, SIMT, for
// Hopper (sm_90a): the kernels and their launchers; the translation units
// instantiate them:
//   flash_attention.cu       head dims 4..128 (the entries
//                            flash_attention_fwd_f32 / _attrs_f32, which
//                            send head dims 129..2,048 to the 3xTF32
//                            tensor-core kernel of flash_tf32.cuh)
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// _flash_kernel (entry flash_attention_pallas) for fp32 inputs at head dims
// up to 128; bf16 goes to the tensor-core kernel of flash_attention_sm90.cu,
// fp32 past 128 to the 3xTF32 kernels of flash_tf32.cuh and, past 2,048,
// flash_split.cuh (the SIMT kernel ties SDPA up to 128). In the port it runs
// on the flash branch of models/attention.attention_forward (sequences of
// 2048 or more) for fp32 models, once per layer of a prefill.
//
// q [B, Sq, H, D], k and v [B, Skv, KV, D], fp32, contiguous; o [B, Sq, H,
// D] fp32; lse, when not null, [B, H, Sq] fp32 (the JAX package's
// [B, KV, G, Sq], h = kv G + g): the log-sum-exp of each row's scaled
// scores, m + log(max(l, 1e-30)), which the training path's backward
// (kernels/flash_attention/ref.py: flash_bwd_ref) reads. A null lse writes
// nothing, so the serve path does the work it did without it. Query head
// h reads KV head h / G (G = H / KV): no KV duplication. What it computes is the Pallas kernel's function:
//   q is multiplied by scale = 1/sqrt(D) before QK^T;
//   a masked score (k > q when causal, q - k >= window) is -1e30, not -inf;
//   m, l and the accumulator are fp32 (online softmax, one rescale per
//   tile of keys); o = acc / max(l, 1e-30).
// A row whose keys so far are all masked sums exp(0) = 1 terms, and the
// next visible key's correction exp(-1e30 - m) = 0 wipes them, as in the
// Pallas kernel; the diagonal is always visible. So key tiles wholly above
// the diagonal or wholly before the window are skipped: that changes no
// bit of the result. A row with no visible key at all (a window that ends
// before Skv) is the mean of V over all Skv keys, as in the plain version:
// its query tile walks every key tile. Keys past Skv in the ragged last
// tile are absent (zero-filled, scored -inf, so their p is 0), query rows
// past Sq are not written: any S is taken.
//
// What bounds it on an H100 SXM at the serve path's shapes in fp32 (B = 4,
// H = 32, KV = 4, S = 2048, D = 64, causal): 2*B*H*S^2*D = 6.87e10
// operations (QK^T and PV over the causal half), 1.03 ms at 67 TFLOP/s of
// fp32 on the CUDA cores; 151 MB of q, k, v and o, 0.045 ms at 3.35 TB/s.
// So the CUDA cores' FMA issue rate bounds it, and the design keeps them fed:
//
// - A CTA of 128 threads owns a 64-row query tile of one (batch, head);
//   thread (ty, tx) = (tid / 8, tid % 8) owns rows ty + 16 j (j < 4) of it.
//   Q (scaled) stays in shared memory; K and V stream through it in tiles
//   of BK keys (64 at D = 32, else 32), double-buffered: the next tile's
//   16-byte cp.async copies are in flight while this one computes. At
//   D = 32 and 64 three CTAs share an SM (at most 170 registers a thread,
//   61 KB of shared memory a CTA at D = 64), at D = 128 two. (BK = 64 at
//   D = 64, with two CTAs an SM, ran slower on an NVIDIA H100 80GB HBM3 at
//   700 W: PERF.md, row 8b's finding.)
// - S = Q K^T is a register-tiled outer product: the thread holds the 4 x
//   (BK / 8) scores of its rows and keys tx + 8 i, and for every 4 values
//   of d loads 4 + BK / 8 float4s of Q and K and issues 4 * 4 * BK / 8
//   independent fmaf: 64 FMAs a 8 loads at BK = 32, no dependency chain
//   (each score still sums d in order, 0..D-1).
// - The online softmax of a row runs on the 8 threads that share it: the
//   row max by three xor shuffles, each thread's share of l rescaled and
//   summed on its own keys, the shares added once at the end.
// - P goes to shared memory (transposed, each thread's 4 rows in one
//   float4), and O += P V is the same outer product again: a thread holds
//   the 4 x (DP / 8) accumulators of its rows and columns 4 tx + 32 c, and
//   for every key loads one float4 of P and DP / 32 of V.
// - Rows of Q, K, V and P are padded by 4 floats, so the float4 reads of a
//   warp fall on distinct banks.
// - Head dims: the kernel is compiled for DP = D rounded up to 32 (32, 64,
//   96, 128) and takes D, a multiple of 4 (whole 16-byte copies), at run
//   time (each DP also has an EXACT instance for D == DP, whose D is a
//   compile-time constant: a multiple of 32 runs the code of a kernel
//   compiled for its D); the wrapper zero-pads q, k and v of any other D to the next
//   multiple of 4 and slices o (kernels/flash_attention/ops.py). The rows
//   of K and V in shared memory hold DP columns, the 16-byte copies of
//   columns D..DP-1 zero-filled (cp.async with src-size 0). Each score sums
//   d = 0..D-1 only, in order, so the order of its sum is that of every
//   other D; O += P V runs over DP / 32 float4s a thread, the padded
//   columns of O stay zero, and only the D real ones are stored.
// - Above DP = 128 the fp32 entries take the 3xTF32 tensor-core kernel
//   (flash_tf32.cuh) up to D = 2,048; past it the split route
//   (flash_split.cuh) has an entry of its own.
// B * H is on grid x (up to 2^31 - 1), the query tiles on y (up to 65,535:
// Sq up to 4,194,240 rows at 64 a tile).
// The heavy (late) query tiles of a causal mask are scheduled first, over
// every (batch, head). Every multiply-add is an explicit fmaf (the library
// is built with --fmad=false).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;    // 16 row groups (ty) x 8 column groups (tx)
constexpr float kMasked = -1e30f;
constexpr int kMaxWidth = 256;   // the widest D of the 3xTF32 kernel's one CTA
constexpr int kMaxSimt = 128;    // the widest DP of flash_fwd_kernel
constexpr int kMaxTf32 = 2048;   // the widest D of the 3xTF32 kernel

template <int DP_>
struct Tile {
  static_assert(DP_ % 32 == 0 && DP_ <= kMaxSimt, "DP: a multiple of 32 up to 128");
  static constexpr int DP = DP_;                 // columns of K, V and O held
  static constexpr int kTM = 4;                  // query rows a thread: ty + 16 j
  static constexpr int kBQ = 16 * kTM;           // query rows a CTA
  static constexpr int BK = DP <= 32 ? 64 : 32;  // keys a tile
  static constexpr int kMinCtas = DP <= 64 ? 3 : 2;  // CTAs an SM
  static constexpr int TN = BK / 8;              // keys a thread: tx + 8 i
  static constexpr int DC = DP / 32;             // float4s of O a row: 4 tx + 32 c
  static constexpr int LD = DP + 4;              // row stride of Q, K, V (floats)
  static constexpr int LDP = kBQ + 4;            // row stride of P
  static constexpr int kQ = kBQ * LD;
  static constexpr int kKV = BK * LD;
  static constexpr int kP = BK * LDP;
  // Q, two stages of (K, V), P
  static constexpr int kBytes = (kQ + 4 * kKV + kP) * 4;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool full) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The key tile [k0, k0 + BK) of K and V into Ks and Vs: one 16-byte copy a
// (key, 4 values of d) over the DP held columns, keys past Skv and columns
// past D (a multiple of 4) zero-filled.
template <int DP>
__device__ __forceinline__ void load_kv(float* Ks, float* Vs, const float* kb,
                                        const float* vb, int k0, int Skv, int D,
                                        long long stride) {
  using T = Tile<DP>;
  constexpr int kChunks = DP / 4;
  static_assert(T::BK * kChunks % kThreads == 0, "whole copies a thread");
#pragma unroll
  for (int it = 0; it < T::BK * kChunks / kThreads; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    const int j = idx / kChunks, c = idx % kChunks;
    const bool in = k0 + j < Skv && 4 * c < D;
    const long long off = in ? (k0 + j) * stride + 4 * c : 0;
    cp_async16(Ks + j * T::LD + 4 * c, kb + off, in);
    cp_async16(Vs + j * T::LD + 4 * c, vb + off, in);
  }
}

// EXACT: D == DP, a compile-time width (the instance a multiple of 32 runs;
// its code is that of a kernel compiled for D)
template <int DP, bool EXACT>
__global__ void __launch_bounds__(kThreads, Tile<DP>::kMinCtas)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Skv, int H, int KV, int D,
                 int causal, int window, float scale) {
  if constexpr (EXACT) D = DP;
  using T = Tile<DP>;
  constexpr int BK = T::BK, TN = T::TN, DC = T::DC, LD = T::LD, LDP = T::LDP;
  constexpr int kTM = T::kTM, kBQ = T::kBQ;
  extern __shared__ __align__(16) float smem[];
  float* const Qs = smem;
  float* const KV0 = smem + T::kQ;            // stage s: K at KV0 + 2 s kKV, V after it
  float* const Ps = smem + T::kQ + 4 * T::kKV;

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // late (heavy) tiles first
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBQ;

  // the query tile, times scale; rows past Sq are zeros
  {
    const long long row_stride = static_cast<long long>(H) * D;
    const float* qb = q + (static_cast<long long>(b) * Sq * H + h) * D;
    for (int idx = tid; idx < kBQ * (D / 4); idx += kThreads) {
      const int r = idx / (D / 4), c = idx % (D / 4);
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < Sq) {
        val = *reinterpret_cast<const float4*>(qb + (q0 + r) * row_stride + 4 * c);
        val.x *= scale;
        val.y *= scale;
        val.z *= scale;
        val.w *= scale;
      }
      *reinterpret_cast<float4*>(Qs + r * LD + 4 * c) = val;
    }
  }

  // key tiles that can hold a visible key for some row of this query tile
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int k_end = Skv;
  if (causal) k_end = min(k_end, q_last + 1);
  // (all of them when some row sees no key: such a row is the mean of V
  // over every key, as in the plain version)
  int k_begin = 0;
  if (window > 0 && q_last < Skv - 1 + window) k_begin = max(0, q0 - window + 1);
  k_begin = (k_begin / BK) * BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  const long long kv_stride = static_cast<long long>(KV) * D;
  const float* kb = k + (static_cast<long long>(b) * Skv * KV + kvh) * D;
  const float* vb = v + (static_cast<long long>(b) * Skv * KV + kvh) * D;

  float acc[kTM][4 * DC];
  float m[kTM], l[kTM];
#pragma unroll
  for (int j = 0; j < kTM; ++j) {
    m[j] = kMasked;
    l[j] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * DC; ++c) acc[j][c] = 0.f;
  }

  if (n_tiles > 0) load_kv<DP>(KV0, KV0 + T::kKV, kb, vb, k_begin, Skv, D, kv_stride);
  cp_async_commit();

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * BK;
    const float* Ks = KV0 + (t & 1) * 2 * T::kKV;
    const float* Vs = Ks + T::kKV;
    if (t + 1 < n_tiles) {
      float* Kn = KV0 + ((t + 1) & 1) * 2 * T::kKV;
      load_kv<DP>(Kn, Kn + T::kKV, kb, vb, k0 + BK, Skv, D, kv_stride);
    }
    cp_async_commit();     // an empty group on the last tile
    cp_async_wait_one();   // this tile's copies (this thread's) have landed
    __syncthreads();       // ... every thread's, and Q on the first tile

    // S = (q scale) K^T: a kTM x TN micro-tile, d in order
    float s[kTM][TN];
#pragma unroll
    for (int j = 0; j < kTM; ++j)
#pragma unroll
      for (int i = 0; i < TN; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int d = 0; d < DP; d += 4) {
      if (d >= D) break;                  // the held columns past D are zeros
      float4 qv[kTM], kv[TN];
#pragma unroll
      for (int j = 0; j < kTM; ++j)
        qv[j] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < TN; ++i)
        kv[i] = *reinterpret_cast<const float4*>(Ks + (tx + 8 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < kTM; ++j)
#pragma unroll
        for (int i = 0; i < TN; ++i) {
          s[j][i] = fmaf(qv[j].x, kv[i].x, s[j][i]);
          s[j][i] = fmaf(qv[j].y, kv[i].y, s[j][i]);
          s[j][i] = fmaf(qv[j].z, kv[i].z, s[j][i]);
          s[j][i] = fmaf(qv[j].w, kv[i].w, s[j][i]);
        }
    }

    // masks (a tile whose keys are all present and visible to every row of
    // the CTA needs none), then the online softmax of each row over its 8
    // threads
    const bool masked = k0 + BK > Skv || (causal && k0 + BK - 1 > q0) ||
                        (window > 0 && q_last - k0 >= window);
    if (masked) {
#pragma unroll
      for (int j = 0; j < kTM; ++j) {
        const int row = q0 + ty + 16 * j;
#pragma unroll
        for (int i = 0; i < TN; ++i) {
          const int key = k0 + tx + 8 * i;
          if (key >= Skv) {
            s[j][i] = -INFINITY;
          } else if ((causal && key > row) || (window > 0 && row - key >= window)) {
            s[j][i] = kMasked;
          }
        }
      }
    }
    float corr[kTM];
#pragma unroll
    for (int j = 0; j < kTM; ++j) {
      float mx = m[j];
#pragma unroll
      for (int i = 0; i < TN; ++i) mx = fmaxf(mx, s[j][i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      corr[j] = expf(m[j] - mx);
      m[j] = mx;
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < TN; ++i) {
        const float p = expf(s[j][i] - mx);
        s[j][i] = p;
        sum += p;
      }
      l[j] = l[j] * corr[j] + sum;
    }
    // P transposed: key i's 4 rows in one float4
#pragma unroll
    for (int i = 0; i < TN; ++i)
      *reinterpret_cast<float4*>(Ps + (tx + 8 * i) * LDP + 4 * ty) =
          make_float4(s[0][i], s[1][i], s[2][i], s[3][i]);
#pragma unroll
    for (int j = 0; j < kTM; ++j)
#pragma unroll
      for (int c = 0; c < 4 * DC; ++c) acc[j][c] *= corr[j];
    __syncthreads();

    // O += P V: a kTM x 4 DC micro-tile, keys in order (past Skv p = 0, V = 0)
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(Ps + kk * LDP + 4 * ty);
      const float p[kTM] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(Vs + kk * LD + 4 * tx + 32 * c);
#pragma unroll
        for (int j = 0; j < kTM; ++j) {
          acc[j][4 * c] = fmaf(p[j], vv.x, acc[j][4 * c]);
          acc[j][4 * c + 1] = fmaf(p[j], vv.y, acc[j][4 * c + 1]);
          acc[j][4 * c + 2] = fmaf(p[j], vv.z, acc[j][4 * c + 2]);
          acc[j][4 * c + 3] = fmaf(p[j], vv.w, acc[j][4 * c + 3]);
        }
      }
    }
    __syncthreads();       // P and this stage are free for the next tile
  }

#pragma unroll
  for (int j = 0; j < kTM; ++j) {
    float lt = l[j];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt += __shfl_xor_sync(0xffffffffu, lt, 4);
    const int row = q0 + ty + 16 * j;
    if (row < Sq) {
      const float l_safe = fmaxf(lt, 1e-30f);
      float* op = o + ((static_cast<long long>(b) * Sq + row) * H + h) * D;
#pragma unroll
      for (int c = 0; c < DC; ++c)
        if (4 * tx + 32 * c < D)   // a real column (D is a multiple of 4)
          *reinterpret_cast<float4*>(op + 4 * tx + 32 * c) =
              make_float4(acc[j][4 * c] / l_safe, acc[j][4 * c + 1] / l_safe,
                          acc[j][4 * c + 2] / l_safe, acc[j][4 * c + 3] / l_safe);
      // m is in units of the scaled scores (q was scaled before QK^T)
      if (lse != nullptr && tx == 0)
        lse[(static_cast<long long>(b) * H + h) * Sq + row] = m[j] + logf(l_safe);
    }
  }
}

template <int DP, bool EXACT>
cudaError_t launch_instance(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int Sq, int Skv, int H,
                            int KV, int D, int causal, int window, float scale,
                            cudaStream_t stream) {
  using T = Tile<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DP, EXACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + T::kBQ - 1) / T::kBQ);
  flash_fwd_kernel<DP, EXACT><<<grid, kThreads, T::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), Sq, Skv, H, KV, D, causal, window, scale);
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
      ? cudaFuncGetAttributes(&a, flash_fwd_kernel<DP, true>)
      : cudaFuncGetAttributes(&a, flash_fwd_kernel<DP, false>);
  if (err == cudaSuccess) {
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
    out[2] = static_cast<int>(a.sharedSizeBytes);
    out[3] = Tile<DP>::kBytes;
    out[4] = 1;      // no cluster
    out[5] = 0;
  }
  return err;
}

}  // namespace
