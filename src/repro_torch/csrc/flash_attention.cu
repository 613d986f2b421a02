// Causal / sliding-window GQA flash attention (forward) in fp32, SIMT, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// _flash_kernel (entry flash_attention_pallas) for fp32 inputs; bf16 goes
// to the tensor-core kernel of flash_attention_sm90.cu (wgmma takes no
// fp32 operands, and TF32 would not hold fp32's 1e-5). In the port it runs
// on the flash branch of models/attention.attention_forward (sequences of
// 2048 or more) for fp32 models, once per layer of a prefill.
//
// q [B, Sq, H, D], k and v [B, Skv, KV, D], fp32, contiguous; o [B, Sq, H,
// D] fp32. Query head h reads KV head h / G (G = H / KV): no KV
// duplication. What it computes is the Pallas kernel's function:
//   q is multiplied by scale = 1/sqrt(D) before QK^T;
//   a masked score (k > q when causal, q - k >= window) is -1e30, not -inf;
//   m, l and the accumulator are fp32 (online softmax, one rescale per
//   chunk of keys); o = acc / max(l, 1e-30).
// A row whose keys so far are all masked sums exp(0) = 1 terms, and the
// next visible key's correction exp(-1e30 - m) = 0 wipes them, as in the
// Pallas kernel; the diagonal is always visible. So key tiles wholly above
// the diagonal or wholly before the window are skipped: that changes no
// bit of the result. A row with no visible key at all (a window that ends
// before Skv) is the mean of V over all Skv keys, as in the plain version:
// its query tile walks every key tile. Keys past Skv in the ragged last tile are absent (never
// read), query rows past Sq are not written: any S is taken.
//
// Design (simple first): one CTA of 64 threads owns a 64-row query tile of
// one (batch, head); each thread owns one query row, its scaled q and its
// fp32 accumulator in registers. K and V are streamed through shared
// memory in tiles of BK rows; each thread walks the tile in chunks of 16
// keys: 16 scalar dot products, one max and one rescale, then 16 fused
// multiply-adds of p into the accumulator (explicit fmaf: the library is
// built with --fmad=false). The heavy (late) query tiles of a causal mask
// are scheduled first.
//
// What bounds it on an H100 SXM at the serve path's shapes in fp32 (B = 4,
// H = 32, KV = 4, S = 2048, D = 64, causal): 2*B*H*S^2*D = 6.87e10
// operations (QK^T and PV over the causal half), 1.03 ms at 67 TFLOP/s of
// fp32 on the CUDA cores; 151 MB of q, k, v and o, 0.045 ms at 3.35 TB/s.
// So it is bound by operations, and it does them as scalar FMAs; D = 128
// keeps 2 x 128 fp32 values a thread in registers and spills.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // query rows per CTA = threads per CTA
constexpr int kChunk = 16;     // keys per online-softmax rescale
constexpr float kNegInf = -1e30f;

template <int D>
__global__ void __launch_bounds__(kRows)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq, int Skv,
                 int H, int KV, int causal, int window, float scale) {
  constexpr int BK = D <= 64 ? 64 : 32;  // keys per shared tile: 32 KB of fp32
  __shared__ __align__(16) float Ks[BK][D];
  __shared__ __align__(16) float Vs[BK][D];

  const int tid = threadIdx.x;
  const int n_qt = gridDim.x;
  const int qt = n_qt - 1 - blockIdx.x;  // late (heavy) tiles first
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kRows;
  const int row = q0 + tid;
  const bool active = row < Sq;

  float qr[D], acc[D];
  if (active) {
    const float* qp = q + ((static_cast<long long>(b) * Sq + row) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) qr[d] = qp[d] * scale;
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = kNegInf, l = 0.f;

  // key tiles that can hold a visible key for some row of this query tile
  const int q_last = min(q0 + kRows, Sq) - 1;
  int k_end = Skv;
  if (causal) k_end = min(k_end, q_last + 1);
  // (all of them when some row sees no key: such a row is the mean of V
  // over every key, as in the plain version)
  int k_begin = 0;
  if (window > 0 && q_last < Skv - 1 + window) k_begin = max(0, q0 - window + 1);
  k_begin = (k_begin / BK) * BK;

  const long long kv_row_stride = static_cast<long long>(KV) * D;
  const float* kb = k + (static_cast<long long>(b) * Skv * KV + kvh) * D;
  const float* vb = v + (static_cast<long long>(b) * Skv * KV + kvh) * D;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    const int kn = min(BK, Skv - k0);
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < kn * D; i += kRows) {
      const int j = i / D, d = i % D;
      const long long off = (k0 + j) * kv_row_stride + d;
      Ks[j][d] = kb[off];
      Vs[j][d] = vb[off];
    }
    __syncthreads();
    if (!active) continue;
    for (int c = 0; c < kn; c += kChunk) {
      float s[kChunk];
      float m_new = m;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = c + jj;
        if (j < kn) {
          const float4* kr = reinterpret_cast<const float4*>(Ks[j]);
          float dot = 0.f;
#pragma unroll
          for (int d4 = 0; d4 < D / 4; ++d4) {
            const float4 kk = kr[d4];   // the same address in every thread
            dot = fmaf(qr[4 * d4], kk.x, dot);
            dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
            dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
            dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
          }
          const int kpos = k0 + j;
          bool visible = true;
          if (causal) visible = visible && kpos <= row;
          if (window > 0) visible = visible && row - kpos < window;
          s[jj] = visible ? dot : kNegInf;
          m_new = fmaxf(m_new, s[jj]);
        }
      }
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = c + jj;
        if (j < kn) {
          const float p = expf(s[jj] - m_new);
          l += p;
          const float4* vr = reinterpret_cast<const float4*>(Vs[j]);
#pragma unroll
          for (int d4 = 0; d4 < D / 4; ++d4) {
            const float4 vv = vr[d4];
            acc[4 * d4] = fmaf(p, vv.x, acc[4 * d4]);
            acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
            acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
            acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
          }
        }
      }
      m = m_new;
    }
  }

  if (active) {
    const float l_safe = fmaxf(l, 1e-30f);
    float* op = o + ((static_cast<long long>(b) * Sq + row) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) op[d] = acc[d] / l_safe;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Skv, int H, int KV, int causal, int window,
                   float scale, cudaStream_t stream) {
  dim3 grid((Sq + kRows - 1) / kRows, B * H);
  flash_fwd_kernel<D><<<grid, kRows, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, H, KV,
      causal, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t attrs(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, flash_fwd_kernel<D>);
  if (err == cudaSuccess) {
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
    out[2] = static_cast<int>(a.sharedSizeBytes);
    out[3] = 0;
  }
  return err;
}

}  // namespace

// The compiled instance's registers a thread, local (spill) bytes a thread,
// static and dynamic shared bytes a CTA, into out[0..3].
extern "C" int flash_attention_attrs_f32(int D, int* out) {
  switch (D) {
    case 32: return attrs<32>(out);
    case 64: return attrs<64>(out);
    case 128: return attrs<128>(out);
    default: return cudaErrorInvalidValue;
  }
}

// fp32 q, k, v, o; window <= 0 means no window. Returns the launch's
// cudaError_t (cudaErrorInvalidValue for a head_dim it does not take: 32,
// 64 and 128 are instantiated).
extern "C" int flash_attention_fwd_f32(const void* q, const void* k,
                                       const void* v, void* o, int B, int Sq,
                                       int Skv, int H, int KV, int D,
                                       int causal, int window, float scale,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(q, k, v, o, B, Sq, Skv, H, KV, causal, window, scale, s);
    case 64: return launch<64>(q, k, v, o, B, Sq, Skv, H, KV, causal, window, scale, s);
    case 128: return launch<128>(q, k, v, o, B, Sq, Skv, H, KV, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
