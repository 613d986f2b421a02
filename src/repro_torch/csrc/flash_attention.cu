// fp32 flash attention: the entries of head dims up to 2,048. Head dims
// 4..128 run the instances of flash_simt.cuh's flash_fwd_kernel (the header
// documents the kernel and its design), 129..256 the 3xTF32 tensor-core
// kernel of flash_attention_tf32.cu, 257..2,048 its cluster instances
// (flash_attention_tf32_wide.cu). Past 2,048 the split route
// (flash_attention_split.cu: flash_attention_split, which takes the
// wrapper's workspace) computes QK^T once; these entries refuse those head
// dims.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// _flash_kernel (entry flash_attention_pallas) for fp32 inputs.
#include "flash_simt.cuh"

// the 3xTF32 tensor-core kernel (flash_attention_tf32.cu): 128 < D <= 256
extern "C" int flash_tf32_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int Sq, int Skv, int H,
                              int KV, int D, int causal, int window, float scale,
                              void* stream);
extern "C" int flash_tf32_attrs(int D, int* out);
// its cluster instances (flash_attention_tf32_wide.cu): 256 < D <= 2,048
extern "C" int flash_tf32_wide_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int Sq, int Skv,
                                   int H, int KV, int D, int causal, int window,
                                   float scale, void* stream);
extern "C" int flash_tf32_wide_attrs(int D, int* out);

// The compiled instance for head dim D (up to 128: DP = D rounded up to 32,
// the EXACT one when D == DP; up to 256 the 3xTF32 one of DP; up to 2,048
// its cluster one of D's group width): its
// registers a thread, local (spill) bytes a thread, static and dynamic
// shared bytes a CTA, the cluster size (1: none) and how many such clusters
// the card holds at once (0 without one), into out[0..5].
extern "C" int flash_attention_attrs_f32(int D, int* out) {
  if (D > kMaxTf32) return cudaErrorInvalidValue;   // the split route's
  if (D > kMaxWidth) return flash_tf32_wide_attrs(D, out);
  if (D > kMaxSimt) return flash_tf32_attrs(D, out);
  switch ((D + 31) / 32 * 32) {
    case 32: return attrs<32>(D, out);
    case 64: return attrs<64>(D, out);
    case 96: return attrs<96>(D, out);
    case 128: return attrs<128>(D, out);
    default: return cudaErrorInvalidValue;
  }
}

// fp32 q, k, v, o, lse (null: not written); window <= 0 means no window.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for a head_dim
// that is not a positive multiple of 4 up to 2,048).
extern "C" int flash_attention_fwd_f32(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int B, int Sq, int Skv, int H, int KV,
                                       int D, int causal, int window,
                                       float scale, void* stream) {
  if (D < 4 || D % 4 || D > kMaxTf32) return cudaErrorInvalidValue;
  if (D > kMaxWidth)
    return flash_tf32_wide_fwd(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal,
                               window, scale, stream);
  if (D > kMaxSimt)
    return flash_tf32_fwd(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window,
                          scale, stream);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 31) / 32 * 32) {
    case 32: return launch<32>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, scale, s);
    case 64: return launch<64>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, scale, s);
    case 96: return launch<96>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, scale, s);
    case 128: return launch<128>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
