// fp32 flash attention, SIMT, head dims 4..256: the instances of
// flash_simt.cuh's flash_fwd_kernel (the header documents the kernel and its
// design) and the fp32 entries; head dims above 256 go to the wide instances
// of flash_attention_wide.cu.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// _flash_kernel (entry flash_attention_pallas) for fp32 inputs.
#include "flash_simt.cuh"

// The compiled instance for head dim D (DP = D rounded up to 32; the EXACT
// one when D == DP; above 256 the wide instance of D's group width): its
// registers a thread, local (spill) bytes a thread, static and dynamic
// shared bytes a CTA, into out[0..3].
extern "C" int flash_attention_attrs_f32(int D, int* out) {
  if (D > kMaxWidth) return flash_simt_wide_attrs(D, out);
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

// fp32 q, k, v, o, lse (null: not written); window <= 0 means no window.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for a head_dim
// that is not a positive multiple of 4).
extern "C" int flash_attention_fwd_f32(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int B, int Sq, int Skv, int H, int KV,
                                       int D, int causal, int window,
                                       float scale, void* stream) {
  if (D < 4 || D % 4) return cudaErrorInvalidValue;
  if (D > kMaxWidth)
    return flash_simt_wide_fwd(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal,
                               window, scale, stream);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
