// fp32 flash attention on the tensor cores in 3xTF32 for head dims 257 to
// 2,048: the instances of flash_tf32.cuh's flash_tf32_kernel in a
// thread-block cluster, one CTA a column group of O (one instance for each
// group width 160, 192, 224 and 256; the header documents the design),
// reached through the fp32 entries of flash_attention.cu. A unit of its
// own, so that nvcc builds it beside the others.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// _flash_kernel (entry flash_attention_pallas), which takes any D.
#include "flash_tf32.cuh"

namespace {

// O's column groups: ng = ceil(D / 256) groups of gw = ceil(D / ng)
// rounded up to 32 columns, as ops.column_groups computes them
void groups(int D, int* ng, int* gw) {
  *ng = (D + tf32::kMaxGroup - 1) / tf32::kMaxGroup;
  *gw = ((D + *ng - 1) / *ng + 31) / 32 * 32;
}

}  // namespace

// 256 < D <= 2,048, a multiple of 4
extern "C" int flash_tf32_wide_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int Sq, int Skv,
                                   int H, int KV, int D, int causal, int window,
                                   float scale, void* stream) {
  if (D <= tf32::kMaxGroup || D > tf32::kMaxWideDim || D % 4)
    return cudaErrorInvalidValue;
  int ng, gw;
  groups(D, &ng, &gw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (gw) {
    case 160: return tf32::launch<160, true>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, ng, causal, window, scale, s);
    case 192: return tf32::launch<192, true>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, ng, causal, window, scale, s);
    case 224: return tf32::launch<224, true>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, ng, causal, window, scale, s);
    case 256: return tf32::launch<256, true>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, ng, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int flash_tf32_wide_attrs(int D, int* out) {
  if (D <= tf32::kMaxGroup || D > tf32::kMaxWideDim) return cudaErrorInvalidValue;
  int ng, gw;
  groups(D, &ng, &gw);
  switch (gw) {
    case 160: return tf32::attrs<160, true>(ng, out);
    case 192: return tf32::attrs<192, true>(ng, out);
    case 224: return tf32::attrs<224, true>(ng, out);
    case 256: return tf32::attrs<256, true>(ng, out);
    default: return cudaErrorInvalidValue;
  }
}
