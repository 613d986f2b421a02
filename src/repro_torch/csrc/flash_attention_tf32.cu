// fp32 flash attention on the tensor cores in 3xTF32 for computed widths
// DP = 160 to 256 (head dims 129..256): the instances of flash_tf32.cuh's
// flash_tf32_kernel without a cluster (the header documents the kernel and
// its design), reached through the fp32 entries of flash_attention.cu.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// _flash_kernel (entry flash_attention_pallas) for fp32 inputs.
#include "flash_tf32.cuh"

// 128 < D <= 256, a multiple of 4: the instance of DP = D rounded up to 32
extern "C" int flash_tf32_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int B, int Sq, int Skv, int H,
                              int KV, int D, int causal, int window, float scale,
                              void* stream) {
  if (D <= 128 || D > tf32::kMaxGroup || D % 4) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((D + 31) / 32 * 32) {
    case 160: return tf32::launch<160, false>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, 1, causal, window, scale, s);
    case 192: return tf32::launch<192, false>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, 1, causal, window, scale, s);
    case 224: return tf32::launch<224, false>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, 1, causal, window, scale, s);
    case 256: return tf32::launch<256, false>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, 1, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int flash_tf32_attrs(int D, int* out) {
  switch ((D + 31) / 32 * 32) {
    case 160: return tf32::attrs<160, false>(1, out);
    case 192: return tf32::attrs<192, false>(1, out);
    case 224: return tf32::attrs<224, false>(1, out);
    case 256: return tf32::attrs<256, false>(1, out);
    default: return cudaErrorInvalidValue;
  }
}
