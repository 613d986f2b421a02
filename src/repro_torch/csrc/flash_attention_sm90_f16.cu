// fp16 flash attention on Hopper's tensor cores, head dims 8..256: the fp16
// instances of flash_sm90.cuh (which documents the kernel and its design:
// wgmma .f32.f16.f16, P and o rounded to fp16) and the fp16 entries; head
// dims above 256 go to the cluster and wide instances of
// flash_attention_sm90_wide.cu.
// A unit of its own, so that nvcc builds it beside the bf16 one.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// _flash_kernel (entry flash_attention_pallas) for fp16 inputs.
#include "flash_sm90.cuh"

// As flash_attention_attrs_bf16, for the fp16 instances.
extern "C" int flash_attention_attrs_f16(int D, int* out) {
  return entry_attrs<__half>(D, out);
}

// As flash_attention_fwd_bf16, with fp16 q, k, v and o.
extern "C" int flash_attention_fwd_f16(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int B, int Sq, int Skv, int H, int KV,
                                       int D, int causal, int window,
                                       float scale, void* stream) {
  return entry_fwd<__half>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal,
                           window, scale, stream);
}
