// bf16 flash attention on Hopper's tensor cores, head dims 8..256: the bf16
// instances of flash_sm90.cuh (which documents the kernel and its design)
// and the bf16 entries; head dims above 256 go to the cluster and wide
// instances of flash_attention_sm90_wide.cu.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// _flash_kernel (entry flash_attention_pallas) for bf16 inputs.
#include "flash_sm90.cuh"

// The compiled instance for head dim D (computed width DP = D rounded up to
// 32; the EXACT one when D == DP; above 256 the cluster or wide instance of
// D's group width): its registers a thread (at launch, before setmaxnreg),
// local (spill) bytes a thread, static and dynamic shared bytes a CTA, the
// cluster size (1: none) and the clusters the card holds at once (0: no
// cluster), into out[0..5].
extern "C" int flash_attention_attrs_bf16(int D, int* out) {
  return entry_attrs<__nv_bfloat16>(D, out);
}

// bf16 q, k, v, o, fp32 lse (null: not written); window <= 0 means no
// window. Returns the launch's cudaError_t (cudaErrorInvalidValue for a
// head_dim that is not a positive multiple of 8, or a tensor the TMA cannot
// map).
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int B, int Sq, int Skv, int H, int KV,
                                        int D, int causal, int window,
                                        float scale, void* stream) {
  return entry_fwd<__nv_bfloat16>(q, k, v, o, lse, B, Sq, Skv, H, KV, D,
                                  causal, window, scale, stream);
}
