// fp32 flash attention, SIMT, for head dims above 2,048 (past the 3xTF32
// kernel's largest cluster): the instances of
// flash_simt.cuh's flash_fwd_wide_kernel (one for each column-group width
// 160, 192, 224 and 256; the header documents the design), reached through
// the entries of flash_attention.cu. A unit of its own, so that nvcc builds
// it beside that one.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// _flash_kernel (entry flash_attention_pallas), which takes any D.
#include "flash_simt.cuh"

namespace {

template <int GW>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o,
                        void* lse, int B, int Sq, int Skv, int H, int KV, int D,
                        int ng, int causal, int window, float scale,
                        cudaStream_t stream) {
  using T = WideTile<GW>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wide_kernel<GW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kBytes);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + T::kBQ - 1) / T::kBQ, ng);
  flash_fwd_wide_kernel<GW><<<grid, kThreads, T::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), Sq, Skv, H, KV, D, causal, window, scale);
  return cudaGetLastError();
}

template <int GW>
cudaError_t attrs_wide(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, flash_fwd_wide_kernel<GW>);
  if (err == cudaSuccess) {
    out[0] = a.numRegs;
    out[1] = static_cast<int>(a.localSizeBytes);
    out[2] = static_cast<int>(a.sharedSizeBytes);
    out[3] = WideTile<GW>::kBytes;
    out[4] = 1;      // no cluster
    out[5] = 0;
  }
  return err;
}

}  // namespace

// D > 2,048, a multiple of 4
extern "C" int flash_simt_wide_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int B, int Sq, int Skv,
                                   int H, int KV, int D, int causal, int window,
                                   float scale, void* stream) {
  if (D <= kMaxTf32 || D % 4) return cudaErrorInvalidValue;
  int ng, gw;
  column_groups(D, &ng, &gw);
  if (ng > 65535) return cudaErrorInvalidValue;   // grid z
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (gw) {
    case 160: return launch_wide<160>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, ng, causal, window, scale, s);
    case 192: return launch_wide<192>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, ng, causal, window, scale, s);
    case 224: return launch_wide<224>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, ng, causal, window, scale, s);
    case 256: return launch_wide<256>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, ng, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int flash_simt_wide_attrs(int D, int* out) {
  if (D <= kMaxTf32) return cudaErrorInvalidValue;
  int ng, gw;
  column_groups(D, &ng, &gw);
  switch (gw) {
    case 160: return attrs_wide<160>(out);
    case 192: return attrs_wide<192>(out);
    case 224: return attrs_wide<224>(out);
    case 256: return attrs_wide<256>(out);
    default: return cudaErrorInvalidValue;
  }
}
