// Flash attention on Hopper's tensor cores for head dims 257 to 1,792, bf16
// and fp16: the instances of flash_sm90.cuh's flash_fwd_sm90_cluster (D =
// 321 to 1,792: the column groups of a query tile one thread-block cluster
// of at most 8 CTAs) and flash_fwd_sm90_wide (D = 257 to 320: two groups of
// 160, where it ran faster than the cluster), one for each column-group
// width 160, 192 and 224 and type (the header documents the design),
// reached through the entries of flash_attention_sm90.cu and
// flash_attention_sm90_f16.cu. Past 1,792 the split route
// (flash_attention_split.cu, with the wrapper's workspace) computes QK^T
// once; these entries refuse those head dims. A unit of its own, so that
// nvcc builds it beside those.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:
// _flash_kernel (entry flash_attention_pallas), which takes any D.
#include "flash_sm90.cuh"

namespace {

// One launch of ng column groups of GW, the groups of a query tile one
// cluster (1, 1, ng). A launch the card refuses returns its error: there is
// no fallback to the wide kernel.
template <typename E, int GW>
cudaError_t launch_cluster(const void* q, const void* k, const void* v, void* o,
                           void* lse, int B, int Sq, int Skv, int H, int KV, int D,
                           int ng, int causal, int window, float scale,
                           cudaStream_t stream) {
  using C = ClusterCfg<GW>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_sm90_cluster<E, GW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_map<E>(&mq, q, D, H, Sq, B, C::COLS, kRows);
  if (err == cudaSuccess) err = make_map<E>(&mk, k, D, KV, Skv, B, C::COLS, C::BK);
  if (err == cudaSuccess) err = make_map<E>(&mv, v, D, KV, Skv, B, C::COLS, C::BK);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H, (Sq + kRows - 1) / kRows, ng);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = ng;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_fwd_sm90_cluster<E, GW>, mq, mk, mv,
                           static_cast<E*>(o), static_cast<float*>(lse), Sq, Skv,
                           H, KV, D, causal, window, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename E, int GW>
cudaError_t launch_wide(const void* q, const void* k, const void* v, void* o,
                        void* lse, int B, int Sq, int Skv, int H, int KV, int D,
                        int ng, int causal, int window, float scale,
                        cudaStream_t stream) {
  using C = WideCfg<GW>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_sm90_wide<E, GW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_map<E>(&mq, q, D, H, Sq, B, C::SC, kRows);
  if (err == cudaSuccess) err = make_map<E>(&mk, k, D, KV, Skv, B, C::SC, C::BK);
  if (err == cudaSuccess) err = make_map<E>(&mv, v, D, KV, Skv, B, C::COLS_V, C::BK);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + kRows - 1) / kRows, ng);
  flash_fwd_sm90_wide<E, GW><<<grid, kThreads, C::SMEM, stream>>>(
      mq, mk, mv, static_cast<E*>(o), static_cast<float*>(lse), Sq, Skv, H,
      KV, D, causal, window, scale);
  return cudaGetLastError();
}

template <typename E>
cudaError_t wide(const void* q, const void* k, const void* v, void* o,
                 void* lse, int B, int Sq, int Skv, int H, int KV, int D,
                 int causal, int window, float scale, cudaStream_t s) {
  int ng, gw;
  column_groups(D, &ng, &gw);
  if (D >= kMinClusterDim) {
    switch (gw) {
      case 160: return launch_cluster<E, 160>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, ng, causal, window, scale, s);
      case 192: return launch_cluster<E, 192>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, ng, causal, window, scale, s);
      case 224: return launch_cluster<E, 224>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, ng, causal, window, scale, s);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (gw) {
    case 160: return launch_wide<E, 160>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, ng, causal, window, scale, s);
    case 192: return launch_wide<E, 192>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, ng, causal, window, scale, s);
    case 224: return launch_wide<E, 224>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, ng, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// fill_attrs's six values of the cluster instance, with its cluster size
// and how many such clusters the card holds at once
template <typename E, int GW>
cudaError_t attrs_cluster(int ng, int* out) {
  using C = ClusterCfg<GW>;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, flash_fwd_sm90_cluster<E, GW>);
  if (err != cudaSuccess) return err;
  fill_attrs(a, C::SMEM, out);
  out[4] = ng;
  err = cudaFuncSetAttribute(flash_fwd_sm90_cluster<E, GW>,
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
  err = cudaOccupancyMaxActiveClusters(&clusters, flash_fwd_sm90_cluster<E, GW>, &cfg);
  out[5] = clusters;
  return err;
}

template <typename E, int GW>
cudaError_t attrs_wide(int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, flash_fwd_sm90_wide<E, GW>);
  if (err == cudaSuccess) fill_attrs(a, WideCfg<GW>::SMEM, out);
  return err;
}

template <typename E>
cudaError_t wide_attrs(int D, int* out) {
  int ng, gw;
  column_groups(D, &ng, &gw);
  if (D >= kMinClusterDim) {
    switch (gw) {
      case 160: return attrs_cluster<E, 160>(ng, out);
      case 192: return attrs_cluster<E, 192>(ng, out);
      case 224: return attrs_cluster<E, 224>(ng, out);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (gw) {
    case 160: return attrs_wide<E, 160>(out);
    case 192: return attrs_wide<E, 192>(out);
    case 224: return attrs_wide<E, 224>(out);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype 0 = bf16, 1 = fp16; 256 < D <= 1,792, a multiple of 8
extern "C" int flash_sm90_wide_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int Sq, int Skv, int H, int KV, int D,
                                   int causal, int window, float scale,
                                   void* stream) {
  if (D <= kMaxWidth || D > kMaxClusterDim || D % 8) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return wide<__nv_bfloat16>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, scale, s);
  if (dtype == 1)
    return wide<__half>(q, k, v, o, lse, B, Sq, Skv, H, KV, D, causal, window, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" int flash_sm90_wide_attrs(int dtype, int D, int* out) {
  if (D <= kMaxWidth || D > kMaxClusterDim) return cudaErrorInvalidValue;
  if (dtype == 0) return wide_attrs<__nv_bfloat16>(D, out);
  if (dtype == 1) return wide_attrs<__half>(D, out);
  return cudaErrorInvalidValue;
}
