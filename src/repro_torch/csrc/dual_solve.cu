// Per-client bandwidth best response over the decision grid (FairEnergy's
// dual-solve inner step), for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/dual_solve/kernel.py, one
// instance each (compile-time switches SCALED and JOINT on one body):
//   _dual_solve_kernel               (:84)   gamma grid
//   _dual_solve_kernel_scaled        (:99)   + outage pricing e_scale
//   _dual_solve_kernel_joint         (:167)  flat (gamma, bits) levels
//   _dual_solve_kernel_joint_scaled  (:183)  both
// (bodies _best_response_block / _best_response_block_joint, entries
// dual_solve_pallas / dual_solve_pallas_joint).
//
// Per client i and level l: a 3-step log-space Newton solve of the SNR
// stationarity (ref.newton_snr) at the level's payload gamma, the bandwidth
// fraction clipped to [b_lo, 1], E = comm_energy (times e_scale when
// SCALED) + e_cmp and phi = E + lam b - eta u s_l, with a strict-< running
// min over the levels (ties keep the lower level, as torch.argmin does in
// the plain version). On the gamma grid a level's payload gamma and score
// coefficient are gamma itself; on the joint grid they are g*bt/32 and
// g*(1 - 2^(1-bt)), folded on the host in doubles and cast to float, as
// the plain version folds them. JOINT also writes the chosen width.
// SCALED subtracts ln e_scale from the stationarity base after ln D —
// ln lam + ((gfree - ln D) - ln es), the plain version's association (the
// Pallas body folds -ln es into gfree first, which rounds differently).
//
// What bounds it: nothing on the card. It reads 4-5 and writes 4-5 floats
// per client (~40 n bytes: 2 KB at n = 50) and does ~110 operations per
// (client, level); at the main path's n = 50 one launch is a single
// partly-filled warp, so its time is the launch itself. The design answers
// only that: one thread per client (no padding to 128 lanes; the ragged
// tail is masked), the 7 solver scalars read from a device array (the dual
// price lam is updated on the card, so a launch needs no host round trip
// for it), the level table passed by value (kernel parameters live in the
// constant bank) and walked with a runtime count (up to 32 levels: the
// paper's 10 gammas x 3 widths). Precise logf/log1pf/expf and --fmad=false
// keep every rounding equal to the plain PyTorch version's separate ops,
// so near-tied levels pick the same argmin on both.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 32;
// scalar vector layout (the JAX kernel's S_* layout)
constexpr int S_LAM = 0, S_ETA = 1, S_BTOT = 2, S_SBITS = 3, S_IBITS = 4,
              S_N0 = 5, S_BLO = 6;

constexpr float kLn2 = 0.6931471805599453f;
constexpr float kRateFloorHz = 1.0f;   // core.channel.RATE_B_FLOOR_HZ
constexpr float kRateEps = 1e-9f;      // core.channel.RATE_EPS

// per level: gamma, payload gamma, score coefficient, width (bits)
struct Levels {
  float g[kMaxLevels];
  float pay[kMaxLevels];
  float score[kMaxLevels];
  float bits[kMaxLevels];
};

// NaN-propagating min/max, as torch.minimum/maximum and jnp.minimum/maximum
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || a < b) ? a : b;
}
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return min_nan(max_nan(x, lo), hi);
}

// ref.newton_snr: solve t^2 A(t) / L(t)^2 = exp(ln_k) by Newton in u = ln t
__device__ float newton_snr(float ln_k, int iters) {
  ln_k = clip(ln_k, -45.0f, 55.0f);
  const float u_small = 0.5f * (ln_k + kLn2);
  const float u_large = 0.5f * ln_k + 0.5f * logf(max_nan(0.5f * ln_k, 1.0f));
  float u = clip(ln_k > 2.0f ? u_large : u_small, -20.0f, 25.0f);
  const float c43 = 4.0f / 3.0f;
  for (int it = 0; it < iters; ++it) {
    const float t = expf(u);
    const float L = log1pf(t);
    const float one_t = 1.0f + t;
    const float A = t < 0.01f
        ? 0.5f * t * t * (1.0f - c43 * t + 1.5f * t * t)
        : L - t / one_t;
    const float tL = t / L;
    const float F = logf(tL * tL * A) - ln_k;
    const float dF = 2.0f + t * t / (one_t * one_t * A) - 2.0f * t / (one_t * L);
    u = clip(u - F / dF, -20.0f, 25.0f);
  }
  return expf(u);
}

// core.channel.comm_energy at bandwidth B (Hz)
__device__ __forceinline__ float comm_energy(float g, float B, float P, float h,
                                             float s_bits, float i_bits,
                                             float n0) {
  const float Bc = max_nan(B, kRateFloorHz);
  const float snr = P * h / (n0 * Bc);
  const float rate = Bc * log1pf(snr) / kLn2;
  const float t = (g * s_bits + i_bits) / max_nan(rate, kRateEps);
  return P * (B >= kRateFloorHz ? t : INFINITY);
}

template <bool SCALED, bool JOINT>
__global__ void dual_solve_kernel(const float* __restrict__ P_in,
                                  const float* __restrict__ h_in,
                                  const float* __restrict__ u_in,
                                  const float* __restrict__ ec_in,
                                  const float* __restrict__ es_in,
                                  const float* __restrict__ sc,
                                  const Levels lv, int n_levels,
                                  int newton_iters, int n,
                                  float* __restrict__ gam_out,
                                  float* __restrict__ b_out,
                                  float* __restrict__ e_out,
                                  float* __restrict__ phi_out,
                                  float* __restrict__ bits_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float lam = sc[S_LAM], eta = sc[S_ETA], b_tot = sc[S_BTOT];
  const float s_bits = sc[S_SBITS], i_bits = sc[S_IBITS], n0 = sc[S_N0];
  const float b_lo = sc[S_BLO];
  const float P = P_in[i], h = h_in[i], u = u_in[i], ec = ec_in[i];
  const float es = SCALED ? es_in[i] : 1.0f;

  const float c = P * h / n0;                                   // snr_coeff
  // ref.ln_k_gamma_free, hoisted over the levels
  const float gfree = 2.0f * logf(c) - logf(P) - logf(b_tot * kLn2);
  const float ln_es = SCALED ? logf(es) : 0.0f;
  const float ln_lam = logf(max_nan(lam, 1e-30f));

  float best_g = 0.0f, best_b = 0.0f, best_e = 0.0f, best_phi = 0.0f;
  float best_bits = 0.0f;
#pragma unroll 2
  for (int l = 0; l < n_levels; ++l) {
    const float pay = lv.pay[l];
    float base = gfree - logf(pay * s_bits + i_bits);           // ref.ln_k_base
    if (SCALED) base = base - ln_es;                            // lam -> lam/es
    const float t = newton_snr(ln_lam + base, newton_iters);
    const float b = clip(c / (t * b_tot), b_lo, 1.0f);
    float e = comm_energy(pay, b * b_tot, P, h, s_bits, i_bits, n0);
    if (SCALED) e = e * es;
    e = e + ec;
    const float phi = e + lam * b - eta * u * lv.score[l];
    if (l == 0 || phi < best_phi) {
      best_g = lv.g[l]; best_b = b; best_e = e; best_phi = phi;
      if (JOINT) best_bits = lv.bits[l];
    }
  }
  gam_out[i] = best_g;
  b_out[i] = best_b;
  e_out[i] = best_e;
  phi_out[i] = best_phi;
  if (JOINT) bits_out[i] = best_bits;
}

template <bool SCALED, bool JOINT>
void launch(const float* P, const float* h, const float* u, const float* ec,
            const float* es, const float* sc, const Levels& lv, int n_levels,
            int newton_iters, int n, float* gam, float* b, float* e,
            float* phi, float* bits, cudaStream_t stream) {
  constexpr int kThreads = 128;
  const int blocks = (n + kThreads - 1) / kThreads;
  dual_solve_kernel<SCALED, JOINT><<<blocks, kThreads, 0, stream>>>(
      P, h, u, ec, es, sc, lv, n_levels, newton_iters, n, gam, b, e, phi,
      bits);
}

}  // namespace

// levels: host array of 4 * L floats, [gamma | payload gamma | score
// coefficient | bits], each block L long. e_scale may be null (unpriced),
// bits null (gamma grid: the width block is ignored).
extern "C" int dual_solve_levels_f32(const float* P, const float* h,
                                     const float* u, const float* e_cmp,
                                     const float* e_scale,
                                     const float* scalars,
                                     const float* levels, int L,
                                     int newton_iters, int n, float* gam,
                                     float* b, float* e, float* phi,
                                     float* bits, void* stream) {
  if (L < 1 || L > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  if (n < 1) return 0;
  Levels lv{};
  for (int l = 0; l < L; ++l) {                               // host array
    lv.g[l] = levels[l];
    lv.pay[l] = levels[L + l];
    lv.score[l] = levels[2 * L + l];
    lv.bits[l] = levels[3 * L + l];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool scaled = e_scale != nullptr, joint = bits != nullptr;
  if (scaled && joint)
    launch<true, true>(P, h, u, e_cmp, e_scale, scalars, lv, L, newton_iters, n, gam, b, e, phi, bits, s);
  else if (scaled)
    launch<true, false>(P, h, u, e_cmp, e_scale, scalars, lv, L, newton_iters, n, gam, b, e, phi, bits, s);
  else if (joint)
    launch<false, true>(P, h, u, e_cmp, e_scale, scalars, lv, L, newton_iters, n, gam, b, e, phi, bits, s);
  else
    launch<false, false>(P, h, u, e_cmp, e_scale, scalars, lv, L, newton_iters, n, gam, b, e, phi, bits, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
