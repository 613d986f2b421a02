// Per-client bandwidth best response over the gamma grid (FairEnergy's
// dual-solve inner step), for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/dual_solve/kernel.py:
// _dual_solve_kernel (body _best_response_block, entry dual_solve_pallas)
// for the gamma-only grid without outage pricing.
//
// Per client i and grid level g: a 3-step log-space Newton solve of the
// SNR stationarity (ref.newton_snr), the bandwidth fraction clipped to
// [b_lo, 1], E = comm_energy + e_cmp and phi = E + lam b - eta u g, with a
// strict-< running min over the levels (ties keep the lower level, as
// torch.argmin does in the plain version).
//
// What bounds it: nothing on the card. It reads 4 and writes 4 floats per
// client (32 n bytes: 1.6 KB at n = 50) and does ~10 x (3 + 3 Newton x 3)
// transcendentals per client; at the main path's n = 50 one launch is a
// single partly-filled warp, so its time is the launch itself. The design
// answers only that: one thread per client (no padding to 128 lanes; the
// ragged tail is masked), the 7 solver scalars read from a device array
// (the dual price lam is updated on the card, so a launch needs no host
// round trip for it), the grid passed by value (kernel parameters live in
// the constant bank) with the loop over it unrolled by a template on G.
// Precise logf/log1pf/expf and --fmad=false keep every rounding equal to
// the plain PyTorch version's separate ops, so near-tied levels pick the
// same argmin on both.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxGrid = 16;
// scalar vector layout (the JAX kernel's S_* layout)
constexpr int S_LAM = 0, S_ETA = 1, S_BTOT = 2, S_SBITS = 3, S_IBITS = 4,
              S_N0 = 5, S_BLO = 6;

constexpr float kLn2 = 0.6931471805599453f;
constexpr float kRateFloorHz = 1.0f;   // core.channel.RATE_B_FLOOR_HZ
constexpr float kRateEps = 1e-9f;      // core.channel.RATE_EPS

struct Grid {
  float g[kMaxGrid];
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

template <int G>
__global__ void dual_solve_kernel(const float* __restrict__ P_in,
                                  const float* __restrict__ h_in,
                                  const float* __restrict__ u_in,
                                  const float* __restrict__ ec_in,
                                  const float* __restrict__ sc, Grid grid,
                                  int newton_iters, int n,
                                  float* __restrict__ gam_out,
                                  float* __restrict__ b_out,
                                  float* __restrict__ e_out,
                                  float* __restrict__ phi_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float lam = sc[S_LAM], eta = sc[S_ETA], b_tot = sc[S_BTOT];
  const float s_bits = sc[S_SBITS], i_bits = sc[S_IBITS], n0 = sc[S_N0];
  const float b_lo = sc[S_BLO];
  const float P = P_in[i], h = h_in[i], u = u_in[i], ec = ec_in[i];

  const float c = P * h / n0;                                   // snr_coeff
  // ref.ln_k_gamma_free, hoisted over the levels
  const float gfree = 2.0f * logf(c) - logf(P) - logf(b_tot * kLn2);
  const float ln_lam = logf(max_nan(lam, 1e-30f));

  float best_g = 0.0f, best_b = 0.0f, best_e = 0.0f, best_phi = 0.0f;
#pragma unroll
  for (int l = 0; l < G; ++l) {
    const float g = grid.g[l];
    const float base = gfree - logf(g * s_bits + i_bits);       // ref.ln_k_base
    const float t = newton_snr(ln_lam + base, newton_iters);
    const float b = clip(c / (t * b_tot), b_lo, 1.0f);
    const float e = comm_energy(g, b * b_tot, P, h, s_bits, i_bits, n0) + ec;
    const float phi = e + lam * b - eta * u * g;
    if (l == 0 || phi < best_phi) {
      best_g = g; best_b = b; best_e = e; best_phi = phi;
    }
  }
  gam_out[i] = best_g;
  b_out[i] = best_b;
  e_out[i] = best_e;
  phi_out[i] = best_phi;
}

template <int G>
void launch(const float* P, const float* h, const float* u, const float* ec,
            const float* sc, const Grid& grid, int newton_iters, int n,
            float* gam, float* b, float* e, float* phi, cudaStream_t stream) {
  constexpr int kThreads = 128;
  const int blocks = (n + kThreads - 1) / kThreads;
  dual_solve_kernel<G><<<blocks, kThreads, 0, stream>>>(
      P, h, u, ec, sc, grid, newton_iters, n, gam, b, e, phi);
}

}  // namespace

extern "C" int dual_solve_f32(const float* P, const float* h, const float* u,
                              const float* e_cmp, const float* scalars,
                              const float* gamma_grid, int G, int newton_iters,
                              int n, float* gam, float* b, float* e,
                              float* phi, void* stream) {
  if (G < 1 || G > kMaxGrid) return static_cast<int>(cudaErrorInvalidValue);
  if (n < 1) return 0;
  Grid grid{};
  for (int l = 0; l < G; ++l) grid.g[l] = gamma_grid[l];   // host array
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (G) {
#define CASE(K) \
    case K: launch<K>(P, h, u, e_cmp, scalars, grid, newton_iters, n, gam, b, e, phi, s); break;
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
#undef CASE
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
