// FairEnergy's dual solve for Hopper (sm_90a): the per-client bandwidth
// best response over the decision grid (one step), and the whole dual
// ascent of Algorithm 1 around it in one launch.
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
// The one-step kernel (dual_solve_kernel). What bounds it: nothing on the card. It reads 4-5 and writes 4-5 floats
// per client (~40 n bytes: 2 KB at n = 50) and does ~110 operations per
// (client, level); at the main path's n = 50 one launch is a single
// partly-filled warp, so its time is the launch itself. The design answers
// only that: one thread per client (no padding to 128 lanes; the ragged
// tail is masked), the 7 solver scalars read from a device array (the dual
// price lam is updated on the card, so a launch needs no host round trip
// for it), and the level table a device buffer that the wrapper makes once
// per (grid, device), walked with a runtime count of any size. Precise
// logf/log1pf/expf and --fmad=false keep every rounding equal to the plain
// PyTorch version's separate ops, so near-tied levels pick the same argmin
// on both.
//
// The level table: 5 blocks of L float32s, [gamma | payload gamma | score
// coefficient | width | fidelity] (kernels/dual_solve/ops.ascent_levels),
// read through the read-only (L1) path: 20 bytes a level, so any grid the
// reference takes (its Pallas kernels take a static tuple of any length)
// fits, and no level count is refused.
//
// The fused ascent (dual_ascent_kernel) replaces the same four TPU kernels
// together with the loop around them: the reference's lax.while_loop in
// src/repro/core/fairenergy.py:371-395 (solve_round), whose host-side copy
// in the port made one launch, ~15 small PyTorch launches and one host
// synchronization per iteration. One launch now runs every iteration in
// the plain version's float32 operations and order
// (kernels/dual_solve/ref.py:dual_ascent_ref): the best response at lam;
// the selection x = (e + lam b < eta s + mu (1 - rho)) & alive, with s =
// u gamma times the level's float32 fidelity on the joint grid; the sum of
// x b; lam = max(lam + alpha_lambda (sum - 1), 0); mu = max(mu + alpha_mu
// alive (pi_min - rho q - (1 - rho) x), 0); the residual max(|d lam| /
// max(alpha_lambda, 1e-30), max |d mu| / max(alpha_mu, 1e-30)); and the
// exit n < cap && !(res > dual_tol) after the first iteration, which always
// runs. Then the best response at the final lam, written with lam, mu and
// the iteration count (int32) to device outputs: no host round trip.
//
// What bounds it: latency. Up to 30 dependent iterations, each a Newton
// solve per (client, level) (~110 float operations, a few precise libm
// calls) and one reduction of [N] to a scalar; the bytes (~50 N) and the
// operations are nothing for the card. The design cuts each iteration's
// critical path: one CTA of up to 1024 threads, each client owned by a
// group of 16 lanes (at most 16 levels: the gamma grid) or 32 (more), lane
// l evaluating levels l, l + 32, ... (one level a lane up to 32 levels: the
// paper's 10 gammas x 3 widths), so an iteration costs about ceil(L / 32)
// levels' latency instead of L serial ones. The argmin is a total order
// that picks exactly the level of the one-step kernel's strict-< running
// minimum (the lowest level on ties; level 0 when its phi is NaN, and a
// later NaN never): each lane first reduces its own levels, in increasing
// order, under that order (a later level wins only by a lower class or,
// both numbers, a strictly smaller phi: a running strict-< alone would let
// a NaN at a lane's first level hide its later numbers), then a butterfly
// of shuffles inside the group combines the lanes. Clients beyond one wave
// of groups loop inside the CTA; sum(x b) and max |d mu| are deterministic
// trees (warp shuffles, then one warp over the warps' partials: no
// atomics, the same order every run); lam lives in shared memory, two CTA
// barriers an iteration. Both kernels evaluate a level through the same
// __device__ functions (client_head, level_response), so their float
// operations cannot drift apart.
#include <cuda_runtime.h>
#include <math.h>

namespace {

// scalar vector layout (the JAX kernel's S_* layout)
constexpr int S_LAM = 0, S_ETA = 1, S_BTOT = 2, S_SBITS = 3, S_IBITS = 4,
              S_N0 = 5, S_BLO = 6;

constexpr float kLn2 = 0.6931471805599453f;
constexpr float kRateFloorHz = 1.0f;   // core.channel.RATE_B_FLOOR_HZ
constexpr float kRateEps = 1e-9f;      // core.channel.RATE_EPS

// ascent scalars beyond the best response's seven
constexpr int S_RHO = 7, S_PIMIN = 8, S_ALAM = 9, S_AMU = 10, S_TOL = 11;

// The level table on the device, n levels: per level its gamma, payload
// gamma, score coefficient, width (bits), and the float32 score fidelity of
// the width (the ascent's selection test), each block n long
struct Levels {
  const float* __restrict__ p;
  int n;
  __device__ __forceinline__ float g(int l) const { return __ldg(p + l); }
  __device__ __forceinline__ float pay(int l) const { return __ldg(p + n + l); }
  __device__ __forceinline__ float score(int l) const { return __ldg(p + 2 * n + l); }
  __device__ __forceinline__ float bits(int l) const { return __ldg(p + 3 * n + l); }
  __device__ __forceinline__ float fid(int l) const { return __ldg(p + 4 * n + l); }
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

// the best response's scalars (sc[0..7)) and one client's inputs
struct Consts {
  float lam, eta, b_tot, s_bits, i_bits, n0, b_lo;
};
struct Client {
  float P, h, u, ec, es;
};
// the level-free part of a client's stationarity constant, at price lam
struct ClientHead {
  float c, gfree, ln_es, ln_lam;
};
struct LevelOut {
  float b, e, phi;
};

__device__ __forceinline__ Consts load_consts(const float* sc) {
  return Consts{sc[S_LAM], sc[S_ETA], sc[S_BTOT], sc[S_SBITS], sc[S_IBITS],
                sc[S_N0], sc[S_BLO]};
}

template <bool SCALED>
__device__ __forceinline__ Client load_client(int i, const float* P,
                                              const float* h, const float* u,
                                              const float* ec,
                                              const float* es) {
  return Client{P[i], h[i], u[i], ec[i], SCALED ? es[i] : 1.0f};
}

template <bool SCALED>
__device__ __forceinline__ ClientHead client_head(const Client& cl,
                                                  const Consts& k) {
  ClientHead hd;
  hd.c = cl.P * cl.h / k.n0;                                   // snr_coeff
  // ref.ln_k_gamma_free, hoisted over the levels
  hd.gfree = 2.0f * logf(hd.c) - logf(cl.P) - logf(k.b_tot * kLn2);
  hd.ln_es = SCALED ? logf(cl.es) : 0.0f;
  hd.ln_lam = logf(max_nan(k.lam, 1e-30f));
  return hd;
}

// one (client, level): the clipped bandwidth best response at the level's
// payload gamma, its energy and phi = E + lam b - eta u score
template <bool SCALED>
__device__ __forceinline__ LevelOut level_response(const Client& cl,
                                                   const ClientHead& hd,
                                                   const Consts& k, float pay,
                                                   float score,
                                                   int newton_iters) {
  float base = hd.gfree - logf(pay * k.s_bits + k.i_bits);     // ref.ln_k_base
  if (SCALED) base = base - hd.ln_es;                          // lam -> lam/es
  const float t = newton_snr(hd.ln_lam + base, newton_iters);
  const float b = clip(hd.c / (t * k.b_tot), k.b_lo, 1.0f);
  float e = comm_energy(pay, b * k.b_tot, cl.P, cl.h, k.s_bits, k.i_bits, k.n0);
  if (SCALED) e = e * cl.es;
  e = e + cl.ec;
  return LevelOut{b, e, e + k.lam * b - k.eta * cl.u * score};
}

template <bool SCALED, bool JOINT>
__global__ void dual_solve_kernel(const float* __restrict__ P_in,
                                  const float* __restrict__ h_in,
                                  const float* __restrict__ u_in,
                                  const float* __restrict__ ec_in,
                                  const float* __restrict__ es_in,
                                  const float* __restrict__ sc,
                                  const Levels lv, int newton_iters, int n,
                                  float* __restrict__ gam_out,
                                  float* __restrict__ b_out,
                                  float* __restrict__ e_out,
                                  float* __restrict__ phi_out,
                                  float* __restrict__ bits_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Consts k = load_consts(sc);
  const Client cl = load_client<SCALED>(i, P_in, h_in, u_in, ec_in, es_in);
  const ClientHead hd = client_head<SCALED>(cl, k);

  float best_g = 0.0f, best_b = 0.0f, best_e = 0.0f, best_phi = 0.0f;
  float best_bits = 0.0f;
#pragma unroll 2
  for (int l = 0; l < lv.n; ++l) {
    const LevelOut r = level_response<SCALED>(cl, hd, k, lv.pay(l),
                                              lv.score(l), newton_iters);
    if (l == 0 || r.phi < best_phi) {
      best_g = lv.g(l); best_b = r.b; best_e = r.e; best_phi = r.phi;
      if (JOINT) best_bits = lv.bits(l);
    }
  }
  gam_out[i] = best_g;
  b_out[i] = best_b;
  e_out[i] = best_e;
  phi_out[i] = best_phi;
  if (JOINT) bits_out[i] = best_bits;
}

// ---- the fused dual ascent ------------------------------------------------
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(kFull, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max_nan(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The chosen level of a client, known to every lane of its group.
struct Choice {
  int level;
  float b, e, phi;
};

// Every lane of the CTA calls this (shuffles need the whole warp); the
// LANES lanes of a group evaluate client i's levels, lane l the levels l,
// l + LANES, ..., and agree on the argmin. Order: level 0 with a NaN phi
// first; then the non-NaN phis by value, ties to the lower level; then the
// NaN phis and the idle lanes, by level. That is the one-step kernel's
// running strict-< minimum, which keeps level 0 when its phi is NaN and
// never takes a later NaN. A lane's own levels come in increasing order,
// so a later one replaces its best only by a lower class or, both numbers,
// a strictly smaller phi; with at most LANES levels each lane holds one,
// and the pass is that level's evaluation alone (16-lane groups, which
// the dispatch gives grids of at most 16 levels, compile no loop).
template <bool SCALED, int LANES>
__device__ __forceinline__ Choice best_level(bool valid, const Client& cl,
                                             const Consts& k,
                                             const Levels& lv,
                                             int newton_iters) {
  const int lane = threadIdx.x % LANES;
  LevelOut r{0.0f, 0.0f, 0.0f};
  int idx = lane;
  int c = 2;                            // 0: NaN at level 0, 1: a number, 2: last
  if (valid && lane < lv.n) {
    const ClientHead hd = client_head<SCALED>(cl, k);
    r = level_response<SCALED>(cl, hd, k, lv.pay(lane), lv.score(lane),
                               newton_iters);
    c = r.phi != r.phi ? (lane == 0 ? 0 : 2) : 1;
    // the levels past the group's lanes (16-lane groups take at most 16)
    if (LANES == 32) {
      for (int l = lane + LANES; l < lv.n; l += LANES) {
        const LevelOut o = level_response<SCALED>(cl, hd, k, lv.pay(l),
                                                  lv.score(l), newton_iters);
        const int cls = o.phi != o.phi ? 2 : 1;
        if (cls < c || (cls == 1 && c == 1 && o.phi < r.phi)) {
          r = o;
          idx = l;
          c = cls;
        }
      }
    }
  }
  float phi = r.phi;
  int best = idx;
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1) {
    const float phi_o = __shfl_xor_sync(kFull, phi, o, LANES);
    const int idx_o = __shfl_xor_sync(kFull, best, o, LANES);
    const int c_o = __shfl_xor_sync(kFull, c, o, LANES);
    const bool take = c_o < c ||
        (c_o == c && (c == 1 ? (phi_o < phi || (phi_o == phi && idx_o < best))
                             : idx_o < best));
    if (take) { phi = phi_o; best = idx_o; c = c_o; }
  }
  // the lane that holds the chosen level kept its b and e
  return Choice{best, __shfl_sync(kFull, r.b, best % LANES, LANES),
                __shfl_sync(kFull, r.e, best % LANES, LANES), phi};
}

template <bool SCALED, bool JOINT, int LANES>
__global__ void __launch_bounds__(1024)
dual_ascent_kernel(const float* __restrict__ P_in, const float* __restrict__ h_in,
                   const float* __restrict__ u_in, const float* __restrict__ ec_in,
                   const float* __restrict__ es_in,
                   const bool* __restrict__ alive_in,
                   const float* __restrict__ q_in,
                   const float* __restrict__ mu_in,
                   const float* __restrict__ sc, const Levels lv,
                   int newton_iters, int cap, int n,
                   float* __restrict__ gam_out, float* __restrict__ b_out,
                   float* __restrict__ e_out, float* __restrict__ phi_out,
                   float* __restrict__ bits_out, float* __restrict__ mu_out,
                   float* __restrict__ lam_out, float* __restrict__ res_out,
                   int* __restrict__ n_out) {
  __shared__ float red_sum[32], red_max[32];
  __shared__ float s_lam;
  __shared__ int s_go;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_warps = blockDim.x / 32;
  const int group = tid / LANES, groups = blockDim.x / LANES;
  const int waves = (n + groups - 1) / groups;
  const bool leader = tid % LANES == 0;
  Consts k = load_consts(sc);
  const float rho = sc[S_RHO], pi_min = sc[S_PIMIN], alam = sc[S_ALAM],
              amu = sc[S_AMU], tol = sc[S_TOL];
  const float one_rho = 1.0f - rho;
  if (tid == 0) {
    s_lam = k.lam;
    s_go = cap > 0;
  }
  __syncthreads();

  int it = 0;
  // the last residual and the one before it, as the plain loop carries
  // them (+inf until an iteration sets them); thread 0 computes and keeps
  // them
  float res_last = INFINITY, res_prev = INFINITY;
  while (s_go) {
    k.lam = s_lam;
    float part = 0.0f, dmu = 0.0f;     // this leader's sum(x b), max |d mu|
    for (int w = 0; w < waves; ++w) {
      const int i = w * groups + group;
      const bool valid = i < n;
      const Client cl = valid ? load_client<SCALED>(i, P_in, h_in, u_in, ec_in, es_in)
                              : Client{1.0f, 1.0f, 0.0f, 0.0f, 1.0f};
      const Choice ch = best_level<SCALED, LANES>(valid, cl, k, lv, newton_iters);
      if (leader && valid) {
        const float mu = it == 0 ? mu_in[i] : mu_out[i];
        const float alive = alive_in[i] ? 1.0f : 0.0f;
        float s = cl.u * lv.g(ch.level);                 // contribution_score
        if (JOINT) s = s * lv.fid(ch.level);
        const bool x = (ch.e + k.lam * ch.b < k.eta * s + mu * one_rho) &&
                       alive_in[i];
        const float xf = x ? 1.0f : 0.0f;
        part = part + xf * ch.b;
        const float new_mu = max_nan(
            mu + amu * alive * ((pi_min - rho * q_in[i]) - one_rho * xf), 0.0f);
        dmu = max_nan(dmu, fabsf(new_mu - mu));
        mu_out[i] = new_mu;
      }
    }
    const float ws = warp_sum(part), wm = warp_max(dmu);
    if (lane == 0) {
      red_sum[warp] = ws;
      red_max[warp] = wm;
    }
    __syncthreads();
    if (warp == 0) {
      const float total = warp_sum(lane < n_warps ? red_sum[lane] : 0.0f);
      const float dmu_all = warp_max(lane < n_warps ? red_max[lane] : 0.0f);
      if (lane == 0) {
        const float lam = k.lam;
        const float new_lam = max_nan(lam + alam * (total - 1.0f), 0.0f);
        const float res = max_nan(fabsf(new_lam - lam) / max_nan(alam, 1e-30f),
                                  dmu_all / max_nan(amu, 1e-30f));
        s_lam = new_lam;
        s_go = it + 1 < cap && res > tol;
        res_prev = res_last;
        res_last = res;
      }
    }
    ++it;
    __syncthreads();
  }

  // the best response at the final price
  k.lam = s_lam;
  for (int w = 0; w < waves; ++w) {
    const int i = w * groups + group;
    const bool valid = i < n;
    const Client cl = valid ? load_client<SCALED>(i, P_in, h_in, u_in, ec_in, es_in)
                            : Client{1.0f, 1.0f, 0.0f, 0.0f, 1.0f};
    const Choice ch = best_level<SCALED, LANES>(valid, cl, k, lv, newton_iters);
    if (leader && valid) {
      if (it == 0) mu_out[i] = mu_in[i];        // no iteration ran (cap 0)
      gam_out[i] = lv.g(ch.level);
      b_out[i] = ch.b;
      e_out[i] = ch.e;
      phi_out[i] = ch.phi;
      if (JOINT) bits_out[i] = lv.bits(ch.level);
    }
  }
  if (tid == 0) {
    lam_out[0] = k.lam;
    res_out[0] = res_last;
    res_out[1] = res_prev;
    n_out[0] = it;
  }
}

template <bool SCALED, bool JOINT>
void launch(const float* P, const float* h, const float* u, const float* ec,
            const float* es, const float* sc, const Levels& lv,
            int newton_iters, int n, float* gam, float* b, float* e,
            float* phi, float* bits, cudaStream_t stream) {
  constexpr int kThreads = 128;
  const int blocks = (n + kThreads - 1) / kThreads;
  dual_solve_kernel<SCALED, JOINT><<<blocks, kThreads, 0, stream>>>(
      P, h, u, ec, es, sc, lv, newton_iters, n, gam, b, e, phi, bits);
}

template <bool SCALED, bool JOINT, int LANES>
void launch_ascent(const float* P, const float* h, const float* u,
                   const float* ec, const float* es, const bool* alive,
                   const float* q, const float* mu, const float* sc,
                   const Levels& lv, int newton_iters, int cap, int n,
                   float* gam, float* b, float* e, float* phi, float* bits,
                   float* mu_out, float* lam_out, float* res_out, int* n_out,
                   cudaStream_t stream) {
  const int lanes = n * LANES;
  const int threads = lanes >= 1024 ? 1024 : ((lanes + 31) / 32) * 32;
  dual_ascent_kernel<SCALED, JOINT, LANES><<<1, threads, 0, stream>>>(
      P, h, u, ec, es, alive, q, mu, sc, lv, newton_iters, cap, n, gam, b, e,
      phi, bits, mu_out, lam_out, res_out, n_out);
}

template <int LANES>
void dispatch_ascent(bool scaled, bool joint, const float* P, const float* h,
                     const float* u, const float* ec, const float* es,
                     const bool* alive, const float* q, const float* mu,
                     const float* sc, const Levels& lv, int newton_iters,
                     int cap, int n, float* gam, float* b, float* e, float* phi,
                     float* bits, float* mu_out, float* lam_out, float* res_out,
                     int* n_out, cudaStream_t s) {
  if (scaled && joint)
    launch_ascent<true, true, LANES>(P, h, u, ec, es, alive, q, mu, sc, lv, newton_iters, cap, n, gam, b, e, phi, bits, mu_out, lam_out, res_out, n_out, s);
  else if (scaled)
    launch_ascent<true, false, LANES>(P, h, u, ec, es, alive, q, mu, sc, lv, newton_iters, cap, n, gam, b, e, phi, bits, mu_out, lam_out, res_out, n_out, s);
  else if (joint)
    launch_ascent<false, true, LANES>(P, h, u, ec, es, alive, q, mu, sc, lv, newton_iters, cap, n, gam, b, e, phi, bits, mu_out, lam_out, res_out, n_out, s);
  else
    launch_ascent<false, false, LANES>(P, h, u, ec, es, alive, q, mu, sc, lv, newton_iters, cap, n, gam, b, e, phi, bits, mu_out, lam_out, res_out, n_out, s);
}

}  // namespace

// The whole dual ascent and the final best response in one launch (one
// CTA). alive: [n] bools; q, mu: [n] floats; scalars: 12 floats on the
// device (lam, eta, b_tot, s_bits, i_bits, n0, b_lo, rho, pi_min,
// alpha_lambda, alpha_mu, dual_tol); levels: the device table of 5 * L
// floats, [gamma | payload gamma | score coefficient | bits | fidelity],
// each block L long, any L >= 1. e_scale may be null (unpriced), bits null
// (gamma grid). Writes gamma, b, e, phi (bits) at the final price, mu_out
// [n], lam_out [1], res_out [2] (the last residual and the one before it,
// +inf where no iteration set them) and n_out [1] (iterations run, int32).
extern "C" int dual_ascent_f32(const float* P, const float* h, const float* u,
                               const float* e_cmp, const float* e_scale,
                               const bool* alive, const float* q,
                               const float* mu, const float* scalars,
                               const float* levels, int L, int newton_iters,
                               int cap, int n, float* gam, float* b, float* e,
                               float* phi, float* bits, float* mu_out,
                               float* lam_out, float* res_out, int* n_out,
                               void* stream) {
  if (L < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Levels lv{levels, L};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool scaled = e_scale != nullptr, joint = bits != nullptr;
  if (L <= 16)
    dispatch_ascent<16>(scaled, joint, P, h, u, e_cmp, e_scale, alive, q, mu, scalars, lv, newton_iters, cap, n, gam, b, e, phi, bits, mu_out, lam_out, res_out, n_out, s);
  else
    dispatch_ascent<32>(scaled, joint, P, h, u, e_cmp, e_scale, alive, q, mu, scalars, lv, newton_iters, cap, n, gam, b, e, phi, bits, mu_out, lam_out, res_out, n_out, s);
  return static_cast<int>(cudaGetLastError());
}

// levels: the device table of 5 * L floats (the fused entry's; the
// fidelity block is not read), any L >= 1. e_scale may be null (unpriced),
// bits null (gamma grid: the width block is ignored).
extern "C" int dual_solve_levels_f32(const float* P, const float* h,
                                     const float* u, const float* e_cmp,
                                     const float* e_scale,
                                     const float* scalars,
                                     const float* levels, int L,
                                     int newton_iters, int n, float* gam,
                                     float* b, float* e, float* phi,
                                     float* bits, void* stream) {
  if (L < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n < 1) return 0;
  const Levels lv{levels, L};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool scaled = e_scale != nullptr, joint = bits != nullptr;
  if (scaled && joint)
    launch<true, true>(P, h, u, e_cmp, e_scale, scalars, lv, newton_iters, n, gam, b, e, phi, bits, s);
  else if (scaled)
    launch<true, false>(P, h, u, e_cmp, e_scale, scalars, lv, newton_iters, n, gam, b, e, phi, bits, s);
  else if (joint)
    launch<false, true>(P, h, u, e_cmp, e_scale, scalars, lv, newton_iters, n, gam, b, e, phi, bits, s);
  else
    launch<false, false>(P, h, u, e_cmp, e_scale, scalars, lv, newton_iters, n, gam, b, e, phi, bits, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
