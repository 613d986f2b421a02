"""FairEnergy per-round controller (paper Sec. IV-VI, Algorithm 1).

Jointly decides selection x_i, sparsity gamma_i and bandwidth B_i by
Lagrangian relaxation:

  min  sum_i x_i (E_i(gamma_i, B_i) - eta s_i(gamma_i))
  s.t. sum_i x_i B_i <= B_tot,  gamma in grid,  q_i >= pi_min

* dualize bandwidth (lambda) and fairness (mu_i); the partial Lagrangian
  separates per device, and is affine in x => threshold rule
      x_i = 1  iff  E_i + lambda B_i < eta s_i + mu_i (1 - rho);
* per device, gamma on a grid and B by the analytic bandwidth
  best-response (a 3-step Newton solve in the SNR variable), fused over
  the grid;
* duals by projected subgradient ascent, warm-started from the previous
  round's ``ControllerState``, with a residual early exit. The whole
  ascent and the final best response are one call,
  ``kernels.dual_solve.dual_ascent``: one CUDA launch a round for CUDA
  tensors, with no host synchronization inside the loop (the iteration
  count comes back as a device int32), or the plain host loop for CPU
  tensors;
* greedy repair restores primal bandwidth feasibility after rounding.

This is the port of ``repro.core.fairenergy`` with the Newton solver (and
``bw_solver="gss"``, below): on the gamma grid or the joint (gamma, bits)
grid (``bits_grid``: each level charges the payload gamma*S*bits/32 + I
and earns the fidelity-discounted score), with optional outage-aware
pricing (``e_scale``). Bandwidth is
normalized to fractions b = B/B_tot; every float knob rides in
``FEParams`` as float32 0-d tensors on the solver's device, so the
arithmetic is the reference's float32 arithmetic.

``bw_solver="gss"`` is the reference's oracle: the best response by a
blind golden-section search on phi (``core.gss``) inside the same dual
ascent, as plain PyTorch on either device (the reference runs it outside
any kernel too). The fused ascent kernel is not used for it. Its search
ends on float32 noise in a flat minimum, so phi, the probes, the dual
step and the participation EMA are computed as XLA:CPU compiles the
reference (its FMAs and its order of sums; ROADMAP C-18).

``solver_fallback`` adds the reference's graceful degradation: after the
ascent, a diverged loop (cap hit, residual above tolerance and not
shrinking, read from the kernel's last two residuals) or a non-finite
observation replaces the decision by the eco fallback (``_guard``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..kernels.dual_solve.ops import dual_ascent
from ..kernels.dual_solve.ref import (dual_ascent_ref, joint_levels,
                                      selection_score)
from ..xla_math import fma_f32, log1p_xla
from .channel import LN2, RATE_B_FLOOR_HZ, RATE_EPS, comm_energy
from .fairness import contribution_score
from .gss import golden_section_minimize

Tensor = torch.Tensor

INV_LN2_F32 = float(1.0 / torch.tensor(LN2, dtype=torch.float32))


class RoundDecision(NamedTuple):
    x: Tensor          # [N] bool — selected
    gamma: Tensor      # [N] — sparsity ratio (valid where selected)
    bandwidth: Tensor  # [N] Hz — allocated bandwidth (0 where unselected)
    energy: Tensor     # [N] J — total (comm + comp) energy (0 where unselected)
    lam: Tensor        # scalar dual (normalized-bandwidth price)
    mu: Tensor         # [N] fairness duals
    n_inner: Tensor    # inner dual-ascent iterations actually run
    bw_used: Tensor    # sum of allocated bandwidth (Hz)
    fallback: Tensor = False  # True when the round came from the graceful-
    #                           degradation fallback (diverged duals or a
    #                           non-finite observation); always False
    #                           unless FEStatic.fallback is set
    bits: Tensor = None  # [N] decided quantization width (0 where
    #                      unselected); None off the joint grid


class FEParams(NamedTuple):
    """Solver scalars — hyper-parameters and channel constants — as
    float32 0-d tensors."""
    eta: Tensor
    rho: Tensor
    pi_min: Tensor
    alpha_lambda: Tensor
    alpha_mu: Tensor
    b_min_frac: Tensor
    dual_tol: Tensor
    b_tot: Tensor
    s_bits: Tensor
    i_bits: Tensor
    n0: Tensor


class FEStatic(NamedTuple):
    """Solver structure: the grids, the iteration caps, the bandwidth
    solver ("newton" or "gss") and the fallback guard. ``bits_grid``
    (32.0,) is the gamma-only solve; anything else the flat joint grid."""
    gamma_grid: tuple
    inner_iters: int
    newton_iters: int
    bits_grid: tuple = (32.0,)
    solver: str = "newton"
    gss_iters: int = 60
    fallback: bool = False


class ControllerState(NamedTuple):
    lam: Tensor
    mu: Tensor
    q: Tensor            # EMA participation metric
    params: FEParams
    e_cmp: Tensor        # [N] per-round computation energy (J); zeros =
                         # the communication-only objective


def make_params(cfg, *, b_tot: float, s_bits: float, i_bits: float,
                n0: float, device) -> FEParams:
    f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
    return FEParams(eta=f(cfg.eta), rho=f(cfg.rho), pi_min=f(cfg.pi_min),
                    alpha_lambda=f(cfg.alpha_lambda), alpha_mu=f(cfg.alpha_mu),
                    b_min_frac=f(cfg.b_min_frac),
                    dual_tol=f(getattr(cfg, "dual_tol", 0.0)),
                    b_tot=f(b_tot), s_bits=f(s_bits), i_bits=f(i_bits),
                    n0=f(n0))


def static_of(cfg) -> FEStatic:
    """The solver structure of ``cfg``."""
    solver = str(getattr(cfg, "bw_solver", "newton"))
    if solver not in ("newton", "gss"):
        raise ValueError(f"bw_solver must be 'newton' or 'gss', got "
                         f"{solver!r}")
    return FEStatic(gamma_grid=tuple(float(g) for g in cfg.gamma_grid),
                    inner_iters=int(cfg.inner_iters),
                    newton_iters=int(getattr(cfg, "newton_iters", 3)),
                    bits_grid=tuple(float(b) for b in
                                    getattr(cfg, "bits_grid", (32.0,))),
                    solver=solver,
                    gss_iters=int(getattr(cfg, "gss_max_iters", 60)),
                    fallback=bool(getattr(cfg, "solver_fallback", False)))


def init_state(cfg, n_clients: int, *, b_tot: float, s_bits: float,
               i_bits: float, n0: float, device, e_cmp=None
               ) -> ControllerState:
    """Fresh duals and participation EMA, with the solver scalars
    embedded, on ``device`` (the caller's resolved device, e.g. the
    controller context's). ``e_cmp`` is the [N] per-round computation
    energy (omitted: zeros, the communication-only objective)."""
    e_cmp = (torch.zeros(n_clients, dtype=torch.float32, device=device)
             if e_cmp is None
             else torch.as_tensor(e_cmp, dtype=torch.float32, device=device))
    if tuple(e_cmp.shape) != (n_clients,):
        raise ValueError(f"e_cmp must be [{n_clients}], got {tuple(e_cmp.shape)}")
    return ControllerState(
        lam=torch.zeros((), dtype=torch.float32, device=device),
        mu=torch.zeros(n_clients, dtype=torch.float32, device=device),
        q=torch.full((n_clients,), cfg.q0, dtype=torch.float32, device=device),
        params=make_params(cfg, b_tot=b_tot, s_bits=s_bits, i_bits=i_bits,
                           n0=n0, device=device),
        e_cmp=e_cmp)


def cumsum_blocked(x: Tensor, base: int = 16) -> Tensor:
    """Inclusive prefix sum of a 1-D float tensor in the association order
    of XLA:CPU's ``jnp.cumsum``: sequential sums inside blocks of
    ``base``, plus the exclusive prefix of the block totals (computed the
    same way, recursively). The greedy repair compares this sum with the
    budget 1.0, which the dual ascent drives it close to, so the order of
    the additions has to be the reference's for the two packages to keep
    the same clients."""
    n = x.shape[0]
    nb = -(-n // base)
    m = torch.nn.functional.pad(x, (0, nb * base - n)).reshape(nb, base)
    cols = [m[:, 0]]
    for j in range(1, base):
        cols.append(cols[-1] + m[:, j])
    inner = torch.stack(cols, dim=1)                        # [nb, base]
    if nb > 1:
        totals = cumsum_blocked(inner[:, -1], base)
        excl = torch.cat([totals.new_zeros(1), totals[:-1]])
        inner = inner + excl[:, None]
    return inner.reshape(-1)[:n]


def solve_round(u_norms: Tensor, h: Tensor, P: Tensor, state: ControllerState,
                *, fe_cfg, alive: Tensor = None, e_scale: Tensor = None
                ) -> tuple[RoundDecision, ControllerState]:
    """One round of Algorithm 1. All client quantities are [N] float32
    tensors on one device; the solver scalars come from ``state.params``.
    ``alive`` ([N] bool, default all true) hard-masks clients out of
    selection and waives their fairness duals. ``e_scale`` ([N], >= 1,
    default None) is the outage-aware comm-energy pricing factor
    ``1/(1 - p_out)`` (``core.link``): it multiplies E_cmm only, which is
    ``lam -> lam / e_scale`` in each client's bandwidth best response."""
    if alive is None:
        alive = torch.ones(u_norms.shape, dtype=torch.bool, device=u_norms.device)
    return _solve_round(u_norms, h, P, alive, state, static_of(fe_cfg),
                        e_scale)


def _solve_round(u_norms, h, P, alive, state: ControllerState,
                 static: FEStatic, e_scale=None
                 ) -> tuple[RoundDecision, ControllerState]:
    N = u_norms.shape[0]
    p = state.params
    e_cmp = state.e_cmp
    rho, eta = p.rho, p.eta
    # joint (gamma, bits) grid: the ascent also decides each width
    joint = tuple(static.bits_grid) != (32.0,)

    # the fused kernel (CUDA) or its plain host loop (CPU) on the Newton
    # best response; the golden-section oracle in the plain loop
    ascend = (dual_ascent if static.solver == "newton" else functools.partial(
        dual_ascent_ref, fused=True,
        solve=functools.partial(best_response_gss, iters=static.gss_iters)))
    asc = ascend(P, h, u_norms, state.lam, state.mu, state.q, alive,
                 gamma_grid=static.gamma_grid, eta=eta, rho=rho,
                 pi_min=p.pi_min, alpha_lambda=p.alpha_lambda,
                 alpha_mu=p.alpha_mu, dual_tol=p.dual_tol, b_tot=p.b_tot,
                 s_bits=p.s_bits, i_bits=p.i_bits, n0=p.n0,
                 b_lo=p.b_min_frac, inner_iters=static.inner_iters,
                 newton_iters=static.newton_iters, e_cmp=e_cmp,
                 e_scale=e_scale,
                 bits_grid=static.bits_grid if joint else None)
    lam, mu = asc.lam, asc.mu

    # primal extraction at the converged duals + greedy repair
    gamma_i, b_i, e_i, bits_i = asc.gamma, asc.b, asc.e, asc.bits
    benefit = eta * selection_score(u_norms, gamma_i, bits_i) \
        + mu * (1.0 - rho) - e_i - lam * b_i
    x = (benefit > 0) & alive

    # repair: greedy keep until the bandwidth budget fits. Clients whose
    # participation EMA would violate q >= pi_min if dropped go first,
    # then by benefit (stable sort: ties keep index order, as jnp.argsort)
    deficit = (p.pi_min - rho * state.q) > 0.0
    prio = torch.where(deficit, 1e6, 0.0) + benefit
    order = torch.argsort(torch.where(x, -prio, torch.inf), stable=True)
    x_sorted = x[order]
    cum = cumsum_blocked(b_i[order] * x_sorted)
    keep = torch.zeros(N, dtype=torch.bool, device=x.device)
    keep[order] = (cum <= 1.0) & x_sorted
    x = x & keep

    xf = x.to(torch.float32)
    bandwidth = xf * b_i * p.b_tot
    energy = xf * e_i
    # eq. (1) as XLA:CPU compiles the reference: the first product rounded
    # with the sum
    q_new = fma_f32(rho, state.q, (1.0 - rho) * xf).to(xf.device)
    dec = RoundDecision(x=x, gamma=torch.where(x, gamma_i, 0.0),
                        bandwidth=bandwidth, energy=energy, lam=lam, mu=mu,
                        n_inner=asc.n_inner,
                        bw_used=torch.sum(bandwidth),
                        bits=torch.where(x, bits_i, 0.0) if joint else None)
    if static.fallback:
        dec, q_new = _guard(dec, q_new, asc, u_norms, h, P, alive, state,
                            static, joint)
    return dec, ControllerState(lam=dec.lam, mu=dec.mu, q=q_new, params=p,
                                e_cmp=e_cmp)


def _guard(dec: RoundDecision, q_new: Tensor, asc, u_norms, h, P, alive,
           state: ControllerState, static: FEStatic, joint: bool):
    """Graceful degradation (``FairEnergyConfig.solver_fallback``): a
    diverged ascent or a poisoned observation must not leak garbage duals
    or energies into the carry. Divergence is the cap hit with the
    residual above tolerance and not shrinking (the kernel's last two
    residuals), or a non-finite residual; poisoned is any non-finite entry
    of the observation. Then the eco decision replaces the solve: the
    top-k clients by channel gain (k = max(1, N // 5)), an equal bandwidth
    split, the grid's cheapest gamma, no duals — and with a poisoned
    observation nothing at all, with the participation EMA frozen. Both
    decisions are formed and one is taken by ``torch.where``, so the
    guard adds no host synchronization. Returns the decision (its
    ``fallback`` set) and the participation EMA."""
    p = state.params
    n = u_norms.shape[0]
    obs_ok = (torch.all(torch.isfinite(u_norms)) & torch.all(torch.isfinite(h))
              & torch.all(torch.isfinite(P)))
    diverged = (((asc.n_inner >= static.inner_iters) & (asc.res > p.dual_tol)
                 & ~(asc.res < asc.res_prev)) | ~torch.isfinite(asc.res))
    use_fb = ~obs_ok | diverged
    k_fb = max(1, n // 5)
    g_fb = torch.tensor(static.gamma_grid[0], dtype=torch.float32,
                        device=h.device)
    b_each = torch.tensor(1.0 / k_fb, dtype=torch.float32, device=h.device)
    score_h = torch.where(torch.isfinite(h) & alive, h, -torch.inf)
    order = torch.argsort(-score_h, stable=True)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(n, device=h.device)
    e_fb = comm_energy(g_fb, b_each * p.b_tot, P, h, p.s_bits, p.i_bits,
                       p.n0) + state.e_cmp
    x_fb = ((ranks < k_fb) & alive & torch.isfinite(h) & torch.isfinite(e_fb)
            & obs_ok)
    xf_fb = x_fb.to(torch.float32)
    bw = xf_fb * b_each * p.b_tot
    # the fallback sends full-width payloads: width 32 where selected; the
    # duals revert to the warm start, whose iterates must not seed the
    # next round
    q_fb = torch.where(
        obs_ok, fma_f32(p.rho, state.q, (1.0 - p.rho) * xf_fb).to(h.device),
        state.q)
    pick = lambda fb, solved: torch.where(use_fb, fb, solved)  # noqa: E731
    dec = RoundDecision(
        x=pick(x_fb, dec.x), gamma=pick(torch.where(x_fb, g_fb, 0.0), dec.gamma),
        bandwidth=pick(bw, dec.bandwidth),
        energy=pick(torch.where(x_fb, e_fb, 0.0), dec.energy),
        lam=pick(state.lam, dec.lam), mu=pick(state.mu, dec.mu),
        n_inner=dec.n_inner, bw_used=pick(torch.sum(bw), dec.bw_used),
        fallback=use_fb,
        bits=(pick(torch.where(x_fb, 32.0, 0.0), dec.bits) if joint
              else None))
    return dec, pick(q_fb, q_new)


def best_response_gss(P: Tensor, h: Tensor, u_norms: Tensor, lam, *,
                      gamma_grid, eta, b_tot, s_bits, i_bits, n0, b_lo,
                      e_cmp: Tensor, e_scale: Tensor = None, bits_grid=None,
                      iters: int = 60, newton_iters: int = 3):
    """The reference's oracle best response (``best_response_gss`` in
    ``repro.core.fairenergy``), with ``dual_solve_ref``'s contract: per
    client, the golden-section minimum over b in [b_lo, 1] of the priced
    comm energy + lam b at every level, then the argmin over the levels of
    phi + E_cmp - eta * score (E_cmp, constant in b, added after the
    search). Returns ``(gamma*, b*, e*, phi*[, bits*])``. ``newton_iters``
    is ignored (it is the Newton solver's). phi, the probes and the
    level objective round as the reference's fused XLA:CPU program does
    (``xla_math.fma_f32``, ``log1p_xla``; ROADMAP C-18)."""
    n = P.shape[0]
    dev = P.device
    row = lambda v: torch.tensor(v, dtype=torch.float32, device=dev  # noqa: E731
                                 )[None, :].expand(n, len(v))
    if bits_grid is None:
        gam = gam_pay = row([float(g) for g in gamma_grid])
        gam_bits = fid = None
    else:
        levels = joint_levels(gamma_grid, bits_grid)
        gam = row([g for g, _ in levels])
        gam_bits = row([bt for _, bt in levels])
        gam_pay = row([g * bt / 32.0 for g, bt in levels])
        fid = torch.tensor([1.0 - 2.0 ** (1.0 - bt) for _, bt in levels],
                           dtype=torch.float32, device=dev)
    Pg, hg = P[:, None], h[:, None]

    def energy_factors(b_frac):
        """The priced comm energy at ``b_frac`` as its last product's two
        factors, computed as XLA:CPU compiles the reference's fused phi:
        the payload's product and sum rounded once (an FMA), the rate's
        division by ln 2 a product by its float32 reciprocal, XLA's
        log1p."""
        B = b_frac * b_tot
        Bc = torch.clamp(B, min=RATE_B_FLOOR_HZ)
        rate = (Bc * log1p_xla(Pg * hg / (n0 * Bc))) * INV_LN2_F32
        pay = fma_f32(gam_pay, s_bits, i_bits).to(dev)
        t = torch.where(B >= RATE_B_FLOOR_HZ,
                        pay / torch.clamp(rate, min=RATE_EPS), torch.inf)
        if e_scale is None:
            return Pg.expand_as(t), t
        return Pg * t, e_scale[:, None].expand_as(t)

    def priced_energy_of(b_frac):
        a, b = energy_factors(b_frac)
        return a * b

    score = contribution_score(u_norms[:, None], gam)
    if fid is not None:
        score = score * fid[None, :]
    b_star, phi_star = golden_section_minimize(
        lambda b: fma_f32(lam, b, priced_energy_of(b)).to(dev),
        torch.broadcast_to(torch.as_tensor(b_lo, dtype=torch.float32,
                                           device=dev), gam.shape),
        1.0, iters=iters)
    # the level objective and the energy, each product rounded with the
    # sum it feeds (as in the reference's fused program)
    phi_full = fma_f32(-eta, score, phi_star + e_cmp[:, None]).to(dev)
    g_idx = torch.argmin(phi_full, dim=1, keepdim=True)
    take = lambda t: torch.gather(t, 1, g_idx)[:, 0]  # noqa: E731
    a, b = energy_factors(b_star)
    out = (take(gam), take(b_star), fma_f32(take(a), take(b), e_cmp).to(dev),
           take(phi_full))
    return out if gam_bits is None else out + (take(gam_bits),)
