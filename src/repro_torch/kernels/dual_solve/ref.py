"""Plain PyTorch version of the FairEnergy bandwidth best-response.

The per-device subproblem of Algorithm 1's inner loop is

    min_{b in [b_lo, 1]}  phi(b) = E(gamma, b B_tot) + lam b,

with E = P D / R(B), R(B) = B log2(1 + c/B), c = P h / N0 and
D = gamma S + I. Its stationarity condition is 1-D in the SNR variable
t = c / B (Yang et al., arXiv:1911.02417):

    g(t) := t^2 A(t) / L(t)^2 = K,   L = ln(1+t), A = L - t/(1+t),
    K = lam c^2 / (P D B_tot ln 2),

solved by 3 Newton steps in u = ln t, all in log space (K overflows fp32
at strong channels). phi is unimodal in b, so the stationary point clipped
to [b_lo, 1] is the box minimum.

This is the port's copy of ``repro.kernels.dual_solve.ref`` — the
gamma-only grid, the outage-priced ``e_scale`` and the joint (gamma,
bits) grid — with the same operation order: it is what the wrappers in
``ops`` run for CPU tensors, and what ``chip_smoke.py`` holds the CUDA
kernels (``csrc/dual_solve.cu``) against. ``dual_ascent_ref`` is
Algorithm 1's projected subgradient loop around the best response (the
reference's ``lax.while_loop`` in ``repro.core.fairenergy``), run on the
host: the plain version of the fused ``dual_ascent`` kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...core import channel
from ...core.fairness import contribution_score
from ...xla_math import exp2_xla, fma_f32, sum_fused_xla

Tensor = torch.Tensor

LN2 = 0.6931471805599453


def newton_snr(ln_k: Tensor, iters: int = 3) -> Tensor:
    """Solve g(t) = exp(ln_k) for t by Newton in u = ln t, from a
    regime-blended initializer (3 steps reach the fp32 noise floor).
    Below t = 0.01 A(t) switches to its series, where log1p(t) - t/(1+t)
    would cancel."""
    ln_k = torch.clamp(ln_k, -45.0, 55.0)
    u_small = 0.5 * (ln_k + LN2)
    u_large = 0.5 * ln_k + 0.5 * torch.log(torch.clamp(0.5 * ln_k, min=1.0))
    u = torch.clamp(torch.where(ln_k > 2.0, u_large, u_small), -20.0, 25.0)
    for _ in range(iters):
        t = torch.exp(u)
        L = torch.log1p(t)
        one_t = 1.0 + t
        A = torch.where(t < 0.01,
                        0.5 * t * t * (1.0 - (4.0 / 3.0) * t + 1.5 * t * t),
                        L - t / one_t)
        tL = t / L
        F = torch.log(tL * tL * A) - ln_k
        dF = 2.0 + t * t / (one_t * one_t * A) - 2.0 * t / (one_t * L)
        u = torch.clamp(u - F / dF, -20.0, 25.0)
    return torch.exp(u)


def ln_k_gamma_free(P: Tensor, h: Tensor, *, n0, b_tot) -> Tensor:
    """The gamma- and lam-independent part of ln K:
    ln K = ln lam + ln_k_gamma_free - ln D."""
    c = channel.snr_coeff(P, h, n0)
    return 2.0 * torch.log(c) - torch.log(P) - torch.log(b_tot * LN2)


def ln_k_base(P: Tensor, h: Tensor, gamma: Tensor, *, b_tot, s_bits, i_bits,
              n0) -> Tensor:
    """The lam-independent part of ln K: ln K = ln lam + ln_k_base."""
    D = gamma * s_bits + i_bits
    return ln_k_gamma_free(P, h, n0=n0, b_tot=b_tot) - torch.log(D)


def bandwidth_best_response(lam, P: Tensor, h: Tensor, gamma: Tensor, *,
                            b_tot, s_bits, i_bits, n0, b_lo, iters: int = 3,
                            base: Tensor = None) -> Tensor:
    """argmin_{b in [b_lo, 1]} E(gamma, b B_tot) + lam b, elementwise.
    Returns the bandwidth fraction; ``base`` optionally supplies a
    precomputed ``ln_k_base``."""
    c = channel.snr_coeff(P, h, n0)
    if base is None:
        base = ln_k_base(P, h, gamma, b_tot=b_tot, s_bits=s_bits,
                         i_bits=i_bits, n0=n0)
    ln_k = torch.log(torch.clamp(torch.as_tensor(lam), min=1e-30)) + base
    t = newton_snr(ln_k, iters)
    b = c / (t * b_tot)
    return torch.clamp(torch.maximum(b, torch.as_tensor(b_lo)), max=1.0)


def score_fidelity(bits) -> Tensor:
    """Contribution retained after ``bits``-wide symmetric quantization:
    ``1 - 2^(1-bits)`` in float32 — exactly 1.0 at 32 bits, 0.9921875 at
    8. The power of two is XLA's exp2, as in the reference."""
    return 1.0 - exp2_xla(1.0 - torch.as_tensor(bits, dtype=torch.float32))


def joint_levels(gamma_grid, bits_grid) -> tuple:
    """The flat (gamma, bits) decision grid, gamma-major: ties in the
    argmin break to the lower flat index (lower gamma first, then the
    earlier bits_grid entry), as in the reference."""
    return tuple((float(g), float(bt)) for g in gamma_grid
                 for bt in bits_grid)


def level_coefficients(gamma_grid, bits_grid=None) -> dict:
    """Per-level float32 constants of the best response, folded in Python
    doubles and then cast, exactly as the reference folds them: the
    level's gamma, its payload gamma ``g*bt/32``, its score coefficient
    ``g*(1 - 2**(1-bt))`` and its width. Without ``bits_grid`` the
    payload and score coefficients are gamma itself and there are no
    widths."""
    if bits_grid is None:
        g = [float(v) for v in gamma_grid]
        return dict(gamma=g, pay=g, score=g, bits=None)
    levels = joint_levels(gamma_grid, bits_grid)
    return dict(gamma=[g for g, _ in levels],
                pay=[g * bt / 32.0 for g, bt in levels],
                score=[g * (1.0 - 2.0 ** (1.0 - bt)) for g, bt in levels],
                bits=[bt for _, bt in levels])


def dual_solve_ref(P: Tensor, h: Tensor, u_norms: Tensor, lam, *, gamma_grid,
                   eta, b_tot, s_bits, i_bits, n0, b_lo,
                   newton_iters: int = 3, e_cmp: Tensor = None,
                   e_scale: Tensor = None, bits_grid=None):
    """Per-client best response over the grid.

    For every client i and level: the bandwidth best-response at price
    ``lam``, then phi = E + lam b - eta ||u_i|| s_level, reduced over the
    levels with ties to the lower level (``torch.argmin`` returns the
    first minimum, as ``jnp.argmin`` does). ``e_cmp`` ([N], optional) is
    the per-client computation energy, added to E. The scalars are
    float32 0-d tensors (``FEParams``), as the solver carries them.

    ``e_scale`` ([N], optional, >= 1) prices the comm energy: E_cmm is
    multiplied per client, which is ``lam -> lam / e_scale`` in the
    best response, so ``-ln e_scale`` is subtracted from the
    stationarity base, ``ln lam + ((gfree - ln D) - ln es)``.

    ``bits_grid`` (tuple, optional) widens the decision to the flat
    ``joint_levels``: level (g, bt) charges the payload gamma ``g*bt/32``
    and earns the score ``g*(1 - 2**(1-bt))`` (``level_coefficients``).
    The return then grows a fifth element, ``bits*``.

    Returns ``(gamma*, b*, e*, phi*[, bits*])``, each [N]."""
    Pg, hg, ug = P[:, None], h[:, None], u_norms[:, None]        # [N,1]
    n = P.shape[0]
    coef = level_coefficients(gamma_grid, bits_grid)
    row = lambda v: torch.tensor(v, dtype=torch.float32, device=P.device  # noqa: E731
                                 )[None, :].expand(n, len(v))
    gam, gam_pay, score_g = row(coef["gamma"]), row(coef["pay"]), row(coef["score"])
    base = None
    if e_scale is not None:
        base = ln_k_base(Pg, hg, gam_pay, b_tot=b_tot, s_bits=s_bits,
                         i_bits=i_bits, n0=n0) - torch.log(e_scale)[:, None]
    b = bandwidth_best_response(lam, Pg, hg, gam_pay, b_tot=b_tot,
                                s_bits=s_bits, i_bits=i_bits, n0=n0,
                                b_lo=b_lo, iters=newton_iters, base=base)
    e = channel.comm_energy(gam_pay, b * b_tot, Pg, hg, s_bits, i_bits, n0)
    if e_scale is not None:
        e = e * e_scale[:, None]                                 # priced comm
    if e_cmp is not None:
        e = e + e_cmp[:, None]
    phi = e + lam * b - eta * ug * score_g
    g_idx = torch.argmin(phi, dim=1, keepdim=True)               # [N,1]
    take = lambda t: torch.gather(t, 1, g_idx)[:, 0]             # noqa: E731
    out = (take(gam), take(b), take(e), take(phi))
    if coef["bits"] is None:
        return out
    return out + (take(row(coef["bits"])),)


def selection_score(u_norms: Tensor, gamma: Tensor, bits: Tensor = None) -> Tensor:
    """The selection test's score at a decided level: ``||u|| gamma``,
    discounted on the joint grid by the float32 fidelity of the decided
    width ``bits`` (None off the joint grid)."""
    s = contribution_score(u_norms, gamma)
    return s if bits is None else s * score_fidelity(bits)


class Ascent(NamedTuple):
    """What the dual ascent returns: the best response at the final price
    ``lam`` (``bits`` None off the joint grid), the final duals, the
    number of iterations run (0-d int32), and the last two residuals
    (0-d float32, +inf before an iteration sets them): what the solver's
    fallback guard reads."""
    gamma: Tensor
    b: Tensor
    e: Tensor
    phi: Tensor
    bits: Tensor | None
    lam: Tensor
    mu: Tensor
    n_inner: Tensor
    res: Tensor
    res_prev: Tensor


def dual_ascent_ref(P: Tensor, h: Tensor, u_norms: Tensor, lam: Tensor,
                    mu: Tensor, q: Tensor, alive: Tensor, *, gamma_grid, eta,
                    rho, pi_min, alpha_lambda, alpha_mu, dual_tol, b_tot,
                    s_bits, i_bits, n0, b_lo, inner_iters: int,
                    newton_iters: int = 3, e_cmp: Tensor = None,
                    e_scale: Tensor = None, bits_grid=None,
                    solve=None, fused: bool = False) -> Ascent:
    """Algorithm 1's warm-started dual ascent with the residual early exit,
    then the best response at the final price.

    Each iteration: the best response at ``lam``; the selection test
    ``e + lam b < eta s + mu (1 - rho)`` among ``alive`` clients, with the
    score ``s = ||u|| gamma`` discounted by the float32 fidelity of the
    decided width on the joint grid; the clamped steps
    ``lam += alpha_lambda (sum x b - 1)`` and
    ``mu += alpha_mu alive (pi_min - rho q - (1 - rho) x)``; the residual
    ``max(|d lam| / alpha_lambda, max |d mu| / alpha_mu)`` (0/0-guarded).
    The first iteration always runs; the loop stops at ``inner_iters`` or
    once the residual is not above ``dual_tol``, read on the host (one
    synchronization an iteration on a device). The last residual and the
    one before it are returned (``res``, ``res_prev``), both +inf until
    an iteration sets them, as the reference's guarded loop carries them. The scalars are float32 0-d
    tensors (``FEParams``). ``solve`` is the best response
    (``dual_solve_ref`` by default; any function of its signature).

    ``fused=True`` computes the dual step as XLA:CPU compiles the
    reference's loop: each product that feeds one sum rounded with it
    once (``xla_math.fma_f32``: the selection test's ``lam b + e`` and
    ``mu (1 - rho) + eta s``, the price step, the fairness step) and the
    bandwidth sum in XLA's order (``xla_math.sum_fused_xla``: the
    vectorized loop XLA fuses the sum into). The GSS oracle
    takes it (ROADMAP C-18); the Newton path keeps the plain step, which
    its kernel holds to."""
    solve = dual_solve_ref if solve is None else solve
    joint = bits_grid is not None
    dev = P.device
    alive_f = alive.to(torch.float32)

    def best_response(lam):
        return solve(P, h, u_norms, lam, gamma_grid=gamma_grid, eta=eta,
                     b_tot=b_tot, s_bits=s_bits, i_bits=i_bits, n0=n0,
                     b_lo=b_lo, newton_iters=newton_iters, e_cmp=e_cmp,
                     e_scale=e_scale, bits_grid=bits_grid)

    def fused_step(lam, mu, e_i, b_i, s):
        x = (fma_f32(lam, b_i, e_i).to(dev)
             < fma_f32(eta, s, mu * (1.0 - rho)).to(dev)) & alive
        xf = x.to(torch.float32)
        new_lam = torch.clamp(fma_f32(alpha_lambda, sum_fused_xla(xf * b_i) - 1.0,
                                      lam).to(dev), min=0.0)
        drive = fma_f32(-(1.0 - rho), xf, fma_f32(-rho, q, pi_min)).to(dev)
        new_mu = torch.clamp(fma_f32(alpha_mu * alive_f, drive, mu).to(dev),
                             min=0.0)
        return new_lam, new_mu

    def dual_step(lam, mu):
        out = best_response(lam)
        gamma_i, b_i, e_i = out[0], out[1], out[2]
        s = selection_score(u_norms, gamma_i, out[4] if joint else None)
        if fused:
            return fused_step(lam, mu, e_i, b_i, s)
        x = (e_i + lam * b_i < eta * s + mu * (1.0 - rho)) & alive
        xf = x.to(torch.float32)
        # Algorithm 1 line 11: bandwidth dual (normalized budget = 1)
        new_lam = torch.clamp(
            lam + alpha_lambda * (torch.sum(xf * b_i) - 1.0), min=0.0)
        # Algorithm 1 line 9: fairness dual, waived for dead clients
        new_mu = torch.clamp(
            mu + alpha_mu * alive_f * (pi_min - rho * q - (1.0 - rho) * xf),
            min=0.0)
        return new_lam, new_mu

    def residual(new_lam, lam, new_mu, mu):
        # max(|d lam|/alpha_lambda, |d mu|/alpha_mu): the largest
        # constraint violation still moving the duals (0/0-guarded)
        return torch.maximum(
            torch.abs(new_lam - lam) / torch.clamp(alpha_lambda, min=1e-30),
            torch.max(torch.abs(new_mu - mu))
            / torch.clamp(alpha_mu, min=1e-30))

    n_inner = 0
    res = res_prev = torch.tensor(float("inf"), dtype=torch.float32,
                                  device=P.device)
    while n_inner < inner_iters:
        new_lam, new_mu = dual_step(lam, mu)
        res_prev, res = res, residual(new_lam, lam, new_mu, mu)
        lam, mu = new_lam, new_mu
        n_inner += 1
        if n_inner < inner_iters and not bool(res > dual_tol):
            break                                   # host sync: the exit

    out = best_response(lam)
    return Ascent(out[0], out[1], out[2], out[3], out[4] if joint else None,
                  lam, mu, torch.tensor(n_inner, dtype=torch.int32), res,
                  res_prev)
