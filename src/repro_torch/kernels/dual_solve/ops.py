"""Wrappers of the dual-solve kernels (``csrc/dual_solve.cu``).

``dual_solve`` has ``ref.dual_solve_ref``'s contract: per-client
``(gamma*, b*, e*, phi*)`` at bandwidth price ``lam``, plus ``bits*`` on
the joint (gamma, bits) grid. CPU tensors run the plain version; CUDA
tensors launch the one-step kernel on the current stream (one thread per
client, no padding), with the 7 scalars packed into a device float32
vector so the dual price never leaves the card for a launch, and the
per-level constants folded on the host as the plain version folds them
(``ascent_levels``), in the level table's device buffer.

``dual_ascent`` has ``ref.dual_ascent_ref``'s contract: Algorithm 1's
whole dual ascent and the best response at the final price, with the last
two residuals, returned as ``ref.Ascent``. CPU tensors run the plain host
loop; CUDA tensors launch the fused kernel once (one CTA), with 12
scalars in a device vector and the level table, per-level fidelity
included: the loop's exit test never reads the card from the host, and
the iteration count and the residuals come back as device tensors.

Both kernels take a grid of any size, as the plain versions and the
reference do: the level table is a device buffer of 5 x L float32s, made
once per (grid, device) and cached (``level_table``), so a round copies
nothing to the card for it. Launches are counted per variant on each
wrapper: ``.launches`` (gamma grid), ``.launches_scaled`` (with
``e_scale``), ``.launches_joint`` (with ``bits_grid``) and
``.launches_joint_scaled`` (both).
"""
from __future__ import annotations

import functools

import torch

from .. import _build, check_cuda, is_cpu
from .ref import (Ascent, dual_ascent_ref, dual_solve_ref, level_coefficients,
                  score_fidelity)

COUNTERS = {(False, False): "launches", (True, False): "launches_scaled",
            (False, True): "launches_joint", (True, True): "launches_joint_scaled"}


def dual_solve(P, h, u_norms, lam, *, gamma_grid, eta, b_tot, s_bits, i_bits,
               n0, b_lo, newton_iters: int = 3, e_cmp=None, e_scale=None,
               bits_grid=None):
    if e_cmp is None:
        e_cmp = torch.zeros_like(P)
    if is_cpu(P):
        return dual_solve_ref(P, h, u_norms, lam, gamma_grid=gamma_grid,
                              eta=eta, b_tot=b_tot, s_bits=s_bits,
                              i_bits=i_bits, n0=n0, b_lo=b_lo,
                              newton_iters=newton_iters, e_cmp=e_cmp,
                              e_scale=e_scale, bits_grid=bits_grid)
    dev = P.device
    table = level_table(gamma_grid, bits_grid, dev)
    n = P.shape[0]
    vectors = [("P", P), ("h", h), ("u_norms", u_norms), ("e_cmp", e_cmp)]
    if e_scale is not None:
        vectors.append(("e_scale", e_scale))
    for name, t in vectors:
        check_cuda(name, t, dtype=torch.float32, ndim=1, device=dev)
        if t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} clients, P has {n}")
    joint = bits_grid is not None
    scalars = torch.stack([torch.as_tensor(v, dtype=torch.float32, device=dev)
                           for v in (lam, eta, b_tot, s_bits, i_bits, n0,
                                     b_lo)])
    outs = [torch.empty(n, dtype=torch.float32, device=dev)
            for _ in range(5 if joint else 4)]
    err = _build.library().dual_solve_levels_f32(
        P.data_ptr(), h.data_ptr(), u_norms.data_ptr(), e_cmp.data_ptr(),
        None if e_scale is None else e_scale.data_ptr(), scalars.data_ptr(),
        table.data_ptr(), table.shape[0] // 5, int(newton_iters),
        n, *(o.data_ptr() for o in outs[:4]),
        outs[4].data_ptr() if joint else None,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "dual_solve_levels_f32")
    attr = COUNTERS[(e_scale is not None, joint)]
    setattr(dual_solve, attr, getattr(dual_solve, attr) + 1)
    return tuple(outs)


for _attr in COUNTERS.values():
    setattr(dual_solve, _attr, 0)


def level_table(gamma_grid, bits_grid, device: torch.device) -> torch.Tensor:
    """The kernels' level table (``ascent_levels``) as a float32 buffer of
    5 x L on ``device``, made on the first call for a (grid, device) and
    cached: a launch passes its pointer and copies nothing to the card.
    Every caller gets the same buffer; the kernels only read it."""
    return _level_table(tuple(gamma_grid),
                        None if bits_grid is None else tuple(bits_grid), device)


@functools.cache
def _level_table(gamma_grid: tuple, bits_grid: tuple | None,
                 device: torch.device) -> torch.Tensor:
    return torch.tensor(ascent_levels(gamma_grid, bits_grid),
                        dtype=torch.float32, device=device)


def ascent_levels(gamma_grid, bits_grid=None) -> list:
    """The fused kernel's level table, 5 blocks of L floats: gamma, payload
    gamma, score coefficient, width (0 off the joint grid) and the float32
    score fidelity of the width that the plain version's selection test
    multiplies in (``ref.score_fidelity``; 1 off the joint grid, where the
    test takes no fidelity)."""
    coef = level_coefficients(gamma_grid, bits_grid)
    n_levels = len(coef["gamma"])
    if coef["bits"] is None:
        bits, fid = [0.0] * n_levels, [1.0] * n_levels
    else:
        bits = coef["bits"]
        fid = score_fidelity(torch.tensor(bits, dtype=torch.float32)).tolist()
    return coef["gamma"] + coef["pay"] + coef["score"] + bits + fid


def ascent_scalars(*, lam, eta, b_tot, s_bits, i_bits, n0, b_lo, rho, pi_min,
                   alpha_lambda, alpha_mu, dual_tol, device) -> torch.Tensor:
    """The fused kernel's 12 float32 scalars as one vector on ``device``,
    built from the solver's 0-d tensors without a host round trip."""
    return torch.stack([torch.as_tensor(v, dtype=torch.float32, device=device)
                        for v in (lam, eta, b_tot, s_bits, i_bits, n0, b_lo, rho,
                                  pi_min, alpha_lambda, alpha_mu, dual_tol)])


def dual_ascent(P, h, u_norms, lam, mu, q, alive, *, gamma_grid, eta, rho,
                pi_min, alpha_lambda, alpha_mu, dual_tol, b_tot, s_bits,
                i_bits, n0, b_lo, inner_iters: int, newton_iters: int = 3,
                e_cmp=None, e_scale=None, bits_grid=None) -> Ascent:
    if e_cmp is None:
        e_cmp = torch.zeros_like(P)
    kw = dict(gamma_grid=gamma_grid, eta=eta, rho=rho, pi_min=pi_min,
              alpha_lambda=alpha_lambda, alpha_mu=alpha_mu, dual_tol=dual_tol,
              b_tot=b_tot, s_bits=s_bits, i_bits=i_bits, n0=n0, b_lo=b_lo,
              inner_iters=inner_iters, newton_iters=newton_iters, e_cmp=e_cmp,
              e_scale=e_scale, bits_grid=bits_grid)
    if is_cpu(P):
        return dual_ascent_ref(P, h, u_norms, lam, mu, q, alive, **kw)
    dev = P.device
    table = level_table(gamma_grid, bits_grid, dev)
    n = P.shape[0]
    if n < 1:
        raise ValueError("the dual ascent needs at least one client")
    vectors = [("P", P), ("h", h), ("u_norms", u_norms), ("e_cmp", e_cmp),
               ("mu", mu), ("q", q)]
    if e_scale is not None:
        vectors.append(("e_scale", e_scale))
    for name, t in vectors:
        check_cuda(name, t, dtype=torch.float32, ndim=1, device=dev)
        if t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} clients, P has {n}")
    check_cuda("alive", alive, dtype=torch.bool, ndim=1, device=dev)
    if alive.shape[0] != n:
        raise ValueError(f"alive has {alive.shape[0]} clients, P has {n}")
    scalars = ascent_scalars(lam=lam, eta=eta, b_tot=b_tot, s_bits=s_bits,
                             i_bits=i_bits, n0=n0, b_lo=b_lo, rho=rho,
                             pi_min=pi_min, alpha_lambda=alpha_lambda,
                             alpha_mu=alpha_mu, dual_tol=dual_tol, device=dev)
    joint = bits_grid is not None
    # gamma b e phi mu [bits] lam res res_prev in one buffer; the iteration
    # count apart
    buf = torch.empty((6 if joint else 5) * n + 3, dtype=torch.float32, device=dev)
    outs = [buf[j * n:(j + 1) * n] for j in range(6 if joint else 5)]
    lam_out, res_out = buf[-3], buf[-2:]
    n_out = torch.empty((), dtype=torch.int32, device=dev)
    err = _build.library().dual_ascent_f32(
        P.data_ptr(), h.data_ptr(), u_norms.data_ptr(), e_cmp.data_ptr(),
        None if e_scale is None else e_scale.data_ptr(), alive.data_ptr(),
        q.data_ptr(), mu.data_ptr(), scalars.data_ptr(),
        table.data_ptr(), table.shape[0] // 5, int(newton_iters),
        int(inner_iters), n, *(o.data_ptr() for o in outs[:4]),
        outs[5].data_ptr() if joint else None, outs[4].data_ptr(),
        lam_out.data_ptr(), res_out.data_ptr(), n_out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "dual_ascent_f32")
    attr = COUNTERS[(e_scale is not None, joint)]
    setattr(dual_ascent, attr, getattr(dual_ascent, attr) + 1)
    return Ascent(outs[0], outs[1], outs[2], outs[3],
                  outs[5] if joint else None, lam_out, outs[4], n_out,
                  res_out[0], res_out[1])


for _attr in COUNTERS.values():
    setattr(dual_ascent, _attr, 0)
