"""The fused dual ascent's rounds against the JAX package's ``solve_round``,
shared by ``test_torch_solver_ascent.py`` and
``test_torch_solver_ascent_grid40.py`` (split so that ``--dist loadfile``
gives the two halves to two workers): four warm-started rounds of
``dual_ascent_ref`` and ``solve_round`` against the reference's lam, mu,
n_inner, masks, gammas and widths.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import FairEnergyConfig as JFE
from repro.core.fairenergy import init_state as j_init
from repro.core.fairenergy import solve_round as j_solve

from repro_torch.configs.base import FairEnergyConfig as TFE
from repro_torch.core.fairenergy import init_state, solve_round, static_of
from repro_torch.kernels.dual_solve import ref

N0, S_BITS, I_BITS, B_TOT = 4e-21, 6.4e7, 2e6, 10e6
BITS = (8.0, 16.0, 32.0)
BITS40 = (4.0, 8.0, 16.0, 32.0)          # x the 10 default gammas: 40 levels
# (priced, joint grid)
VARIANTS = {"gamma": (False, False), "scaled": (True, False),
            "joint": (False, True), "joint_scaled": (True, True)}
EARLY_TOL = 0.3          # stops these draws' loop after 1-10 iterations


def draws(n, seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.5, 5.0, n).astype(np.float32)
    h = (1e-3 * rng.uniform(50, 500, n) ** -3.0
         * rng.exponential(1.0, n)).astype(np.float32)
    P = rng.uniform(1e-4, 3e-4, n).astype(np.float32)
    es = rng.uniform(1.0, 8.0, n).astype(np.float32)
    return u, h, P, es


def ascent_kwargs(state, static):
    p = state.params
    return dict(gamma_grid=static.gamma_grid, eta=p.eta, rho=p.rho,
                pi_min=p.pi_min, alpha_lambda=p.alpha_lambda,
                alpha_mu=p.alpha_mu, dual_tol=p.dual_tol, b_tot=p.b_tot,
                s_bits=p.s_bits, i_bits=p.i_bits, n0=p.n0, b_lo=p.b_min_frac,
                inner_iters=static.inner_iters, newton_iters=static.newton_iters, e_cmp=state.e_cmp,
                bits_grid=(static.bits_grid
                           if tuple(static.bits_grid) != (32.0,) else None))


def hold_rounds(variant, case, bits):
    priced, joint = VARIANTS[variant]
    n = 24
    u, h, P, es = draws(n, 3)
    kw = dict(eta_auto=False, eta=1e-3,
              bits_grid=bits if joint else (32.0,))
    if case == "early_exit":
        kw["dual_tol"] = EARLY_TOL
    jfe, tfe = JFE(**kw), TFE(**kw)
    alive = np.ones(n, bool)
    if case == "dead_clients":
        alive[[1, 6, 13, 20]] = False
    scal = dict(b_tot=B_TOT, s_bits=S_BITS, i_bits=I_BITS, n0=N0)
    js = j_init(jfe, n, **scal)
    ts = init_state(tfe, n, **scal, device="cpu")
    static = static_of(tfe)
    tu, th, tP = torch.tensor(u), torch.tensor(h), torch.tensor(P)
    t_alive, t_es = torch.tensor(alive), torch.tensor(es) if priced else None
    n_inner = []
    for r in range(4):
        asc = ref.dual_ascent_ref(tP, th, tu, ts.lam, ts.mu, ts.q, t_alive,
                                  **ascent_kwargs(ts, static), e_scale=t_es)
        with jax.threefry_partitionable(False):
            jd, js = j_solve(jnp.asarray(u), jnp.asarray(h), jnp.asarray(P),
                             js, fe_cfg=jfe, alive=jnp.asarray(alive),
                             e_scale=jnp.asarray(es) if priced else None)
        td, ts = solve_round(tu, th, tP, ts, fe_cfg=tfe, alive=t_alive,
                             e_scale=t_es)
        msg = f"{variant} {case} round {r}"
        assert int(asc.n_inner) == int(jd.n_inner) == int(td.n_inner), msg
        np.testing.assert_allclose(asc.lam.numpy(), np.asarray(jd.lam),
                                   rtol=1e-5, atol=1e-12, err_msg=msg)
        np.testing.assert_allclose(asc.mu.numpy(), np.asarray(jd.mu),
                                   rtol=1e-5, atol=1e-12, err_msg=msg)
        assert torch.equal(asc.lam, td.lam) and torch.equal(asc.mu, td.mu), msg
        np.testing.assert_array_equal(td.x.numpy(), np.asarray(jd.x), err_msg=msg)
        np.testing.assert_array_equal(td.gamma.numpy(), np.asarray(jd.gamma),
                                      err_msg=msg)
        if joint:
            np.testing.assert_array_equal(td.bits.numpy(), np.asarray(jd.bits),
                                          err_msg=msg)
        assert not td.x.numpy()[~alive].any(), msg
        n_inner.append(int(asc.n_inner))
    if case == "early_exit":            # the branch the main path never takes
        assert any(1 < k < static.inner_iters for k in n_inner), n_inner
    else:
        assert max(n_inner) == static.inner_iters, n_inner
