"""The GSS oracle (``repro_torch.core.gss`` and ``solve_round`` with
``bw_solver="gss"``) against the JAX package's, and against the Newton
best response as ``tests/test_dual_solver.py`` holds them.

Against the reference: masks, gammas and iteration counts exactly equal.
After ~35 of its 60 steps the search brackets a few floats of a flat
minimum, and where it stops follows the last-bit rounding of phi, so the
port's oracle computes phi, the search's probes and the dual step as
XLA:CPU compiles the reference (``core.fairenergy.best_response_gss``,
``dual_ascent_ref(fused=True)``; ROADMAP C-18), the dual step's bandwidth
sum in the order of the loop XLA fuses it into (``sum_fused_xla``: 8
lanes, unrolled twice, from 16 clients to 32). Every case agrees to rtol
1e-5 (measured: bit for bit but the bandwidth total at N = 50, within
6.1e-8): the gamma grid with the default early exit, and outage pricing,
the joint grid and a capped ascent at N = 16 (which, summed one client
after another, ended 1.4e-4 apart in energies, 6.6e-4 in widths).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FairEnergyConfig as JFE
from repro.core.fairenergy import init_state as j_init
from repro.core.fairenergy import solve_round as j_solve
from repro.core.gss import golden_section_minimize as j_gss

from repro_torch.configs.base import FairEnergyConfig as TFE
from repro_torch.core.channel import comm_energy
from repro_torch.core.fairenergy import init_state, solve_round
from repro_torch.core.gss import golden_section_minimize
from repro_torch.kernels.dual_solve.ref import bandwidth_best_response
from test_torch_train import one_torch_thread  # noqa: F401  (torch on one thread)

N0, S_BITS, I_BITS, B_TOT = 4e-21, 6.4e7, 2e6, 10e6
GSS_RTOL = 1e-5            # C-18: where a flat minimum's search ends


def _draws(m, seed):
    rng = np.random.default_rng(seed)
    return dict(
        P=rng.uniform(1e-4, 3e-4, m).astype(np.float32),
        h=(1e-3 * rng.uniform(50, 500, m) ** -3.0
           * rng.exponential(1.0, m)).astype(np.float32),
        gamma=rng.uniform(0.1, 1.0, m).astype(np.float32),
        lam=(10.0 ** rng.uniform(-8, 1, m)).astype(np.float32),
        b_tot=(10.0 ** rng.uniform(6, 7.5, m)).astype(np.float32))


def _phi_torch(d):
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    return lambda b: (comm_energy(t["gamma"], b * t["b_tot"], t["P"], t["h"],
                                  S_BITS, I_BITS, N0) + t["lam"] * b)


def test_golden_section_matches_reference():
    """The search itself on a smooth bowl: the same minimum."""
    rng = np.random.default_rng(0)
    m = rng.uniform(0.1, 0.9, 512).astype(np.float32)
    lo = np.full(512, 0.01, np.float32)
    jx, jf = j_gss(lambda b: (b - jnp.asarray(m)) ** 2 + 1.0,
                   jnp.asarray(lo), 1.0, iters=40)
    tx, tf = golden_section_minimize(lambda b: (b - torch.from_numpy(m)) ** 2 + 1.0,
                                     torch.from_numpy(lo), 1.0, iters=40)
    assert tx.dtype == torch.float32
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-7)
    np.testing.assert_allclose(tx.numpy(), m, atol=1e-3)


def test_golden_section_on_phi_matches_reference():
    """60 iterations on the bandwidth objective phi (the oracle's use):
    the minimum values agree to float32 noise; the minimizers may sit at
    other points of the flat bottom (C-18), so each package's minimizer
    is held to the other's value."""
    from repro.core.channel import comm_energy as j_comm_energy
    d = _draws(2048, 3)
    b_lo = np.float32(2e-4)
    j = {k: jnp.asarray(v) for k, v in d.items()}

    def jphi(b):
        return j_comm_energy(j["gamma"], b * j["b_tot"], j["P"], j["h"],
                             S_BITS, I_BITS, N0) + j["lam"] * b
    jx, jf = j_gss(jphi, jnp.full((2048,), b_lo), 1.0, iters=60)
    phi = _phi_torch(d)
    tx, tf = golden_section_minimize(phi, torch.full((2048,), b_lo), 1.0,
                                     iters=60)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-5)
    at_j = phi(torch.from_numpy(np.array(jx))).numpy()
    np.testing.assert_allclose(at_j, tf.numpy(), rtol=1e-5)


def test_newton_never_loses_to_gss():
    """phi at the Newton b* never exceeds phi at the GSS b* beyond float32
    noise (``test_dual_solver.py``'s property, on the port's two)."""
    d = _draws(4096, 0)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    b_lo = torch.tensor(2e-4, dtype=torch.float32)
    b_n = bandwidth_best_response(t["lam"], t["P"], t["h"], t["gamma"],
                                  b_tot=t["b_tot"], s_bits=S_BITS,
                                  i_bits=I_BITS, n0=N0, b_lo=b_lo,
                                  iters=TFE().newton_iters)
    phi = _phi_torch(d)
    b_g, phi_g = golden_section_minimize(phi, torch.full_like(b_n, 2e-4), 1.0,
                                         iters=60)
    excess = ((phi(b_n) - phi_g) / torch.abs(phi_g)).numpy()
    assert excess.max() < 1e-5, excess.max()
    interior = ((b_n > 3e-4) & (b_n < 0.98)).numpy()
    rel = (torch.abs(phi(b_n) - phi_g) / torch.abs(phi_g)).numpy()[interior]
    assert rel.max() < 1e-5


def _solve_both(u, h, P, rounds, alive=None, e_scale=None, rtol=GSS_RTOL,
                **fe_kw):
    jfe = JFE(eta_auto=False, bw_solver="gss", **fe_kw)
    tfe = TFE(eta_auto=False, bw_solver="gss", **fe_kw)
    n = u.shape[0]
    scal = dict(b_tot=B_TOT, s_bits=S_BITS, i_bits=I_BITS, n0=N0)
    js, ts = j_init(jfe, n, **scal), init_state(tfe, n, **scal, device="cpu")
    for r in range(rounds):
        jd, js = j_solve(jnp.asarray(u), jnp.asarray(h), jnp.asarray(P), js,
                         fe_cfg=jfe,
                         alive=None if alive is None else jnp.asarray(alive),
                         e_scale=None if e_scale is None else jnp.asarray(e_scale))
        td, ts = solve_round(torch.tensor(u), torch.tensor(h), torch.tensor(P),
                             ts, fe_cfg=tfe,
                             alive=None if alive is None else torch.tensor(alive),
                             e_scale=None if e_scale is None else torch.tensor(e_scale))
        msg = f"round {r}"
        np.testing.assert_array_equal(td.x.numpy(), np.asarray(jd.x), err_msg=msg)
        np.testing.assert_array_equal(td.gamma.numpy(), np.asarray(jd.gamma),
                                      err_msg=msg)
        assert int(td.n_inner) == int(jd.n_inner), msg
        for name in ("energy", "bandwidth", "lam", "mu", "bw_used"):
            np.testing.assert_allclose(getattr(td, name).numpy(),
                                       np.asarray(getattr(jd, name)),
                                       rtol=rtol, atol=1e-12,
                                       err_msg=f"{name} {msg}")
        if jd.bits is not None:
            np.testing.assert_array_equal(td.bits.numpy(), np.asarray(jd.bits))
    return td


@pytest.mark.parametrize("n,seed,eta", [(8, 0, 1e-3), (24, 3, 3e-4),
                                        (50, 1, 1e-3)])
def test_solve_round_gss_matches_reference(n, seed, eta):
    d = _draws(n, seed)
    u = np.random.default_rng(seed + 100).uniform(0.5, 5.0, n).astype(np.float32)
    with jax.threefry_partitionable(False):
        _solve_both(u, d["h"], d["P"], 3, eta=eta)


def test_solve_round_gss_dead_clients_pricing_and_joint_grid():
    """Dead clients, outage pricing (``e_scale``) and the joint (gamma,
    bits) grid through the oracle."""
    n = 16
    d = _draws(n, 11)
    rng = np.random.default_rng(5)
    u = rng.uniform(0.5, 5.0, n).astype(np.float32)
    alive = np.ones(n, bool)
    alive[[2, 9]] = False
    es = rng.uniform(1.0, 1.5, n).astype(np.float32)
    td = _solve_both(u, d["h"], d["P"], 2, alive=alive, e_scale=es, eta=1e-3,
                     dual_tol=0.0, bits_grid=(8.0, 16.0, 32.0))
    assert not td.x.numpy()[~alive].any()


def test_gss_and_newton_agree_on_decisions():
    """The port's Newton and GSS solvers pick the same masks and gammas
    over warm-started rounds (``test_solver_paths_agree_on_decisions``)."""
    rng = np.random.default_rng(3)
    n = 24
    u = torch.tensor(rng.uniform(0.5, 5.0, n), dtype=torch.float32)
    h = torch.tensor(1e-3 * rng.uniform(50, 500, n) ** -3.0
                     * rng.exponential(1.0, n), dtype=torch.float32)
    P = torch.tensor(rng.uniform(1e-4, 3e-4, n), dtype=torch.float32)
    trajs = {}
    for name, kw in [("newton", {}), ("gss", dict(bw_solver="gss", dual_tol=0.0))]:
        fe = TFE(eta=1e-3, eta_auto=False, **kw)
        st = init_state(fe, n, b_tot=B_TOT, s_bits=S_BITS, i_bits=I_BITS,
                        n0=N0, device="cpu")
        outs = []
        for _ in range(4):
            dec, st = solve_round(u, h, P, st, fe_cfg=fe)
            outs.append(dec)
        trajs[name] = outs
    for r in range(4):
        a, b = trajs["newton"][r], trajs["gss"][r]
        np.testing.assert_array_equal(a.x.numpy(), b.x.numpy(), err_msg=str(r))
        np.testing.assert_array_equal(a.gamma.numpy(), b.gamma.numpy(),
                                      err_msg=str(r))


def test_gss_takes_no_dual_ascent_kernel_launch():
    """The oracle runs the plain loop on any device: the fused ascent's
    wrapper (which counts its launches) is never called."""
    from repro_torch.kernels.dual_solve import ops
    d = _draws(8, 2)
    fe = dataclasses.replace(TFE(eta=1e-3, eta_auto=False), bw_solver="gss")
    st = init_state(fe, 8, b_tot=B_TOT, s_bits=S_BITS, i_bits=I_BITS, n0=N0,
                    device="cpu")
    calls = []
    orig = ops.dual_ascent
    import repro_torch.core.fairenergy as fem
    fem.dual_ascent = lambda *a, **k: calls.append(1) or orig(*a, **k)
    try:
        dec, _ = solve_round(torch.tensor(d["gamma"]), torch.tensor(d["h"]),
                             torch.tensor(d["P"]), st, fe_cfg=fe)
    finally:
        fem.dual_ascent = orig
    assert not calls and dec.x.dtype == torch.bool
