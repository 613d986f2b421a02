"""``repro_torch.core.fairenergy.solve_round`` against the JAX package's
solver, fed identical draws (the families of ``test_dual_solver.py`` and
``test_invariants.py``) over warm-started rounds.

Selection masks, gammas and ``n_inner`` must be exactly equal; the duals
``lam`` and ``mu``, the EMA ``q`` and the energies agree to rtol 1e-5
(atol 1e-12 for entries that are exactly 0 in one package and an ulp-level
residue in the other).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FairEnergyConfig as JFE
from repro.core.fairenergy import init_state as j_init
from repro.core.fairenergy import solve_round as j_solve

from repro_torch.configs.base import FairEnergyConfig as TFE
from repro_torch.core.fairenergy import init_state, solve_round
from test_torch_train import one_torch_thread  # noqa: F401  (torch on one thread)

N0, S_BITS, I_BITS, B_TOT = 4e-21, 6.4e7, 2e6, 10e6


def _draws(n, seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.5, 5.0, n).astype(np.float32)
    h = (1e-3 * rng.uniform(50, 500, n) ** -3.0
         * rng.exponential(1.0, n)).astype(np.float32)
    P = rng.uniform(1e-4, 3e-4, n).astype(np.float32)
    return u, h, P


def _run_both(u, h, P, rounds, alive=None, **fe_kw):
    jfe = JFE(eta_auto=False, **fe_kw)
    tfe = TFE(eta_auto=False, **fe_kw)
    n = u.shape[0]
    scal = dict(b_tot=B_TOT, s_bits=S_BITS, i_bits=I_BITS, n0=N0)
    js = j_init(jfe, n, **scal)
    ts = init_state(tfe, n, **scal, device="cpu")
    out = []
    for r in range(rounds):
        jd, js = j_solve(jnp.asarray(u), jnp.asarray(h), jnp.asarray(P), js,
                         fe_cfg=jfe, alive=None if alive is None
                         else jnp.asarray(alive))
        td, ts = solve_round(torch.tensor(u), torch.tensor(h), torch.tensor(P),
                             ts, fe_cfg=tfe, alive=None if alive is None
                             else torch.tensor(alive))
        out.append((jd, js, td, ts))
    return out


def _assert_same(jd, js, td, ts, r):
    msg = f"round {r}"
    np.testing.assert_array_equal(td.x.numpy(), np.asarray(jd.x), err_msg=msg)
    np.testing.assert_array_equal(td.gamma.numpy(), np.asarray(jd.gamma),
                                  err_msg=msg)
    assert int(td.n_inner) == int(jd.n_inner), msg
    for name in ("energy", "bandwidth", "lam", "mu", "bw_used"):
        np.testing.assert_allclose(getattr(td, name).numpy(),
                                   np.asarray(getattr(jd, name)),
                                   rtol=1e-5, atol=1e-12, err_msg=f"{name} {msg}")
    np.testing.assert_allclose(ts.q.numpy(), np.asarray(js.q), rtol=1e-5,
                               err_msg=msg)


@pytest.mark.parametrize("n,seed", [(8, 0), (24, 3), (50, 1), (50, 7)])
@pytest.mark.parametrize("eta", [3e-4, 1e-3, 3e-3])
def test_solve_round_matches_reference(n, seed, eta):
    u, h, P = _draws(n, seed)
    for r, (jd, js, td, ts) in enumerate(_run_both(u, h, P, 4, eta=eta)):
        _assert_same(jd, js, td, ts, r)


def test_dead_clients_and_dual_tol_zero_match():
    u, h, P = _draws(16, 11)
    alive = np.ones(16, bool)
    alive[[2, 5, 9]] = False
    for r, (jd, js, td, ts) in enumerate(
            _run_both(u, h, P, 3, alive=alive, eta=1e-3, dual_tol=0.0)):
        _assert_same(jd, js, td, ts, r)
        assert not td.x.numpy()[~alive].any()


def test_tie_heavy_repair_pins_stable_argsort():
    """Identical clients (equal benefit, equal bandwidth) force the greedy
    repair to break ties by index, which only a stable argsort does; the
    budget keeps only some of them."""
    n = 12
    u = np.full(n, 4.0, np.float32)
    h = np.full(n, 2e-10, np.float32)
    P = np.full(n, 2e-4, np.float32)
    for r, (jd, js, td, ts) in enumerate(_run_both(u, h, P, 3, eta=5e-3,
                                                   pi_min=0.0)):
        _assert_same(jd, js, td, ts, r)


D_CNN = 1_630_090          # the paper's FMNIST CNN (configs/fmnist_cnn.py)


def test_solve_round_matches_reference_at_the_main_path_setting():
    """The trainer's setting at full width: N = 50 on the paper channel
    (network seed 0, rounds 0-4 of Rayleigh fading), S = 32 D and I = D
    bits for D = 1,630,090, the default FairEnergyConfig with eta from
    each package's eta_auto calibration, warm-started over 5 rounds. The
    price iteration runs to its 30-iteration cap there (ROADMAP C-4), so
    this is where last-bit differences would show; masks, gammas and
    n_inner must be exactly equal, lam and energies rtol 1e-5."""
    import jax

    from repro.configs.base import ChannelConfig as JCh
    from repro.core.channel import WirelessNetwork as JNet
    from repro.core.controllers import ControllerContext as JCtx
    from repro.core.controllers import make_controller as j_make

    from repro_torch.core.controllers import ControllerContext as TCtx
    from repro_torch.core.controllers import make_controller as t_make

    ch = JCh()
    n = ch.n_clients
    ctx = dict(n_clients=n, b_tot=ch.bandwidth_total, s_bits=32.0 * D_CNN,
               i_bits=float(D_CNN), n0=ch.noise_density)
    jc = j_make("fairenergy", JCtx(**ctx, fe_cfg=JFE()))
    tc = t_make("fairenergy", TCtx(**ctx, fe_cfg=TFE(), device="cpu"))
    net = JNet(ch, seed=0)
    P = net.power.astype(np.float32)
    with jax.threefry_partitionable(False):
        hs = [net.gains(r).astype(np.float32) for r in range(5)]
    rng = np.random.default_rng(50)
    us = [rng.uniform(0.05, 0.5, n).astype(np.float32) for _ in range(5)]
    jc.calibrate(us[0], hs[0], P)
    tc.calibrate(us[0], hs[0], P)
    assert tc.fe_cfg.eta == jc.fe_cfg.eta
    js, ts = jc.init(n), tc.init(n)
    n_inner = []
    for r in range(5):
        jd, js = j_solve(jnp.asarray(us[r]), jnp.asarray(hs[r]), jnp.asarray(P),
                         js, fe_cfg=jc.fe_cfg)
        td, ts = solve_round(torch.tensor(us[r]), torch.tensor(hs[r]),
                             torch.tensor(P), ts, fe_cfg=tc.fe_cfg)
        _assert_same(jd, js, td, ts, r)
        n_inner.append(int(jd.n_inner))
    assert n_inner == [30] * 5, n_inner     # the cap, as on the card
