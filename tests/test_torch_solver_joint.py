"""The outage-priced and joint (gamma, bits) best responses and solver of
the port against the JAX package's.

``dual_solve_ref`` (what the port's wrapper runs for CPU tensors, and
what ``chip_smoke.py`` holds the CUDA kernels against) is compared with
the reference's jnp ``dual_solve_ref`` — the path the reference's solver
runs by default — and with its Pallas kernels in interpret mode, for the
three variants (scaled, joint, joint + scaled). gamma* and bits* must be
exactly equal; b*, e* and phi* agree to rtol 1e-5 (atol 1e-8 where phi*
crosses zero). No near-tie occurs on these draws, so the Pallas path,
which folds ``-ln e_scale`` into the stationarity base in another order,
picks the same levels too.

``solve_round`` with ``e_scale`` and/or ``bits_grid`` is run against the
reference over warm-started rounds: masks, gammas, bits and ``n_inner``
exactly equal; lam, the energies and the bandwidths to rtol 1e-5. Every
JAX call runs under ``jax.threefry_partitionable(False)``.
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
from repro.core.link import expected_attempts as j_expected
from repro.kernels.dual_solve import ops as j_ops
from repro.kernels.dual_solve import ref as j_ref

from repro_torch.configs.base import FairEnergyConfig as TFE
from repro_torch.core.fairenergy import init_state, solve_round
from repro_torch.core.link import expected_attempts as t_expected
from repro_torch.kernels.dual_solve.ops import (ascent_levels, dual_solve,
                                                level_table)
from repro_torch.kernels.dual_solve.ref import dual_solve_ref

GRID = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0)
BITS = (8.0, 16.0, 32.0)
N0, S_BITS, I_BITS, B_TOT = 4e-21, 6.4e7, 2e6, 10e6
VARIANTS = {"scaled": (True, None), "joint": (False, BITS),
            "joint_scaled": (True, BITS)}


def _inputs(n, seed=0):
    rng = np.random.default_rng(seed)
    P = rng.uniform(1e-4, 3e-4, n).astype(np.float32)
    h = (1e-3 * rng.uniform(50, 500, n) ** -3.0
         * rng.exponential(1.0, n)).astype(np.float32)
    u = rng.uniform(0.1, 5.0, n).astype(np.float32)
    e_cmp = rng.uniform(0.0, 1e-5, n).astype(np.float32)
    # expected attempts from 1 (lossless) to 1000 (the PRICE_P_CAP end)
    p_out = rng.uniform(0.0, 0.999, n).astype(np.float32)
    p_out[:2] = (0.0, 0.999)
    return P, h, u, e_cmp, p_out


def _scalars(lib):
    f = (lambda v: jnp.float32(v)) if lib == "jax" else \
        (lambda v: torch.tensor(v, dtype=torch.float32))
    return f, dict(eta=f(1e-3), b_tot=f(1e7), s_bits=f(S_BITS),
                   i_bits=f(I_BITS), n0=f(N0), b_lo=f(1e-4))


def _assert_outputs(got, want, msg):
    assert len(got) == len(want), msg
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]),
                                  err_msg=f"gamma* {msg}")
    if len(want) == 5:
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]),
                                      err_msg=f"bits* {msg}")
    for g, w, name in zip(got[1:4], want[1:4], ("b*", "e*", "phi*")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-8, err_msg=f"{name} {msg}")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("n", [8, 50])
def test_best_response_matches_ref_and_pallas(variant, n):
    scaled, bits_grid = VARIANTS[variant]
    P, h, u, ec, p_out = _inputs(n, seed=n)
    jf, jkw = _scalars("jax")
    tf, tkw = _scalars("torch")
    with jax.threefry_partitionable(False):
        j_es = j_expected(jnp.asarray(p_out)) if scaled else None
    t_es = t_expected(torch.tensor(p_out)) if scaled else None
    if scaled:
        np.testing.assert_array_equal(t_es.numpy(), np.asarray(j_es))
    jargs = tuple(map(jnp.asarray, (P, h, u)))
    targs = tuple(map(torch.tensor, (P, h, u)))
    for lam in (0.0, 1e-5, 1e-4, 3e-3, 0.2):
        kw = dict(gamma_grid=GRID, bits_grid=bits_grid)
        with jax.threefry_partitionable(False):
            want_ref = j_ref.dual_solve_ref(*jargs, jf(lam), **jkw, **kw,
                                            e_cmp=jnp.asarray(ec),
                                            e_scale=j_es)
            want_pallas = j_ops.dual_solve(*jargs, jf(lam), **jkw, **kw,
                                           e_cmp=jnp.asarray(ec),
                                           e_scale=j_es)
        got = dual_solve(*targs, tf(lam), **tkw, **kw,
                         e_cmp=torch.tensor(ec), e_scale=t_es)
        for want, what in ((want_ref, "ref"), (want_pallas, "pallas")):
            _assert_outputs(got, want, f"{variant} n={n} lam={lam} vs {what}")
    if bits_grid is not None:
        assert set(got[4].tolist()) <= set(bits_grid)


def test_unit_pricing_and_a_32_bit_grid_are_the_legacy_solve():
    P, h, u, ec, _ = _inputs(50)
    tf, tkw = _scalars("torch")
    args = tuple(map(torch.tensor, (P, h, u)))
    legacy = dual_solve(*args, tf(1e-4), gamma_grid=GRID, **tkw,
                        e_cmp=torch.tensor(ec))
    unit = dual_solve(*args, tf(1e-4), gamma_grid=GRID, **tkw,
                      e_cmp=torch.tensor(ec), e_scale=torch.ones(50))
    wide = dual_solve(*args, tf(1e-4), gamma_grid=GRID, **tkw,
                      e_cmp=torch.tensor(ec), bits_grid=(32.0,))
    for a, b, c in zip(legacy, unit, wide):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
        torch.testing.assert_close(c, a, rtol=0, atol=0)
    assert torch.equal(wide[4], torch.full((50,), 32.0))


def test_the_wrapper_takes_grids_beyond_32_levels():
    """The kernels take a grid of any size, as the reference does (C-15):
    33 and 100 levels are packed into the level table (5 blocks of L
    float32s, the buffer a CUDA launch reads), and on CPU tensors the
    wrapper runs the plain version on them and counts no launch."""
    P, h, u, _, _ = _inputs(8)
    tf, tkw = _scalars("torch")
    args = tuple(map(torch.tensor, (P, h, u)))
    before = {k: getattr(dual_solve, k) for k in
              ("launches", "launches_scaled", "launches_joint",
               "launches_joint_scaled")}
    for wide, L in ((dict(gamma_grid=tuple(range(1, 12)), bits_grid=BITS), 33),
                    (dict(gamma_grid=GRID, bits_grid=tuple(
                        float(b) for b in range(2, 32, 3))), 100)):
        table = ascent_levels(wide["gamma_grid"], wide["bits_grid"])
        assert len(table) == 5 * L
        assert level_table(wide["gamma_grid"], wide["bits_grid"],
                           torch.device("cpu")).shape == (5 * L,)
        got = dual_solve(*args, tf(1e-4), **wide, **tkw)
        want = dual_solve_ref(*args, tf(1e-4), **wide, **tkw)
        assert len(got) == 5
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    # CPU tensors run the plain version: no kernel launch is counted
    assert before == {k: getattr(dual_solve, k) for k in before}


def test_solve_round_takes_a_40_level_grid_as_the_reference_does():
    """C-15: bits 4, 8, 16, 32 over the default 10-point gamma grid is 40
    levels, past the 32 of one lane group of the fused kernel, which takes
    it; the plain version runs it here. Masks, gammas and widths equal the
    reference's, energies within rtol 1e-4, over 4 warm-started rounds."""
    bits_grid = (4.0, 8.0, 16.0, 32.0)
    assert len(TFE().gamma_grid) * len(bits_grid) == 40
    u, h, P, _ = _draws(8, 4)
    runs = _run_both(u, h, P, 4, bits_grid=bits_grid, eta=1e-3,
                     alpha_lambda=5e-5)
    for r, (jd, _, td, _) in enumerate(runs):
        np.testing.assert_array_equal(td.x.numpy(), np.asarray(jd.x),
                                      err_msg=f"round {r}")
        np.testing.assert_array_equal(td.gamma.numpy(), np.asarray(jd.gamma),
                                      err_msg=f"round {r}")
        np.testing.assert_array_equal(td.bits.numpy(), np.asarray(jd.bits),
                                      err_msg=f"round {r}")
        np.testing.assert_allclose(td.energy.numpy(), np.asarray(jd.energy),
                                   rtol=1e-4, atol=1e-12, err_msg=f"round {r}")
    assert any(bool((td.bits[td.x] < 32).any()) for _, _, td, _ in runs)


# --------------------------------------------------------------- solver ----
def _run_both(u, h, P, rounds, *, e_scale=None, bits_grid=None, **fe_kw):
    extra = {} if bits_grid is None else {"bits_grid": bits_grid}
    jfe = JFE(eta_auto=False, **fe_kw, **extra)
    tfe = TFE(eta_auto=False, **fe_kw, **extra)
    n = u.shape[0]
    scal = dict(b_tot=B_TOT, s_bits=S_BITS, i_bits=I_BITS, n0=N0)
    js = j_init(jfe, n, **scal)
    ts = init_state(tfe, n, **scal, device="cpu")
    out = []
    for r in range(rounds):
        with jax.threefry_partitionable(False):
            jd, js = j_solve(jnp.asarray(u), jnp.asarray(h), jnp.asarray(P),
                             js, fe_cfg=jfe, e_scale=None if e_scale is None
                             else jnp.asarray(e_scale))
        td, ts = solve_round(torch.tensor(u), torch.tensor(h),
                             torch.tensor(P), ts, fe_cfg=tfe,
                             e_scale=None if e_scale is None
                             else torch.tensor(e_scale))
        out.append((jd, js, td, ts))
    return out


def _assert_same(jd, js, td, ts, msg):
    np.testing.assert_array_equal(td.x.numpy(), np.asarray(jd.x), err_msg=msg)
    np.testing.assert_array_equal(td.gamma.numpy(), np.asarray(jd.gamma),
                                  err_msg=msg)
    assert (td.bits is None) == (jd.bits is None), msg
    if jd.bits is not None:
        np.testing.assert_array_equal(td.bits.numpy(), np.asarray(jd.bits),
                                      err_msg=msg)
    assert int(td.n_inner) == int(jd.n_inner), msg
    for name in ("energy", "bandwidth", "lam", "mu", "bw_used"):
        np.testing.assert_allclose(getattr(td, name).numpy(),
                                   np.asarray(getattr(jd, name)), rtol=1e-5,
                                   atol=1e-12, err_msg=f"{name} {msg}")
    np.testing.assert_allclose(ts.q.numpy(), np.asarray(js.q), rtol=1e-5,
                               err_msg=msg)


def _draws(n, seed):
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.5, 5.0, n).astype(np.float32)
    h = (1e-3 * rng.uniform(50, 500, n) ** -3.0
         * rng.exponential(1.0, n)).astype(np.float32)
    P = rng.uniform(1e-4, 3e-4, n).astype(np.float32)
    p_out = rng.uniform(0.2, 0.99, n).astype(np.float32)
    return u, h, P, np.asarray(1.0 / (1.0 - p_out), np.float32)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("eta", [1e-3, 3e-3])
def test_solve_round_matches_reference_at_n8(variant, eta):
    scaled, bits_grid = VARIANTS[variant]
    u, h, P, es = _draws(8, 4)
    runs = _run_both(u, h, P, 4, e_scale=es if scaled else None,
                     bits_grid=bits_grid, eta=eta, alpha_lambda=5e-5)
    for r, (jd, js, td, ts) in enumerate(runs):
        _assert_same(jd, js, td, ts, f"{variant} round {r}")
    if bits_grid is not None:
        assert any(bool((td.bits[td.x] < 32).any()) for _, _, td, _ in runs)


D_CNN = 1_630_090          # the paper's FMNIST CNN (configs/fmnist_cnn.py)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_solve_round_matches_reference_at_the_main_path_setting(variant):
    """N = 50 on the paper channel (network seed 0, rounds 0-4 of
    Rayleigh fading), S = 32 D and I = D bits for D = 1,630,090, the
    default config with eta from each package's eta_auto calibration and
    the variant's grid and pricing (expected attempts from a 6 dB margin's
    outage floor up to the cap), warm-started over 5 rounds."""
    from repro.configs.base import ChannelConfig as JCh
    from repro.core.channel import WirelessNetwork as JNet
    from repro.core.controllers import ControllerContext as JCtx
    from repro.core.controllers import make_controller as j_make

    from repro_torch.core.controllers import ControllerContext as TCtx
    from repro_torch.core.controllers import make_controller as t_make

    scaled, bits_grid = VARIANTS[variant]
    extra = {} if bits_grid is None else {"bits_grid": bits_grid}
    ch = JCh()
    n = ch.n_clients
    ctx = dict(n_clients=n, b_tot=ch.bandwidth_total, s_bits=32.0 * D_CNN,
               i_bits=float(D_CNN), n0=ch.noise_density)
    jc = j_make("fairenergy", JCtx(**ctx, fe_cfg=JFE(**extra)))
    tc = t_make("fairenergy", TCtx(**ctx, fe_cfg=TFE(**extra), device="cpu"))
    net = JNet(ch, seed=0)
    P = net.power.astype(np.float32)
    with jax.threefry_partitionable(False):
        hs = [net.gains(r).astype(np.float32) for r in range(5)]
    rng = np.random.default_rng(51)
    us = [rng.uniform(0.05, 0.5, n).astype(np.float32) for _ in range(5)]
    floor = 1.0 - np.exp(-1.0 / 10.0 ** 0.6)
    ps = [rng.uniform(floor, 0.999, n).astype(np.float32) for _ in range(5)]
    jc.calibrate(us[0], hs[0], P)
    tc.calibrate(us[0], hs[0], P)
    assert tc.fe_cfg.eta == jc.fe_cfg.eta
    js, ts = jc.init(n), tc.init(n)
    sel_bits = []
    for r in range(5):
        with jax.threefry_partitionable(False):
            j_es = j_expected(jnp.asarray(ps[r])) if scaled else None
            jd, js = j_solve(jnp.asarray(us[r]), jnp.asarray(hs[r]),
                             jnp.asarray(P), js, fe_cfg=jc.fe_cfg,
                             e_scale=j_es)
        t_es = t_expected(torch.tensor(ps[r])) if scaled else None
        td, ts = solve_round(torch.tensor(us[r]), torch.tensor(hs[r]),
                             torch.tensor(P), ts, fe_cfg=tc.fe_cfg,
                             e_scale=t_es)
        _assert_same(jd, js, td, ts, f"{variant} round {r}")
        if td.bits is not None:
            sel_bits += td.bits[td.x].tolist()
    if bits_grid is not None:
        assert min(sel_bits) < 32.0, sel_bits


def test_the_joint_grid_config_reaches_the_solver():
    fe = dataclasses.replace(TFE(eta_auto=False), bits_grid=(8, 32))
    from repro_torch.core.fairenergy import static_of
    assert static_of(fe).bits_grid == (8.0, 32.0)
    assert static_of(TFE()).bits_grid == (32.0,)
