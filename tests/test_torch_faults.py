"""Faults, defended aggregation and the solver fallback
(``repro_torch.core.faults``, ``FairEnergyConfig.solver_fallback`` and the
trainer's fault path) against the JAX package.

The draws (crash, corruption, channel estimate, presence and arrivals)
bit for bit; ``corrupt_payload``'s four modes; the defended aggregator on
the same matrices (screen, clip, trimmed mean, with and without the
screen); the fused ascent's plain version's last two residuals against
the reference's guarded loop in the four variants; ``solver_fallback``
off/on on a converged, an oscillating and a poisoned round; on the
12-round MLP of ``tests/test_scan_engine.make_trainer``: the churn and
byzantine-lite goldens (reproduced bit for bit by the reference under
``jax.threefry_partitionable(False)``), disabled faults against the main
golden, live reference runs of crashes (untimed, timed and on the lossy
uplink's retry timeline), corruption with and without the defense,
channel-estimate error and churn, the fault lanes of ``run_sweep``, and
byzantine-lite sharded over 2 gloo ranks against the unsharded port.

Gates: masks, ``n_faulted``, ``n_rejected`` and ``fallback`` exactly
equal; energies rtol 1e-4; accuracy within 1/128; ``clip_frac`` within
1e-6.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ChannelConfig as JCh
from repro.configs import FairEnergyConfig as JFE
from repro.core import faults as jf
from repro.core.fairenergy import init_state as j_init
from repro.core.fairenergy import solve_round as j_solve
from repro.core.rounds import AsyncConfig as JAsync
from repro.kernels.dual_solve import ref as j_ds
from repro.scenarios import get_scenario as j_get

from repro_torch import random as prng
from repro_torch.configs import ChannelConfig, FairEnergyConfig
from repro_torch.core import faults as tf
from repro_torch.core.fairenergy import init_state, solve_round, static_of
from repro_torch.core.rounds import AsyncConfig
from repro_torch.kernels.dual_solve import ref as t_ds
from repro_torch.scenarios import get_scenario

from test_torch_rounds import assert_timed_equal
from test_torch_trainer import ACC_TOL, N_CLIENTS, ROUNDS, _mlp_data
from torch_dist import (history_arrays, mlp_trainer, sharded_trainer_body,
                        spawn)
from test_torch_train import one_torch_thread  # noqa: F401  (torch on one thread)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
S_BITS, I_BITS = 6.4e7, 2e6


def _torch(**kw):
    return mlp_trainer(_mlp_data()[0], **kw)


# ------------------------------------------------------------------ draws ----
@pytest.mark.parametrize("seed,r", [(42, 0), (42, 3), (7, 17), (0, 1000)])
def test_draws_match_the_reference_bit_for_bit(seed, r):
    tkey, h = prng.PRNGKey(seed), np.float32([1e-9, 2e-9, 3e-9, 5e-11, 1e-12])
    with jax.threefry_partitionable(False):
        jkey = jax.random.PRNGKey(seed)
        for rate in (0.0, 0.3, 1.0):
            for t_fn, j_fn in ((tf.crash_draw, jf.crash_draw),
                               (tf.corrupt_draw, jf.corrupt_draw)):
                tm, tu = t_fn(tkey, r, 16, rate)
                jm, ju = j_fn(jkey, jnp.int32(r), 16, rate)
                np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
                np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        for sigma in (0.0, 0.25, 0.5):
            got = tf.channel_estimate(tkey, r, torch.tensor(h), sigma)
            want = jf.channel_estimate(jkey, jnp.int32(r), jnp.asarray(h), sigma)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for away, dwell in ((0.3, 0), (0.3, 4), (0.5, 3), (0.0, 4)):
            for rr in (r, r + 1):
                np.testing.assert_array_equal(
                    tf.presence_mask(tkey, rr, 12, away, dwell).numpy(),
                    np.asarray(jf.presence_mask(jkey, jnp.int32(rr), 12,
                                                away, dwell)))
                tp, ta = tf.arrival_mask(tkey, rr, 12, away, dwell)
                jp, ja = jf.arrival_mask(jkey, jnp.int32(rr), 12, away, dwell)
                np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
                np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    assert not tf.arrival_mask(tkey, 0, 12, 0.3, 4)[1].any()


def test_corrupt_payload_modes_match_the_reference():
    rng = np.random.default_rng(0)
    upd = rng.normal(size=(6, 10)).astype(np.float32)
    mask = np.array([True, False, True, False, True, True])
    flavor = np.float32([0.1, 0.1, 0.5, 0.5, 0.9, 1.0 / 3.0])
    for mode in tf.CORRUPT_MODES:
        got = tf.corrupt_payload(torch.tensor(upd), torch.tensor(mask),
                                 torch.tensor(flavor), mode, 1e3).numpy()
        want = np.asarray(jf.corrupt_payload(jnp.asarray(upd), mask, flavor,
                                             mode, 1e3))
        np.testing.assert_array_equal(got, want, err_msg=mode)
        np.testing.assert_array_equal(got[~mask], upd[~mask])


def test_configs_and_registry():
    assert not tf.FaultConfig().enabled
    for kw in (dict(crash_rate=0.1), dict(corrupt_rate=0.1),
               dict(h_err_std=0.1), dict(churn_dwell=4)):
        assert tf.FaultConfig(**kw).enabled
        assert (dataclasses.asdict(tf.FaultConfig(**kw))
                == dataclasses.asdict(jf.FaultConfig(**kw)))
    for kw in (dict(crash_rate=1.5), dict(corrupt_rate=-0.1),
               dict(corrupt_mode="garbage"), dict(churn_dwell=-1),
               dict(churn_away=2.0), dict(corrupt_scale=0.0)):
        with pytest.raises(ValueError):
            tf.FaultConfig(**kw)
    for kw in (dict(clip_q=1.0), dict(trim_frac=0.5), dict(clip_mult=0.0),
               dict(clip_beta=0.0)):
        with pytest.raises(ValueError):
            tf.DefenseConfig(**kw)
    assert {"mean", "defended"} <= set(tf.available_aggregators())
    mean = tf.make_aggregator("mean")
    assert isinstance(mean, tf.MeanAggregator) and not mean.enabled
    assert mean.init() is None
    assert tf.make_aggregator("defended", tf.DefenseConfig()).enabled
    with pytest.raises(KeyError):
        tf.make_aggregator("nope")
    with pytest.raises(TypeError):
        tf.make_aggregator(object())


# ------------------------------------------------------------- aggregator ----
def _poisoned_matrix(n=8, d=300, seed=2):
    rng = np.random.default_rng(seed)
    sparse = rng.normal(size=(n, d)).astype(np.float32)
    sparse[1] = np.nan                                # poisoned rows
    sparse[2, 7] = np.inf
    sparse[3] *= np.float32(-1e3)                     # scaled outlier
    sparse[4] = 0.0                                   # a zero row
    part = np.float32([1, 1, 1, 1, 1, 1, 0, 1])
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return sparse, part, w


@pytest.mark.parametrize("cfg", [
    dict(), dict(finite_screen=False), dict(trim_frac=0.1),
    dict(trim_frac=0.25, clip_q=0.0), dict(clip_q=0.9, clip_mult=2.0),
    dict(finite_screen=False, trim_frac=0.2)], ids=str)
def test_defended_aggregator_matches_the_reference(cfg):
    """Three rounds of the aggregator on the same matrices (the tracker
    bootstraps in the first, clips from the second): stats exact, the
    tracker, the cleaned rows and the combined pair at float32 rounding."""
    sparse, part, w = _poisoned_matrix()
    t_agg = tf.make_aggregator("defended", tf.DefenseConfig(**cfg))
    j_agg = jf.make_aggregator("defended", jf.DefenseConfig(**cfg))
    t_st, j_st = t_agg.init("cpu"), j_agg.init()
    for rnd in range(3):
        tp, tw, t_st, t_stats, t_clean = t_agg(
            torch.tensor(sparse), torch.tensor(part), torch.tensor(w), t_st)
        jp, jw, j_st, j_stats, j_clean = j_agg(
            jnp.asarray(sparse), jnp.asarray(part), jnp.asarray(w), j_st)
        msg = f"{cfg} round {rnd}"
        for k in ("n_rejected", "n_clipped"):
            assert int(t_stats[k]) == int(j_stats[k]), msg
        assert (t_st is None) == (j_st == ()), msg
        if t_st is not None:
            np.testing.assert_allclose(float(t_st.tau), float(j_st.tau),
                                       rtol=1e-6, err_msg=msg)
        np.testing.assert_allclose(t_clean.numpy(), np.asarray(j_clean),
                                   rtol=1e-6, atol=0, err_msg=msg)
        np.testing.assert_allclose(float(tw), float(jw), rtol=1e-6, err_msg=msg)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5,
                                   atol=1e-5, err_msg=msg)
        assert tp.dtype == torch.float64


def test_defended_aggregator_quantile_and_mean_path():
    t_vals = torch.tensor([3.0, 1.0, float("inf"), 2.0, 5.0])
    mask = torch.tensor([True, True, False, True, False])
    for q in (0.0, 0.5, 0.9):
        got = tf.defense._masked_quantile(t_vals, mask, q)
        want = jf.defense._masked_quantile(jnp.asarray(t_vals.numpy()),
                                           jnp.asarray(mask.numpy()), q)
        assert float(got) == float(want)
    assert float(tf.defense._masked_quantile(t_vals, mask & False, 0.5)) == 0.0
    sparse, part, w = _poisoned_matrix()
    sparse = np.nan_to_num(sparse, nan=0.0, posinf=0.0)
    tp, tw, _, stats, clean = tf.MeanAggregator()(
        torch.tensor(sparse), torch.tensor(part), torch.tensor(w), None)
    jp, jw, _, _, _ = jf.MeanAggregator()(jnp.asarray(sparse),
                                          jnp.asarray(part), jnp.asarray(w), ())
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-6)
    assert stats == {} and torch.equal(clean, torch.tensor(sparse))


# ---------------------------------------------------------------- goldens ----
@pytest.mark.parametrize("name,fname", [
    ("churn", "churn_fairenergy_12round.json"),
    ("byzantine-lite", "byzantine_fairenergy_12round.json")])
def test_fault_scenario_golden(name, fname):
    g = json.load(open(os.path.join(GOLDEN_DIR, fname)))
    scn = get_scenario(name)
    tr = _torch(device_profile=scn.device_profile(N_CLIENTS, seed=0),
                fault_cfg=scn.fault_config(), defense=scn.defense_config())
    tr.run_scanned(ROUNDS, verbose=False)
    assert len(tr.history) == g["rounds"] == ROUNDS
    for r, lg in enumerate(tr.history):
        msg = f"{name} round {r}"
        np.testing.assert_array_equal(lg.selected.astype(int),
                                      g["selected"][r], err_msg=msg)
        np.testing.assert_allclose(lg.total_energy, g["total_energy"][r],
                                   rtol=1e-4, err_msg=msg)
        assert abs(lg.accuracy - g["accuracy"][r]) <= ACC_TOL, msg
        assert lg.n_faulted == g["n_faulted"][r], msg
        assert lg.n_rejected == g["n_rejected"][r], msg
        assert lg.clip_frac == pytest.approx(g["clip_frac"][r], abs=1e-6), msg
        assert lg.fallback == g["fallback"][r], msg
    assert sum(g["n_faulted"]) > 0


def test_disabled_faults_keep_the_legacy_round():
    """A disabled ``FaultConfig`` (and no defense) is the legacy round,
    bit for bit the port's run without it, with no fault lanes; the
    defended aggregator at fault rate zero changes nothing either (the
    screen passes every row, the clip never binds), and reports no
    rejection or clip."""
    g = json.load(open(os.path.join(GOLDEN_DIR,
                                    "fairenergy_main_12round.json")))
    base = _torch()
    base.run_scanned(ROUNDS, verbose=False)
    off = _torch(fault_cfg=tf.FaultConfig())
    assert off._fault_rt is None and off.carry.fstate is None
    off.run_scanned(ROUNDS, verbose=False)
    defended = _torch(defense=tf.DefenseConfig())
    assert defended.aggregator.enabled
    defended.run_scanned(ROUNDS, verbose=False)
    for r, (a, b, c) in enumerate(zip(base.history, off.history,
                                      defended.history)):
        for k in ("selected", "gamma", "energy", "battery"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
            np.testing.assert_array_equal(getattr(a, k), getattr(c, k))
        assert a.accuracy == b.accuracy == c.accuracy == g["accuracy"][r]
        np.testing.assert_array_equal(a.selected.astype(int), g["selected"][r])
        assert b.n_faulted is None and b.fallback is None
        assert (c.n_rejected, c.clip_frac, c.n_faulted) == (0, 0.0, 0)
    for k in base.params:
        assert torch.equal(base.params[k], off.params[k])
        assert torch.equal(base.params[k], defended.params[k])


# --------------------------------------------------------- solver fallback ----
def _solver_fixture(n=8, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.uniform(1, 5, n).astype(np.float32)
    h = (1e-3 * rng.uniform(50, 300, n) ** -3.0).astype(np.float32)
    P = rng.uniform(1e-4, 3e-4, n).astype(np.float32)
    return u, h, P


def _solve_both(kw, u, h, P, rounds=1, e_scale=None):
    """``solve_round`` of both packages on the same observation for
    ``rounds`` warm-started rounds: [(j_dec, j_state, t_dec, t_state)]."""
    n = u.shape[0]
    ch = ChannelConfig(n_clients=n)
    scal = dict(b_tot=ch.bandwidth_total, s_bits=S_BITS, i_bits=I_BITS,
                n0=ch.noise_density)
    jfe, tfe = JFE(**kw), FairEnergyConfig(**kw)
    js, ts = j_init(jfe, n, **scal), init_state(tfe, n, **scal, device="cpu")
    out = []
    for _ in range(rounds):
        jd, js = j_solve(jnp.asarray(u), jnp.asarray(h), jnp.asarray(P), js,
                         fe_cfg=jfe, e_scale=None if e_scale is None
                         else jnp.asarray(e_scale))
        td, ts = solve_round(torch.tensor(u), torch.tensor(h), torch.tensor(P),
                             ts, fe_cfg=tfe, e_scale=None if e_scale is None
                             else torch.tensor(e_scale))
        out.append((jd, js, td, ts))
    return out


def _assert_same_decision(jd, js, td, ts, msg):
    assert bool(td.fallback) == bool(jd.fallback), msg
    np.testing.assert_array_equal(td.x.numpy(), np.asarray(jd.x), err_msg=msg)
    np.testing.assert_array_equal(td.gamma.numpy(), np.asarray(jd.gamma),
                                  err_msg=msg)
    assert int(td.n_inner) == int(jd.n_inner), msg
    np.testing.assert_allclose(td.energy.numpy(), np.asarray(jd.energy),
                               rtol=1e-5, err_msg=msg)
    np.testing.assert_allclose(td.bandwidth.numpy(), np.asarray(jd.bandwidth),
                               rtol=1e-5, err_msg=msg)
    for k in ("lam", "mu", "q"):
        np.testing.assert_allclose(getattr(ts, k).numpy(),
                                   np.asarray(getattr(js, k)), rtol=1e-5,
                                   atol=1e-12, err_msg=f"{msg} {k}")
    assert (td.bits is None) == (jd.bits is None), msg
    if jd.bits is not None:
        np.testing.assert_array_equal(td.bits.numpy(), np.asarray(jd.bits))


@pytest.mark.parametrize("bits_grid", [(32.0,), (8.0, 16.0, 32.0)],
                         ids=["gamma", "joint"])
def test_fallback_off_and_on_identical_when_converged(bits_grid):
    u, h, P = _solver_fixture()
    base = dict(eta=1e-3, eta_auto=False, bits_grid=bits_grid)
    for (jd0, js0, td0, ts0), (jd1, js1, td1, ts1) in zip(
            _solve_both(base, u, h, P, rounds=3),
            _solve_both(dict(base, solver_fallback=True), u, h, P, rounds=3)):
        assert not bool(td1.fallback) and not bool(td0.fallback)
        _assert_same_decision(jd1, js1, td1, ts1, "on")
        for k in ("x", "gamma", "energy", "bandwidth"):
            assert torch.equal(getattr(td0, k), getattr(td1, k)), k
        for k in ("lam", "mu", "q"):
            assert torch.equal(getattr(ts0, k), getattr(ts1, k)), k


@pytest.mark.parametrize("variant", ["gamma", "scaled", "joint",
                                     "joint_scaled"])
def test_fallback_on_oscillating_dual_ascent(variant):
    """The bandwidth dual step far too large: the residual does not shrink
    at the cap, and both packages take the eco fallback — top-k by channel
    at an equal split, duals back to the warm start, the EMA advancing."""
    u, h, P = _solver_fixture()
    kw = dict(eta=1e-2, eta_auto=False, alpha_lambda=1e2, inner_iters=6,
              dual_tol=1e-3, solver_fallback=True)
    if "joint" in variant:
        kw["bits_grid"] = (8.0, 16.0, 32.0)
    es = np.linspace(1.0, 3.0, 8).astype(np.float32) if "scaled" in variant \
        else None
    (jd, js, td, ts), = _solve_both(kw, u, h, P, e_scale=es)
    _assert_same_decision(jd, js, td, ts, variant)
    assert bool(td.fallback)
    x = td.x.numpy()
    assert x.sum() == max(1, 8 // 5)
    assert set(np.nonzero(x)[0]) <= set(np.argsort(-h)[:x.sum()])
    assert float(ts.lam) == 0.0 and not ts.mu.any()      # the warm start
    assert not np.array_equal(ts.q.numpy(), np.ones(8, np.float32))


def test_fallback_on_poisoned_observation():
    u, h, P = _solver_fixture()
    kw = dict(eta=1e-3, eta_auto=False, solver_fallback=True)
    for bad in ("u", "h"):
        uu, hh = u.copy(), h.copy()
        if bad == "u":
            uu[2] = np.nan
        else:
            hh[0] = np.inf
        (jd, js, td, ts), = _solve_both(kw, uu, hh, P)
        _assert_same_decision(jd, js, td, ts, bad)
        assert bool(td.fallback) and not td.x.any()
        assert torch.isfinite(td.energy).all()
        np.testing.assert_array_equal(ts.q.numpy(), np.ones(8, np.float32))


def _reference_guarded_loop(u, h, P, state, fe, e_scale=None):
    """The reference's guarded dual ascent (``repro.core.fairenergy``,
    ``static.fallback``), transcribed around its own best response
    ``repro.kernels.dual_solve.ref.dual_solve_ref``: returns (lam, mu,
    n_inner, res, res_prev)."""
    p = state.params
    joint = tuple(fe.bits_grid) != (32.0,)
    grid = jnp.asarray(fe.gamma_grid, jnp.float32)
    if joint:
        levels = j_ds.joint_levels(fe.gamma_grid, fe.bits_grid)
        gam_pay = jnp.asarray([g * bt / 32.0 for g, bt in levels],
                              jnp.float32)[None, :]
    else:
        gam_pay = grid[None, :]
    gam_pay = jnp.broadcast_to(gam_pay, (u.shape[0], gam_pay.shape[1]))
    base = j_ds.ln_k_base(P[:, None], h[:, None], gam_pay, b_tot=p.b_tot,
                          s_bits=p.s_bits, i_bits=p.i_bits, n0=p.n0)
    if e_scale is not None:
        base = base - jnp.log(e_scale)[:, None]
    alive_f = jnp.ones_like(u)

    def dual_step(lam, mu):
        out = j_ds.dual_solve_ref(
            P, h, u, lam, gamma_grid=fe.gamma_grid, eta=p.eta, b_tot=p.b_tot,
            s_bits=p.s_bits, i_bits=p.i_bits, n0=p.n0, b_lo=p.b_min_frac,
            newton_iters=fe.newton_iters, base=base, e_cmp=state.e_cmp,
            e_scale=e_scale, **({"bits_grid": fe.bits_grid} if joint else {}))
        s = u * out[0] * (j_ds.score_fidelity(out[4]) if joint else 1.0)
        x = (out[2] + lam * out[1] < p.eta * s + mu * (1.0 - p.rho))
        xf = x.astype(jnp.float32)
        new_lam = jnp.maximum(lam + p.alpha_lambda * (jnp.sum(xf * out[1])
                                                      - 1.0), 0.0)
        new_mu = jnp.maximum(mu + p.alpha_mu * alive_f * (
            p.pi_min - p.rho * state.q - (1.0 - p.rho) * xf), 0.0)
        return new_lam, new_mu

    def body(carry):
        lam, mu, i, res_in, _ = carry
        new_lam, new_mu = dual_step(lam, mu)
        res = jnp.maximum(
            jnp.abs(new_lam - lam) / jnp.maximum(p.alpha_lambda, 1e-30),
            jnp.max(jnp.abs(new_mu - mu)) / jnp.maximum(p.alpha_mu, 1e-30))
        return new_lam, new_mu, i + 1, res, res_in

    return jax.lax.while_loop(
        lambda c: (c[2] < fe.inner_iters) & (c[3] > p.dual_tol), body,
        (state.lam, state.mu, jnp.int32(0), jnp.float32(jnp.inf),
         jnp.float32(jnp.inf)))


@pytest.mark.parametrize("variant", ["gamma", "scaled", "joint",
                                     "joint_scaled"])
@pytest.mark.parametrize("case", ["capped", "early_exit", "oscillating",
                                  "no_iteration"])
def test_ascent_residuals_match_the_reference_guarded_loop(variant, case):
    n = 24
    rng = np.random.default_rng(5)
    u = rng.uniform(0.5, 5.0, n).astype(np.float32)
    h = (1e-3 * rng.uniform(50, 500, n) ** -3.0).astype(np.float32)
    P = rng.uniform(1e-4, 3e-4, n).astype(np.float32)
    es = rng.uniform(1.0, 8.0, n).astype(np.float32) if "scaled" in variant \
        else None
    kw = dict(eta=3e-3, eta_auto=False, dual_tol=0.0)
    if case == "early_exit":
        kw["dual_tol"] = 0.3
    elif case == "oscillating":
        kw.update(alpha_lambda=1e2, inner_iters=6, dual_tol=1e-3)
    elif case == "no_iteration":
        kw["inner_iters"] = 0
    if "joint" in variant:
        kw["bits_grid"] = (8.0, 16.0, 32.0)
    ch = JCh(n_clients=n)
    scal = dict(b_tot=ch.bandwidth_total, s_bits=S_BITS, i_bits=I_BITS,
                n0=ch.noise_density)
    jfe, tfe = JFE(**kw), FairEnergyConfig(**kw)
    jst = j_init(jfe, n, **scal)
    tst = init_state(tfe, n, **scal, device="cpu")
    lam, mu, n_inner, res, res_prev = _reference_guarded_loop(
        jnp.asarray(u), jnp.asarray(h), jnp.asarray(P), jst, jfe,
        None if es is None else jnp.asarray(es))
    static, p = static_of(tfe), tst.params
    asc = t_ds.dual_ascent_ref(
        torch.tensor(P), torch.tensor(h), torch.tensor(u), tst.lam, tst.mu,
        tst.q, torch.ones(n, dtype=torch.bool), gamma_grid=static.gamma_grid,
        eta=p.eta, rho=p.rho, pi_min=p.pi_min, alpha_lambda=p.alpha_lambda,
        alpha_mu=p.alpha_mu, dual_tol=p.dual_tol, b_tot=p.b_tot,
        s_bits=p.s_bits, i_bits=p.i_bits, n0=p.n0, b_lo=p.b_min_frac,
        inner_iters=static.inner_iters, newton_iters=static.newton_iters,
        e_cmp=tst.e_cmp, e_scale=None if es is None else torch.tensor(es),
        bits_grid=None if "joint" not in variant else static.bits_grid)
    assert int(asc.n_inner) == int(n_inner)
    assert asc.res.dtype == asc.res_prev.dtype == torch.float32
    for got, want in ((asc.res, res), (asc.res_prev, res_prev),
                      (asc.lam, lam)):
        if np.isinf(float(want)):
            assert np.isinf(float(got))
        else:
            np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(asc.mu.numpy(), np.asarray(mu), rtol=1e-5,
                               atol=1e-12)
    # the guard's verdict from these residuals equals the reference's
    (jd, _, td, _), = _solve_both(dict(kw, solver_fallback=True), u, h, P,
                                  e_scale=es)
    assert bool(td.fallback) == bool(jd.fallback)
    if case == "oscillating":
        assert bool(td.fallback)
    if case == "no_iteration":
        assert np.isinf(float(asc.res)) and bool(td.fallback)


# ------------------------------------------------------------- live engine ----
def _live_cases():
    bat_t = get_scenario("battery-constrained").device_profile(N_CLIENTS, seed=0)
    bat_j = j_get("battery-constrained").device_profile(N_CLIENTS, seed=0)
    lossy_t, lossy_j = get_scenario("lossy-uplink"), j_get("lossy-uplink")
    lt = dict(device_profile=lossy_t.device_profile(N_CLIENTS, seed=0),
              link_cfg=lossy_t.link_config())
    lj = dict(device_profile=lossy_j.device_profile(N_CLIENTS, seed=0),
              link_cfg=lossy_j.link_config())
    return {
        "crash_batteries": (
            dict(device_profile=bat_t, fault_cfg=tf.FaultConfig(crash_rate=0.3)),
            dict(device_profile=bat_j, fault_cfg=jf.FaultConfig(crash_rate=0.3))),
        "crash_timed": (
            dict(device_profile="tiered", fault_cfg=tf.FaultConfig(crash_rate=0.3),
                 async_cfg=AsyncConfig(deadline_q=0.5)),
            dict(device_profile="tiered", fault_cfg=jf.FaultConfig(crash_rate=0.3),
                 async_cfg=JAsync(deadline_q=0.5))),
        "crash_lossy_uplink": (
            dict(lt, fault_cfg=tf.FaultConfig(crash_rate=0.3)),
            dict(lj, fault_cfg=jf.FaultConfig(crash_rate=0.3))),
        "crash_lossy_uplink_timed": (
            dict(lt, fault_cfg=tf.FaultConfig(crash_rate=0.3),
                 async_cfg=AsyncConfig(deadline_q=0.5, staleness=True)),
            dict(lj, fault_cfg=jf.FaultConfig(crash_rate=0.3),
                 async_cfg=JAsync(deadline_q=0.5, staleness=True))),
        "corrupt_defended": (
            dict(fault_cfg=tf.FaultConfig(corrupt_rate=0.4),
                 defense=tf.DefenseConfig()),
            dict(fault_cfg=jf.FaultConfig(corrupt_rate=0.4),
                 defense=jf.DefenseConfig())),
        "corrupt_undefended_nan": (
            dict(fault_cfg=tf.FaultConfig(corrupt_rate=0.5, corrupt_mode="nan")),
            dict(fault_cfg=jf.FaultConfig(corrupt_rate=0.5, corrupt_mode="nan"))),
        "corrupt_screenless_trimmed": (
            dict(fault_cfg=tf.FaultConfig(corrupt_rate=0.3, corrupt_mode="scale"),
                 defense=tf.DefenseConfig(finite_screen=False, trim_frac=0.2)),
            dict(fault_cfg=jf.FaultConfig(corrupt_rate=0.3, corrupt_mode="scale"),
                 defense=jf.DefenseConfig(finite_screen=False, trim_frac=0.2))),
        "channel_estimate": (
            dict(fault_cfg=tf.FaultConfig(h_err_std=0.5)),
            dict(fault_cfg=jf.FaultConfig(h_err_std=0.5))),
        "churn_staleness": (
            dict(device_profile="tiered",
                 fault_cfg=tf.FaultConfig(churn_dwell=3, churn_away=0.5),
                 async_cfg=AsyncConfig(deadline_q=0.5, staleness=True)),
            dict(device_profile="tiered",
                 fault_cfg=jf.FaultConfig(churn_dwell=3, churn_away=0.5),
                 async_cfg=JAsync(deadline_q=0.5, staleness=True))),
    }


@pytest.fixture(scope="module")
def jax_live():
    from test_scan_engine import make_trainer
    runs = {}
    with jax.threefry_partitionable(False):
        for name, (_, jkw) in _live_cases().items():
            tr = make_trainer("fairenergy", **jkw)
            tr.run_scanned(ROUNDS, verbose=False)
            runs[name] = tr.history
    return runs


@pytest.mark.parametrize("name", sorted(_live_cases()))
def test_fault_path_matches_the_reference_live(jax_live, name):
    tkw, _ = _live_cases()[name]
    tr = _torch(**tkw)
    tr.run_scanned(ROUNDS, verbose=False)
    assert_timed_equal(tr.history, jax_live[name], name)
    assert all(torch.isfinite(p).all() for p in tr.params.values())
    for lg in tr.history:
        assert np.isfinite(lg.energy).all() and (lg.energy >= 0).all()
        assert (lg.battery >= 0).all()
    if name.startswith("crash"):
        assert sum(lg.n_faulted for lg in tr.history) > 0
    if name.startswith("corrupt"):
        assert sum(lg.n_rejected for lg in tr.history) > 0 or \
            name == "corrupt_screenless_trimmed"
    if name == "churn_staleness":
        present = [tf.presence_mask(tr.fault_key, lg.round, N_CLIENTS, 0.5, 3)
                   .numpy() for lg in tr.history]
        assert not any((lg.selected & ~p).any()
                       for lg, p in zip(tr.history, present))


def test_fault_telemetry_through_run_sweep():
    kw_t = dict(fault_cfg=tf.FaultConfig(corrupt_rate=0.3, crash_rate=0.1),
                defense=tf.DefenseConfig())
    tr = _torch(**kw_t)
    outs = tr.run_sweep([0, 1], rounds=4)
    from test_scan_engine import make_trainer
    with jax.threefry_partitionable(False):
        jtr = make_trainer("fairenergy",
                           fault_cfg=jf.FaultConfig(corrupt_rate=0.3,
                                                    crash_rate=0.1),
                           defense=jf.DefenseConfig())
        jouts = jtr.run_sweep([0, 1], rounds=4)
    for lane in ("n_faulted", "n_rejected", "fallback", "x"):
        assert outs[lane].shape == np.asarray(jouts[lane]).shape, lane
        np.testing.assert_array_equal(outs[lane], np.asarray(jouts[lane]),
                                      err_msg=lane)
    np.testing.assert_allclose(outs["clip_frac"], np.asarray(jouts["clip_frac"]),
                               atol=1e-6)
    assert outs["n_faulted"].sum() > 0
    assert np.isfinite(outs["accuracy"][:, -1]).all()


def test_byzantine_lite_sharded_equals_one_process(tmp_path):
    """byzantine-lite (corruption, channel-estimate error, defended
    aggregation with the trimmed mean, which gathers the whole matrix) on
    2 gloo ranks against the unsharded port: masks, fault counts exact,
    clip_frac within 1e-6, energies rtol 1e-5, params atol 1e-6."""
    scn = get_scenario("byzantine-lite")
    kw = dict(device_profile=scn.device_profile(N_CLIENTS, seed=0),
              fault_cfg=scn.fault_config(), defense=scn.defense_config())
    ranks = spawn(sharded_trainer_body, 2, tmp_path,
                  [("byz", _mlp_data()[0], N_CLIENTS, None, kw)],
                  str(tmp_path))
    base = _torch(**kw)
    base.run_scanned(ROUNDS, verbose=False)
    want = history_arrays(base)
    assert want["n_rejected"].sum() > 0
    for rank, got in enumerate(ranks):
        for k in ("selected", "gamma", "n_faulted", "n_rejected", "fallback"):
            np.testing.assert_array_equal(got[f"byz.{k}"], want[k],
                                          err_msg=f"rank {rank} {k}")
        np.testing.assert_allclose(got["byz.clip_frac"], want["clip_frac"],
                                   atol=1e-6)
        np.testing.assert_allclose(got["byz.energy"], want["energy"], rtol=1e-5)
        np.testing.assert_allclose(got["byz.params"], want["params"],
                                   atol=1e-6, rtol=0)
