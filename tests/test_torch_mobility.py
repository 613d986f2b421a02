"""Mobility (``repro_torch.core.channel.MobilityConfig``, the slow pathloss
drift) and the float32 ``sin``/``exp``/``pow`` of ``repro_torch.xla_math``
against the JAX package.

* ``exp_xla``, ``sin_xla`` and ``pow_xla(10, .)`` bit for bit against
  jitted ``jnp.exp``, ``jnp.sin`` and ``10.0 ** x`` on 1M inputs a range
  (the ranges the drift and the channel-estimate fault reach, and wide
  ones); the channel-estimate fault's ``h_est`` (C-19) bit for bit;
* ``mobility_drift`` and ``round_gains(mobility=)`` bit for bit against
  the reference's drift as its scanned round computes it (a jitted
  ``lax.scan`` over rounds), over seeds, rounds, N and configs;
* the ``mobility`` scenario's 12-round golden bit for bit (masks,
  per-client energies, total energy, accuracy), and a disabled config
  equal to the main golden at the main-path test's gates.

Reference calls run under ``jax.threefry_partitionable(False)``; inputs
come from numpy seeds.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import channel as jc
from repro.core import faults as jf
from repro.scenarios import get_scenario as j_get

from repro_torch import random as prng
from repro_torch.configs import ChannelConfig
from repro_torch.core import channel as tc
from repro_torch.core import faults as tf
from repro_torch.scenarios import get_scenario
from repro_torch.xla_math import exp_xla, pow_xla, sin_xla

from test_torch_trainer import ACC_TOL
from torch_dist import N_CLIENTS, ROUNDS, mlp_data, mlp_trainer

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
M = 1_000_000


def _bits_equal(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    bad = np.nonzero(got.view(np.int32) != want.view(np.int32))[0]
    assert bad.size == 0, (bad.size, got[bad[:4]], want[bad[:4]])


# ------------------------------------------------------------- xla_math ----
@pytest.mark.parametrize("lo,hi", [(-5.0, 5.0), (-100.0, 100.0)])
def test_exp_xla_is_bit_equal_to_xla(lo, hi):
    x = np.random.default_rng(1).uniform(lo, hi, M).astype(np.float32)
    _bits_equal(exp_xla(torch.from_numpy(x)), jax.jit(jnp.exp)(x))


@pytest.mark.parametrize("lo,hi", [(0.0, 200.0), (-1e4, 1e4)])
def test_sin_xla_is_bit_equal_to_xla(lo, hi):
    x = np.random.default_rng(2).uniform(lo, hi, M).astype(np.float32)
    _bits_equal(sin_xla(torch.from_numpy(x)), jax.jit(jnp.sin)(x))


@pytest.mark.parametrize("lo,hi", [(-1.5, 1.5), (-40.0, 40.0)])
def test_pow10_xla_is_bit_equal_to_xla(lo, hi):
    x = np.random.default_rng(3).uniform(lo, hi, M).astype(np.float32)
    _bits_equal(pow_xla(10.0, torch.from_numpy(x)),
                jax.jit(lambda v: 10.0 ** v)(x))


def test_channel_estimate_is_bit_equal_at_scale():
    """C-19: h_est = h exp(sigma eps) with XLA's exp, 10k lanes."""
    h = np.random.default_rng(4).uniform(1e-12, 1e-7, 10_000)
    h = h.astype(np.float32)
    with jax.threefry_partitionable(False):
        for sigma, r in ((0.1, 0), (0.3, 7), (1.5, 99)):
            want = jf.channel_estimate(jax.random.PRNGKey(5), jnp.int32(r),
                                       jnp.asarray(h), sigma)
            got = tf.channel_estimate(prng.PRNGKey(5), r, torch.tensor(h),
                                      sigma)
            _bits_equal(got, want)


# --------------------------------------------------------------- config ----
def test_config_validation_and_scenario_resolution():
    assert tc.MobilityConfig(sigma_db=3.0).enabled
    assert not tc.MobilityConfig(sigma_db=0.0).enabled
    for kw in (dict(sigma_db=-1.0), dict(period_rounds=0.0)):
        with pytest.raises(ValueError):
            tc.MobilityConfig(**kw)
    assert (dataclasses.asdict(tc.MobilityConfig())
            == dataclasses.asdict(jc.MobilityConfig()))
    cfg = get_scenario("mobility").mobility_config()
    assert (cfg.sigma_db, cfg.period_rounds) == (3.0, 30.0)
    assert get_scenario("mobility").mobility_config(sigma_db=0.0) is None
    assert get_scenario("mobility").mobility_config(
        sigma_db=5.0).sigma_db == 5.0
    assert get_scenario("uniform").mobility_config() is None
    ch = tc.WirelessNetwork(ChannelConfig(n_clients=4),
                            mobility=tc.MobilityConfig(0.0))
    assert ch.mobility is None


# ---------------------------------------------------------------- drift ----
ROUND_SET = np.array([0, 1, 7, 29, 59, 1000, 77777], np.int32)


@pytest.mark.parametrize("seed,n,sigma,period", [
    (0, 8, 3.0, 30.0), (3, 50, 6.0, 40.0), (11, 1000, 8.0, 7.0),
    (12345, 50, 0.37, 83.5), (7, 1000, 3.0, 30.0)])
def test_drift_and_gains_match_the_scanned_reference(seed, n, sigma, period):
    """The drift and the gains of the reference's scanned round (a jitted
    ``lax.scan`` over rounds, where XLA associates ``r * 2pi`` first) bit
    for bit."""
    pl = np.random.default_rng(seed).uniform(1e-9, 1e-7, n).astype(np.float32)
    jm, tm = jc.MobilityConfig(sigma, period), tc.MobilityConfig(sigma, period)

    @jax.jit
    def scanned(key, p, rs):
        def body(c, r):
            return c, (jc.mobility_drift(key, r, n, jm),
                       jc.round_gains(key, p, r, True, mobility=jm),
                       jc.round_gains(key, p, r, False, mobility=jm))
        return jax.lax.scan(body, 0, rs)[1]

    with jax.threefry_partitionable(False):
        drifts, gains, still = scanned(jax.random.PRNGKey(seed), pl,
                                       ROUND_SET)
    key = prng.PRNGKey(seed)
    for i, r in enumerate(ROUND_SET.tolist()):
        d = tc.mobility_drift(key, r, n, tm)
        _bits_equal(d, drifts[i])
        assert (d > 0).all()
        _bits_equal(tc.round_gains(key, torch.from_numpy(pl), r, True,
                                   mobility=tm), gains[i])
        _bits_equal(tc.round_gains(key, torch.from_numpy(pl), r, False,
                                   mobility=tm), still[i])


def test_drift_is_pure_and_keeps_the_rayleigh_stream():
    key = prng.PRNGKey(3)
    cfg = tc.MobilityConfig(sigma_db=4.0, period_rounds=15.0)
    pl = torch.from_numpy(np.random.default_rng(1).uniform(
        1e-9, 1e-7, 10).astype(np.float32))
    for r in range(4):
        d = tc.mobility_drift(key, r, 10, cfg)
        torch.testing.assert_close(d, tc.mobility_drift(key, r, 10, cfg),
                                   rtol=0, atol=0)
        off = tc.round_gains(key, pl, r)
        on = tc.round_gains(key, pl, r, mobility=cfg)
        torch.testing.assert_close(on, (pl * d) * (off / pl), rtol=1e-6,
                                   atol=0)
        torch.testing.assert_close(
            tc.round_gains(key, pl, r, mobility=tc.MobilityConfig(0.0)), off,
            rtol=0, atol=0)
    assert not torch.equal(tc.mobility_drift(key, 0, 10, cfg),
                           tc.mobility_drift(key, 5, 10, cfg))


# ------------------------------------------------------------- trainers ----
def _golden(name):
    with open(os.path.join(GOLDEN_DIR, name)) as f:
        return json.load(f)


def _assert_golden(history, g):
    assert len(history) == ROUNDS
    for r, lg in enumerate(history):
        assert [int(b) for b in lg.selected] == g["selected"][r], r
        np.testing.assert_array_equal(np.asarray(lg.energy, np.float64),
                                      g["energy"][r], err_msg=f"round {r}")
        if "total_energy" in g:
            assert float(lg.total_energy) == g["total_energy"][r], r
        assert float(lg.accuracy) == g["accuracy"][r], r


def test_mobility_scenario_reproduces_the_golden_bit_for_bit():
    """The reference reproduces this golden under non-partitionable
    threefry (ROADMAP C-2); the port does too, on the CPU."""
    g = _golden("mobility_fairenergy_12round.json")
    assert g["sigma_db"] == 3.0 and g["period_rounds"] == 30.0
    scn = get_scenario("mobility")
    assert (dataclasses.asdict(scn.mobility_config())
            == dataclasses.asdict(j_get("mobility").mobility_config()))
    tr = mlp_trainer(mlp_data()[0],
                     device_profile=scn.device_profile(N_CLIENTS, seed=0),
                     mobility=scn.mobility_config())
    assert tr.mobility is not None
    tr.run_scanned(ROUNDS, verbose=False)
    _assert_golden(tr.history, g)


def assert_main_golden(history):
    """The main golden at the gates of the port's main-path test
    (``test_torch_trainer``): masks and gammas equal, energies rtol 1e-4,
    accuracy within 1/128."""
    g = _golden("fairenergy_main_12round.json")
    assert len(history) == g["rounds"]
    for r, lg in enumerate(history):
        np.testing.assert_array_equal(lg.selected.astype(int),
                                      g["selected"][r], err_msg=f"round {r}")
        np.testing.assert_array_equal(lg.gamma, np.float32(g["gamma"][r]),
                                      err_msg=f"round {r}")
        np.testing.assert_allclose(lg.energy, g["energy"][r], rtol=1e-4,
                                   atol=0, err_msg=f"round {r}")
        assert abs(lg.accuracy - g["accuracy"][r]) <= ACC_TOL, f"round {r}"


def test_disabled_mobility_matches_the_main_golden():
    tr = mlp_trainer(mlp_data()[0], mobility=tc.MobilityConfig(sigma_db=0.0))
    assert tr.mobility is None
    tr.run_scanned(ROUNDS, verbose=False)
    assert_main_golden(tr.history)
