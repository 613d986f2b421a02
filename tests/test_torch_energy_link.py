"""The port's device-energy model, link draws and scenario registry
(``repro_torch.core.energy``, ``core.link``, ``scenarios``) against the
JAX package's.

Profiles are drawn from numpy generators with the reference's calls, so
their arrays must be exactly equal; computation energy and time rtol
1e-7. The link draws come from ``repro_torch.random``, so the burst chain
and the HARQ outcomes must be bit-equal for the same key and round;
outage probabilities and expected attempts rtol 1e-6 (XLA's and
PyTorch's ``exp`` differ by up to an ulp). Every JAX call runs under
``jax.threefry_partitionable(False)``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ChannelConfig as JCh
from repro.core import energy as je
from repro.core import link as jl
from repro.core.channel import MobilityConfig as JMobility
from repro.core.channel import WirelessNetwork as JNet
from repro.core.channel import payload_bits as j_payload_bits
from repro.scenarios import available_scenarios as j_available
from repro.scenarios import get_scenario as j_get

from repro_torch import random as prng
from repro_torch.configs import ChannelConfig
from repro_torch.core import energy as te
from repro_torch.core import link as tl
from repro_torch.core.channel import (MobilityConfig, WirelessNetwork,
                                      payload_bits)
from repro_torch.scenarios import available_scenarios, get_scenario


def _same(t, j, msg=""):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=msg)


def _same_profile(tp, jp):
    assert (tp.bits is None) == (jp.bits is None)
    for name in ("freq", "kappa", "cycles", "battery") + (
            ("bits",) if jp.bits is not None else ()):
        t, j = getattr(tp, name), getattr(jp, name)
        assert t.dtype == torch.float32 and np.asarray(j).dtype == np.float32
        _same(t, j, name)


# ------------------------------------------------------------ profiles ----
@pytest.mark.parametrize("n,seed", [(8, 0), (50, 0), (50, 3)])
@pytest.mark.parametrize("tier_bits", [None, je.DEFAULT_TIER_BITS])
def test_tiered_profile_equals_reference(n, seed, tier_bits):
    _same_profile(te.tiered_profile(n, seed=seed, tier_bits=tier_bits),
                  je.tiered_profile(n, seed=seed, tier_bits=tier_bits))


@pytest.mark.parametrize("capacity", [(0.02, 0.08), 0.05, [0.01, 0.02, 0.03,
                                                          0.04, 0.05, 0.06,
                                                          0.07, 0.08]])
def test_with_batteries_equals_reference(capacity):
    t = te.with_batteries(te.tiered_profile(8, seed=2), capacity, seed=2)
    j = je.with_batteries(je.tiered_profile(8, seed=2), capacity, seed=2)
    _same_profile(t, j)


@pytest.mark.parametrize("kind", ["uniform", "tiered", "tiered-q", None])
def test_make_profile_and_energy_equal_reference(kind):
    t = te.make_profile(kind, 50, seed=1)
    j = je.make_profile(kind, 50, seed=1)
    if kind is None:
        assert t is None and j is None
        return
    _same_profile(t, j)
    for samples in (32, 128):
        np.testing.assert_allclose(te.comp_energy(t, samples).numpy(),
                                   np.asarray(je.comp_energy(j, samples)),
                                   rtol=1e-7)
        np.testing.assert_allclose(te.comp_time(t, samples).numpy(),
                                   np.asarray(je.comp_time(j, samples)),
                                   rtol=1e-7)
    _same(te.alive_mask(te.with_batteries(t, 0.0).battery),
          je.alive_mask(je.with_batteries(j, 0.0).battery))


def test_uniform_profile_with_bits_and_bad_inputs():
    _same_profile(te.uniform_profile(6, bits=8.0),
                  je.uniform_profile(6, bits=8.0))
    with pytest.raises(ValueError, match="tier_bits"):
        te.tiered_profile(4, tier_bits=(8.0,))
    with pytest.raises(ValueError, match="lo <= hi"):
        te.with_batteries(te.uniform_profile(4), (0.5, 0.1))
    with pytest.raises(ValueError, match="unknown device profile"):
        te.make_profile("bogus", 4)


def test_network_carries_the_profile_without_touching_the_channel():
    ch = ChannelConfig(n_clients=8)
    plain = WirelessNetwork(ch, seed=4)
    net = WirelessNetwork(ch, seed=4, device_profile="tiered")
    jnet = JNet(JCh(n_clients=8), seed=4, device_profile="tiered")
    np.testing.assert_array_equal(net.power, plain.power)
    np.testing.assert_array_equal(net.pathloss, jnet.pathloss)
    _same_profile(net.device_profile, jnet.device_profile)
    with pytest.raises(ValueError, match="device profile has 4 clients"):
        WirelessNetwork(ch, device_profile=te.uniform_profile(4))

    # a disabled drift normalizes to the static channel; an enabled one
    # draws the reference's gains with the profile attached. The port's
    # drift is the reference's scanned round's, bit for bit
    # (test_torch_mobility.py); the reference's eager gains() rounds its
    # scalar arithmetic in another association, a few ulps apart
    assert WirelessNetwork(ch, mobility=MobilityConfig(0.0)).mobility is None
    mob = WirelessNetwork(ch, seed=4, device_profile="tiered",
                          mobility=MobilityConfig(3.0, 30.0))
    np.testing.assert_array_equal(mob.power, plain.power)
    with jax.threefry_partitionable(False):
        jmob = JNet(JCh(n_clients=8), seed=4, device_profile="tiered",
                    mobility=JMobility(3.0, 30.0))
        for r in (0, 5):
            np.testing.assert_allclose(mob.gains(r), jmob.gains(r),
                                       rtol=2e-6)
            assert not np.array_equal(mob.gains(r), plain.gains(r))


@pytest.mark.parametrize("value_bits", [None, 8.0, 16.0, 32.0])
def test_payload_bits_equals_reference(value_bits):
    g = np.array([0.1, 0.25, 0.7, 1.0], np.float32)
    want = j_payload_bits(jnp.asarray(g), 6.4e7, 2e6, value_bits=value_bits)
    got = payload_bits(torch.tensor(g), 6.4e7, 2e6, value_bits=value_bits)
    _same(got, want)


# --------------------------------------------------------------- link ----
def _keys(seed):
    with jax.threefry_partitionable(False):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), 7 << 20)
    tk = prng.fold_in(prng.PRNGKey(seed), 7 << 20)
    np.testing.assert_array_equal(tk.numpy().astype(np.uint32),
                                  np.asarray(jk))
    return jk, tk


@pytest.mark.parametrize("n", [8, 50])
def test_burst_chain_and_harq_draws_bit_equal(n):
    jk, tk = _keys(3)
    rng = np.random.default_rng(n)
    jb = jnp.zeros((n,), bool)
    tb = torch.zeros(n, dtype=torch.bool)
    for r in range(4):
        with jax.threefry_partitionable(False):
            jb = jl.burst_step(jk, r, jb, 0.15, 0.45)
        tb = tl.burst_step(tk, r, tb, 0.15, 0.45)
        _same(tb, jb, f"burst round {r}")
        p_out = rng.uniform(0.0, 1.0, n).astype(np.float32)
        p_out[:3] = (0.0, 1.0, 0.5)
        for max_retx in (0, 2):
            with jax.threefry_partitionable(False):
                ja, jd = jl.attempt_outcomes(jk, r, jnp.asarray(p_out),
                                             max_retx)
            ta, td = tl.attempt_outcomes(tk, r, torch.tensor(p_out),
                                         max_retx)
            assert ta.dtype == torch.int32
            _same(ta, ja, f"attempts round {r}")
            _same(td, jd, f"delivered round {r}")


@pytest.mark.parametrize("margin_db", [-3.0, 5.0, 6.0])
def test_outage_pricing_and_airtime_match(margin_db):
    rng = np.random.default_rng(9)
    n = 50
    h = (1e-3 * rng.uniform(50, 500, n) ** -3.0).astype(np.float32)
    burst = rng.uniform(size=n) < 0.3
    margin = 10.0 ** (margin_db / 10.0)
    jh = jl.burst_channel(jnp.asarray(h), jnp.asarray(burst), 100.0)
    th = tl.burst_channel(torch.tensor(h), torch.tensor(burst), 100.0)
    _same(th, jh)
    jp = jl.outage_probability(jnp.asarray(h), jh, margin)
    tp = tl.outage_probability(torch.tensor(h), th, margin)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)
    p = np.concatenate([np.asarray(jp), [0.0, 0.9995, 1.0]]).astype(np.float32)
    np.testing.assert_allclose(tl.expected_attempts(torch.tensor(p)).numpy(),
                               np.asarray(jl.expected_attempts(jnp.asarray(p))),
                               rtol=1e-6)
    assert float(tl.expected_attempts(torch.tensor([1.0]))) == pytest.approx(
        1.0 / (1.0 - tl.PRICE_P_CAP), rel=1e-4)
    a = np.array([1, 2, 3, 1], np.int32)
    t1 = np.array([0.1, 0.5, 2.0, 0.0], np.float32)
    P = np.array([1e-4, 2e-4, 3e-4, 1e-4], np.float32)
    _same(tl.attempt_time(torch.tensor(a), torch.tensor(t1), 0.05),
          jl.attempt_time(jnp.asarray(a), jnp.asarray(t1), 0.05))
    _same(tl.attempt_energy(torch.tensor(a), torch.tensor(t1), torch.tensor(P)),
          jl.attempt_energy(jnp.asarray(a), jnp.asarray(t1), jnp.asarray(P)))


@pytest.mark.parametrize("kw,match", [
    (dict(max_retx=-1), "max_retx"), (dict(backoff_s=-0.1), "backoff_s"),
    (dict(burst_p=1.5), "burst_p"), (dict(i_burst_n0=-1.0), "i_burst_n0"),
    (dict(price_outage=True), "price_outage requires outage")])
def test_link_config_checks_like_the_reference(kw, match):
    with pytest.raises(ValueError, match=match):
        jl.LinkConfig(**kw)
    with pytest.raises(ValueError, match=match):
        tl.LinkConfig(**kw)


def test_link_config_fields_and_switches_equal():
    assert ([f.name for f in dataclasses.fields(tl.LinkConfig)]
            == [f.name for f in dataclasses.fields(jl.LinkConfig)])
    for kw in ({}, dict(outage=True), dict(burst_p=0.2, i_burst_n0=9.0),
               dict(burst_p=0.2)):
        t, j = tl.LinkConfig(**kw), jl.LinkConfig(**kw)
        assert (t.enabled, t.bursty) == (j.enabled, j.bursty)


# ---------------------------------------------------------- scenarios ----
def test_registry_holds_every_preset_with_every_field():
    assert available_scenarios() == j_available()
    assert ([f.name for f in dataclasses.fields(type(get_scenario("uniform")))]
            == [f.name for f in dataclasses.fields(type(j_get("uniform")))])
    for name in available_scenarios():
        t, j = get_scenario(name), j_get(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
    assert get_scenario("Bursty_Interference").name == "bursty-interference"
    with pytest.raises(KeyError, match="unknown scenario"):
        get_scenario("nope")


@pytest.mark.parametrize("name", j_available())
def test_preset_profile_link_and_fe_equal_reference(name):
    from repro.configs import FairEnergyConfig as JFE

    from repro_torch.configs import FairEnergyConfig as TFE
    t, j = get_scenario(name), j_get(name)
    tp, jp = t.device_profile(8, seed=5), j.device_profile(8, seed=5)
    assert (tp is None) == (jp is None)
    if jp is not None:
        _same_profile(tp, jp)
    tc, jc = t.link_config(), j.link_config()
    assert (tc is None) == (jc is None)
    if jc is not None:
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert (dataclasses.asdict(t.link_config(price_outage=True, max_retx=1))
                == dataclasses.asdict(j.link_config(price_outage=True,
                                                    max_retx=1)))
    assert (tuple(t.apply_fe(TFE()).bits_grid)
            == tuple(j.apply_fe(JFE()).bits_grid))
    assert t.beta(0.3) == j.beta(0.3)
    assert (t.apply_channel(ChannelConfig()).rayleigh
            == j.apply_channel(JCh()).rayleigh)
    # the timed-round, fault, defense and mobility configs equal the
    # reference's field for field (None where it has none)
    for fn in ("async_config", "fault_config", "defense_config",
               "mobility_config"):
        tc, jc = getattr(t, fn)(), getattr(j, fn)()
        assert (tc is None) == (jc is None), (name, fn)
        if jc is not None:
            assert dataclasses.asdict(tc) == dataclasses.asdict(jc), (name, fn)
    for sigma in (0.0, 5.0):
        tc, jc = (t.mobility_config(sigma_db=sigma),
                  j.mobility_config(sigma_db=sigma))
        assert (tc is None) == (jc is None), (name, sigma)
        if jc is not None:
            assert dataclasses.asdict(tc) == dataclasses.asdict(jc), name
