"""Timed rounds (``repro_torch.core.rounds`` and the trainer's timed path)
against the JAX package.

The units — best-case round time, partial energy, the wall clock, the
staleness weight, the harvesting rates and draws and the quantile
deadline — against the reference's functions on the same inputs. The
12-round MLP of ``tests/test_scan_engine.make_trainer``: the straggler
golden (reproduced bit for bit by the reference under
``jax.threefry_partitionable(False)``), a disabled ``AsyncConfig`` against
the main golden and the port's legacy run, and live reference runs of
deadline drops with partial energy, staleness folding, harvesting, the
lossy uplink's retry timeline against the deadline, and ``run_sweep``'s
timed lanes; the timed trainer sharded over 2 gloo ranks against the
unsharded port.

Gates: masks, ``made``, ``n_late`` and ``n_stale`` exactly equal;
energies and ``t_round`` rtol 1e-4; accuracy within 1/128 (one of the 128
eval examples).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rounds as jr
from repro.core.energy import make_profile as j_make_profile
from repro.core.energy import uniform_profile as j_uniform
from repro.core.energy import with_batteries as j_batteries
from repro.scenarios import get_scenario as j_get

from repro_torch import random as prng
from repro_torch.core import rounds as tr_
from repro_torch.core.energy import make_profile, uniform_profile, with_batteries
from repro_torch.scenarios import get_scenario

from test_torch_trainer import ACC_TOL, N_CLIENTS, ROUNDS, _mlp_data
from torch_dist import (history_arrays, mlp_trainer, sharded_trainer_body,
                        spawn)
from test_torch_train import one_torch_thread  # noqa: F401  (torch on one thread)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
N0 = 4e-21
S_BITS, I_BITS = 6.4e7, 2e6


def _f32(a):
    return np.asarray(a, np.float32)


# ------------------------------------------------------------------ units ----
def test_timing_units_match_the_reference():
    rng = np.random.default_rng(0)
    n = 64
    t_cmp = _f32(rng.uniform(0.0, 0.02, n))
    t_cmp[:4] = 0.0                                 # instant compute
    t_comm = _f32(rng.uniform(0.0, 0.05, n))
    t_comm[4] = np.inf                              # sub-floor bandwidth
    e_cmp = _f32(rng.uniform(0.0, 5e-3, n))
    P = _f32(rng.uniform(1e-4, 3e-4, n))
    h = _f32(1e-3 * rng.uniform(50, 500, n) ** -3.0)
    T = torch.tensor
    for deadline in (0.0, 0.005, 0.03, 10.0, np.inf, _f32(rng.uniform(0, 0.07, n))):
        d_t = T(deadline) if isinstance(deadline, np.ndarray) else deadline
        d_j = jnp.asarray(deadline) if isinstance(deadline, np.ndarray) else deadline
        got = tr_.partial_round_energy(T(t_cmp), T(t_comm), T(e_cmp), T(P), d_t)
        want = jr.partial_round_energy(t_cmp, t_comm, e_cmp, P, d_j)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kw = dict(b_tot=10e6, gamma_floor=0.1, s_bits=S_BITS, i_bits=I_BITS, n0=N0)
    np.testing.assert_allclose(
        tr_.best_case_round_time(T(t_cmp), T(P), T(h), **kw).numpy(),
        np.asarray(jr.best_case_round_time(t_cmp, P, h, **kw)), rtol=1e-6)
    x = rng.uniform(size=n) < 0.5
    for deadline in (0.01, np.inf):
        for mask in (x, np.zeros(n, bool)):
            got = tr_.round_wall_clock(T(mask), T(t_cmp + t_comm), deadline)
            want = jr.round_wall_clock(mask, t_cmp + t_comm, deadline)
            assert got.dtype == torch.float32
            assert float(got) == float(want)


def test_staleness_weight_matches_the_reference():
    ages = np.arange(-1, 200, dtype=np.int32)
    for a in (0.0, 0.5, 1.0, 2.0, 0.37):
        got = tr_.staleness_weight(torch.tensor(ages), a).numpy()
        want = np.asarray(jr.staleness_weight(jnp.asarray(ages), a))
        np.testing.assert_array_equal(got, want)
        assert got[0] == got[1] == 1.0                # the -1 sentinel
    st = tr_.init_async_state(5, 7, device="cpu")
    want = jr.init_async_state(5, 7)
    for f in st._fields:
        got = getattr(st, f).numpy()
        np.testing.assert_array_equal(got, np.asarray(getattr(want, f)))
        assert got.dtype == np.asarray(getattr(want, f)).dtype


def test_harvest_matches_the_reference():
    for kind in ("uniform", "tiered"):
        tp, jp = make_profile(kind, 30, seed=0), j_make_profile(kind, 30, seed=0)
        got = tr_.harvest_rates(tp, 30, 2e-3, device="cpu")
        want = jr.harvest_rates(jp, 30, 2e-3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tr_.harvest_rates(None, 4, 1e-3, "cpu").numpy(),
                                  np.asarray(jr.harvest_rates(None, 4, 1e-3)))
    rates = tr_.harvest_rates(make_profile("tiered", 30, seed=0), 30, 2e-3,
                              device="cpu")
    with jax.threefry_partitionable(False):
        for seed, r in ((3, 0), (3, 5), (11, 1000)):
            got = tr_.harvest_draw(prng.PRNGKey(seed), r, rates)
            want = jr.harvest_draw(jax.random.PRNGKey(seed), r,
                                   jnp.asarray(rates.numpy()))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        battery = _f32([0.0, 1e-5, 0.5, 2e-3])
        cap = _f32([1e-4, 1e-4, np.inf, 3e-3])
        got = tr_.apply_harvest(torch.tensor(battery), torch.tensor(cap),
                                prng.PRNGKey(3), 2, rates[:4])
        want = jr.apply_harvest(battery, cap, jax.random.PRNGKey(3), 2,
                                jnp.asarray(rates[:4].numpy()))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    same = tr_.apply_harvest(torch.tensor(battery), torch.tensor(cap),
                             prng.PRNGKey(3), 2, None)
    np.testing.assert_array_equal(same.numpy(), battery)


def test_resolve_deadline_matches_the_reference():
    rng = np.random.default_rng(1)
    for n, k in ((40, 8), (8, 1), (50, 10)):
        kw = dict(t_cmp=rng.uniform(0.0, 0.02, n), P=rng.uniform(1e-4, 3e-4, n),
                  h=1e-3 * rng.uniform(50, 500, n) ** -3.0, b_tot=10e6,
                  s_bits=S_BITS, i_bits=I_BITS, n0=N0, k=k)
        for q in (0.25, 0.5, 1.0):
            assert tr_.resolve_deadline(q, **kw) == jr.resolve_deadline(q, **kw)


def test_async_config_checks_and_enabled():
    assert not tr_.AsyncConfig().enabled
    for kw in (dict(deadline_s=0.5), dict(deadline_q=0.5),
               dict(staleness=True), dict(harvest_j=1e-3),
               dict(track_time=True)):
        assert tr_.AsyncConfig(**kw).enabled
        assert (dataclasses.asdict(tr_.AsyncConfig(**kw))
                == dataclasses.asdict(jr.AsyncConfig(**kw)))
    for kw, match in ((dict(deadline_q=1.5), "deadline_q"),
                      (dict(staleness_a=-1.0), "staleness_a"),
                      (dict(harvest_j=-1e-3), "harvest_j"),
                      (dict(deadline_s=-1.0), "deadline_s")):
        with pytest.raises(ValueError, match=match):
            tr_.AsyncConfig(**kw)


# ------------------------------------------------------------ trajectories ----
def _torch(**kw):
    return mlp_trainer(_mlp_data()[0], **kw)


def assert_timed_equal(t_hist, j_hist, label):
    """The port's logs against the reference's at the gates."""
    assert len(t_hist) == len(j_hist)
    for t, j in zip(t_hist, j_hist):
        msg = f"{label} round {t.round}"
        np.testing.assert_array_equal(t.selected, np.asarray(j.selected),
                                      err_msg=msg)
        np.testing.assert_allclose(t.energy, np.asarray(j.energy), rtol=1e-4,
                                   atol=0, err_msg=msg)
        np.testing.assert_allclose(t.battery, np.asarray(j.battery),
                                   rtol=1e-4, err_msg=msg)
        assert abs(t.accuracy - float(j.accuracy)) <= ACC_TOL, msg
        assert (t.t_round is None) == (j.t_round is None), msg
        if j.t_round is not None:
            np.testing.assert_array_equal(t.made, np.asarray(j.made),
                                          err_msg=msg)
            assert (t.n_late, t.n_stale) == (j.n_late, j.n_stale), msg
            assert t.t_round == pytest.approx(j.t_round, rel=1e-4), msg
        assert (t.n_faulted is None) == (j.n_faulted is None), msg
        if j.n_faulted is not None:
            assert (t.n_faulted, t.n_rejected, t.fallback) == (
                j.n_faulted, j.n_rejected, j.fallback), msg
            assert t.clip_frac == pytest.approx(j.clip_frac, abs=1e-6), msg
        assert (t.n_retx is None) == (j.n_retx is None), msg
        if j.n_retx is not None:
            assert (t.n_retx, t.n_outage) == (j.n_retx, j.n_outage), msg


def test_straggler_golden():
    g = json.load(open(os.path.join(GOLDEN_DIR,
                                    "straggler_fairenergy_12round.json")))
    scn = get_scenario("straggler")
    tr = _torch(device_profile=scn.device_profile(N_CLIENTS, seed=0),
                async_cfg=scn.async_config())
    assert tr.deadline_s == g["deadline_s"]
    tr.run_scanned(ROUNDS, verbose=False)
    assert len(tr.history) == g["rounds"] == ROUNDS
    for r, lg in enumerate(tr.history):
        msg = f"round {r}"
        np.testing.assert_array_equal(lg.selected.astype(int),
                                      g["selected"][r], err_msg=msg)
        np.testing.assert_array_equal(lg.made.astype(int), g["made"][r],
                                      err_msg=msg)
        assert (lg.n_late, lg.n_stale) == (g["n_late"][r], g["n_stale"][r])
        np.testing.assert_allclose(lg.total_energy, g["total_energy"][r],
                                   rtol=1e-4, err_msg=msg)
        np.testing.assert_allclose(lg.t_round, g["t_round"][r], rtol=1e-4,
                                   err_msg=msg)
        assert abs(lg.accuracy - g["accuracy"][r]) <= ACC_TOL, msg
    assert sum(g["n_stale"]) > 0 and sum(g["n_late"]) > 0
    assert tr.simulated_time() == pytest.approx(sum(g["t_round"]), rel=1e-4)


@pytest.fixture(scope="module")
def legacy_run():
    tr = _torch()
    tr.run_scanned(ROUNDS, verbose=False)
    return tr


def test_disabled_async_config_keeps_the_legacy_round(legacy_run):
    """A disabled ``AsyncConfig`` is the legacy round: bit for bit the
    port's run without it, which holds the main golden's masks and
    accuracies exactly and its energies at rtol 1e-4 (the port's Newton
    solver rounds its energies within a few ulps of the reference's)."""
    g = json.load(open(os.path.join(GOLDEN_DIR,
                                    "fairenergy_main_12round.json")))
    tr = _torch(async_cfg=tr_.AsyncConfig())
    assert tr._async_rt is None and tr.carry.astate is None
    tr.run_scanned(ROUNDS, verbose=False)
    for r, (lg, base) in enumerate(zip(tr.history, legacy_run.history)):
        for k in ("selected", "gamma", "bandwidth", "energy", "battery"):
            np.testing.assert_array_equal(getattr(lg, k), getattr(base, k))
        assert lg.accuracy == base.accuracy == g["accuracy"][r]
        assert lg.t_round is None and lg.made is None
        np.testing.assert_array_equal(lg.selected.astype(int), g["selected"][r])
        np.testing.assert_allclose(lg.energy, g["energy"][r], rtol=1e-4)
    for k in tr.params:
        assert torch.equal(tr.params[k], legacy_run.params[k])


def test_track_time_changes_only_the_logs(legacy_run):
    tr = _torch(async_cfg=tr_.AsyncConfig(track_time=True))
    assert tr._async_rt is not None
    tr.run_scanned(ROUNDS, verbose=False)
    for a, b in zip(legacy_run.history, tr.history):
        for k in ("selected", "gamma", "energy"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert a.accuracy == b.accuracy
        assert b.t_round > 0.0 and b.n_late == 0 and b.n_stale == 0
        np.testing.assert_array_equal(b.made, b.selected)
    for k in tr.params:
        assert torch.equal(tr.params[k], legacy_run.params[k])
    assert tr.simulated_time() > 0.0
    assert tr.wallclock_to_accuracy(0.0) == pytest.approx(tr.history[0].t_round)
    assert tr.wallclock_to_accuracy(2.0) is None
    assert legacy_run.wallclock_to_accuracy(0.0) is None


# name -> (the port's trainer kwargs, the reference's), built on each side
def _live_cases():
    t_prof = with_batteries(uniform_profile(N_CLIENTS), (4e-4, 6e-4), seed=0)
    j_prof = j_batteries(j_uniform(N_CLIENTS), (4e-4, 6e-4), seed=0)
    lossy_t, lossy_j = get_scenario("lossy-uplink"), j_get("lossy-uplink")
    return {
        "deadline_partial_energy": (
            dict(device_profile="tiered", async_cfg=tr_.AsyncConfig(deadline_q=0.5)),
            dict(device_profile="tiered", async_cfg=jr.AsyncConfig(deadline_q=0.5))),
        "staleness_fold": (
            dict(device_profile="tiered",
                 async_cfg=tr_.AsyncConfig(deadline_q=0.5, staleness=True,
                                           staleness_a=1.0)),
            dict(device_profile="tiered",
                 async_cfg=jr.AsyncConfig(deadline_q=0.5, staleness=True,
                                          staleness_a=1.0))),
        "harvesting": (
            dict(device_profile=t_prof,
                 async_cfg=tr_.AsyncConfig(harvest_j=2e-4, track_time=True)),
            dict(device_profile=j_prof,
                 async_cfg=jr.AsyncConfig(harvest_j=2e-4, track_time=True))),
        # the retry timeline (attempts, backoff slots) against the deadline
        "lossy_uplink_deadline": (
            dict(device_profile=lossy_t.device_profile(N_CLIENTS, seed=0),
                 link_cfg=lossy_t.link_config(),
                 async_cfg=tr_.AsyncConfig(deadline_q=0.5, staleness=True)),
            dict(device_profile=lossy_j.device_profile(N_CLIENTS, seed=0),
                 link_cfg=lossy_j.link_config(),
                 async_cfg=jr.AsyncConfig(deadline_q=0.5, staleness=True))),
    }


@pytest.fixture(scope="module")
def jax_live():
    from test_scan_engine import make_trainer
    runs = {}
    with jax.threefry_partitionable(False):
        for name, (_, jkw) in _live_cases().items():
            tr = make_trainer("fairenergy", **jkw)
            tr.run_scanned(ROUNDS, verbose=False)
            runs[name] = tr
    return runs


@pytest.mark.parametrize("name", ["deadline_partial_energy", "staleness_fold",
                                  "harvesting", "lossy_uplink_deadline"])
def test_timed_round_matches_the_reference_live(jax_live, name):
    tkw, _ = _live_cases()[name]
    tr = _torch(**tkw)
    jtr = jax_live[name]
    assert tr.deadline_s == jtr.deadline_s
    tr.run_scanned(ROUNDS, verbose=False)
    assert_timed_equal(tr.history, jtr.history, name)
    if name == "deadline_partial_energy":
        assert sum(lg.n_late for lg in tr.history) > 0
        assert all(lg.n_stale == 0 for lg in tr.history)
    elif name == "staleness_fold":
        assert sum(lg.n_stale for lg in tr.history) > 0
        buf = tr.carry.astate
        np.testing.assert_array_equal(buf.age.numpy(),
                                      np.asarray(jtr._astate.age))
        np.testing.assert_allclose(buf.t_rem.numpy(),
                                   np.asarray(jtr._astate.t_rem), rtol=1e-4)
        np.testing.assert_allclose(buf.buf.numpy(), np.asarray(jtr._astate.buf),
                                   rtol=1e-4, atol=1e-7)
    elif name == "harvesting":
        batt = np.stack([lg.battery for lg in tr.history])
        assert (np.diff(batt, axis=0) > 0).any()        # recharged
    else:
        assert sum(lg.n_retx for lg in tr.history) > 0
        assert sum(lg.n_late for lg in tr.history) > 0


def test_run_sweep_carries_the_timed_lanes():
    cfg = dict(device_profile="tiered")
    tr = _torch(async_cfg=tr_.AsyncConfig(deadline_q=0.5, staleness=True),
                **cfg)
    outs = tr.run_sweep([0, 1], ROUNDS)
    from test_scan_engine import make_trainer
    with jax.threefry_partitionable(False):
        jtr = make_trainer("fairenergy", async_cfg=jr.AsyncConfig(
            deadline_q=0.5, staleness=True), **cfg)
        jouts = jtr.run_sweep([0, 1], ROUNDS)
    for k in ("x", "made", "n_late", "n_stale"):
        assert outs[k].shape == np.asarray(jouts[k]).shape, k
        np.testing.assert_array_equal(outs[k], np.asarray(jouts[k]), err_msg=k)
    np.testing.assert_allclose(outs["t_round"], np.asarray(jouts["t_round"]),
                               rtol=1e-4)
    np.testing.assert_allclose(outs["energy"], np.asarray(jouts["energy"]),
                               rtol=1e-4)
    assert outs["t_round"].shape == (2, ROUNDS)
    assert outs["n_late"].sum() > 0
    assert not np.array_equal(outs["x"][0], outs["x"][1])
    # a lane of the trainer's own seed equals its run_scanned bit for bit
    tr.run_scanned(ROUNDS, verbose=False)
    lane0 = history_arrays(tr)
    for k in ("made", "t_round", "n_stale", "energy"):
        np.testing.assert_array_equal(outs[k][0], lane0[k], err_msg=k)


def test_sharded_timed_trainer_equals_one_process(tmp_path):
    """Deadline, the staleness buffer (each rank's rows) and harvesting on
    the MLP sharded over 2 gloo ranks against the unsharded port: masks,
    made, late and stale counts exact, energies and t_round rtol 1e-5,
    params atol 1e-6; every rank holds the same logs."""
    cfg = tr_.AsyncConfig(deadline_q=0.5, staleness=True, harvest_j=2e-3)
    params = _mlp_data()[0]
    kw = dict(device_profile="tiered", async_cfg=cfg)
    ranks = spawn(sharded_trainer_body, 2, tmp_path,
                  [("timed", params, N_CLIENTS, None, kw)], str(tmp_path))
    base = _torch(**kw)
    base.run_scanned(ROUNDS, verbose=False)
    want = history_arrays(base)
    assert want["n_stale"].sum() > 0
    for rank, got in enumerate(ranks):
        for k in ("selected", "gamma", "made", "n_late", "n_stale"):
            np.testing.assert_array_equal(got[f"timed.{k}"], want[k],
                                          err_msg=f"rank {rank} {k}")
        for k in ("energy", "t_round", "battery"):
            np.testing.assert_allclose(got[f"timed.{k}"], want[k], rtol=1e-5,
                                       err_msg=f"rank {rank} {k}")
        np.testing.assert_allclose(got["timed.params"], want["params"],
                                   atol=1e-6, rtol=0)
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
