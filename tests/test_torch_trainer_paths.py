"""The slice's trainer paths — device profiles, the lossy uplink and
quantized payloads — on the 12-round MLP of
``tests/test_scan_engine.make_trainer``, against the JAX package.

Where a golden exists (``tiered``, ``lossy-uplink`` and
``bursty-interference``; each reproduced bit for bit by the reference
under ``jax.threefry_partitionable(False)``) the port is held to it;
finite batteries, the quantized scenario and the outage-priced joint
grid have no golden, so the reference is run live, once per module. Per round: masks exact,
energies rtol 1e-4, accuracy within 1/128 (one of the 128 eval examples),
``n_retx``/``n_outage`` exact, ``goodput_frac`` within 1e-6, ``e_retx``
rtol 1e-4, ``bits`` exact and ``e_saved`` rtol 1e-4 (atol 1e-12 J: on a
round whose only selected client sends 32 bits the saving is exactly 0,
where the reference's fused program books a last-ulp residue such as
-5.6e-15 J).
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest

from repro.configs import FairEnergyConfig as JFE
from repro.scenarios import get_scenario as j_get

from repro_torch.configs import FairEnergyConfig
from repro_torch.core.link import LinkConfig
from repro_torch.scenarios import get_scenario

from test_torch_trainer import (ACC_TOL, N_CLIENTS, ROUNDS, _mlp_data,
                                _torch_mlp_trainer)
from torch_dist import single_rank_group

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _torch_trainer(fe_cfg=None, **kw):
    return _torch_mlp_trainer(_mlp_data()[0], fe_cfg, **kw)


def _scenario_run(name, *, price_outage=None, bits_grid=None, rounds=ROUNDS):
    scn = get_scenario(name)
    fe = scn.apply_fe(FairEnergyConfig())
    if bits_grid is not None:
        fe = dataclasses.replace(fe, bits_grid=bits_grid)
    tr = _torch_trainer(fe, device_profile=scn.device_profile(N_CLIENTS,
                                                              seed=0),
                        link_cfg=scn.link_config(price_outage=price_outage))
    tr.run_scanned(rounds, verbose=False)
    return tr


# --------------------------------------------------------------- goldens ----
@pytest.mark.parametrize("name,fname", [
    ("tiered-devices", "tiered_fairenergy_12round.json"),
    ("lossy-uplink", "lossy_uplink_fairenergy_12round.json"),
    ("bursty-interference", "bursty_interference_fairenergy_12round.json")])
def test_port_reproduces_the_scenario_golden(name, fname):
    g = json.load(open(os.path.join(GOLDEN_DIR, fname)))
    tr = _scenario_run(name)
    assert len(tr.history) == g["rounds"] == ROUNDS
    linked = "n_retx" in g
    for r, lg in enumerate(tr.history):
        msg = f"{name} round {r}"
        np.testing.assert_array_equal(lg.selected.astype(int),
                                      g["selected"][r], err_msg=msg)
        np.testing.assert_allclose(lg.total_energy, g["total_energy"][r],
                                   rtol=1e-4, err_msg=msg)
        assert abs(lg.accuracy - g["accuracy"][r]) <= ACC_TOL, msg
        assert lg.bits is None and lg.e_saved is None, msg
        if linked:
            assert lg.n_retx == g["n_retx"][r], msg
            assert lg.n_outage == g["n_outage"][r], msg
            assert lg.goodput_frac == pytest.approx(g["goodput_frac"][r],
                                                    abs=1e-6), msg
            assert lg.e_retx == pytest.approx(g["e_retx"][r], rel=1e-4), msg
        else:
            assert lg.n_retx is None and lg.goodput_frac is None, msg
    if linked:
        assert sum(lg.n_retx for lg in tr.history) > 0


# ------------------------------------------------------ live reference ----
LIVE = {
    "battery_constrained": dict(name="battery-constrained"),
    "quantized": dict(name="quantized"),
    "bursty_priced_joint": dict(name="bursty-interference", price_outage=True,
                                bits_grid=(8.0, 16.0, 32.0)),
}


@pytest.fixture(scope="module")
def jax_runs():
    """Each live trajectory of the reference, run once for the module."""
    from test_scan_engine import make_trainer
    runs = {}
    for key, spec in LIVE.items():
        scn = j_get(spec["name"])
        fe = scn.apply_fe(JFE())
        if spec.get("bits_grid") is not None:
            fe = dataclasses.replace(fe, bits_grid=spec["bits_grid"])
        with jax.threefry_partitionable(False):
            tr = make_trainer(
                "fairenergy", fe_cfg=fe,
                device_profile=scn.device_profile(N_CLIENTS, seed=0),
                link_cfg=scn.link_config(price_outage=spec.get("price_outage")))
            tr.run_scanned(ROUNDS, verbose=False)
        runs[key] = tr.history
    return runs


@pytest.mark.parametrize("key", sorted(LIVE))
def test_port_matches_the_reference_live(jax_runs, key):
    spec = dict(LIVE[key])
    t_hist = _scenario_run(spec.pop("name"), **spec).history
    j_hist = jax_runs[key]
    assert len(t_hist) == len(j_hist) == ROUNDS
    for t, j in zip(t_hist, j_hist):
        msg = f"{key} round {t.round}"
        np.testing.assert_array_equal(t.selected, np.asarray(j.selected),
                                      err_msg=msg)
        np.testing.assert_array_equal(t.gamma, np.asarray(j.gamma),
                                      err_msg=msg)
        np.testing.assert_allclose(t.energy, np.asarray(j.energy), rtol=1e-4,
                                   atol=0, err_msg=msg)
        np.testing.assert_allclose(t.battery, np.asarray(j.battery),
                                   rtol=1e-4, err_msg=msg)
        assert abs(t.accuracy - float(j.accuracy)) <= ACC_TOL, msg
        assert (t.bits is None) == (j.bits is None), msg
        if j.bits is not None:
            np.testing.assert_array_equal(t.bits, np.asarray(j.bits),
                                          err_msg=msg)
            assert t.e_saved == pytest.approx(j.e_saved, rel=1e-4,
                                              abs=1e-12), msg
        assert (t.n_retx is None) == (j.n_retx is None), msg
        if j.n_retx is not None:
            assert (t.n_retx, t.n_outage) == (j.n_retx, j.n_outage), msg
            assert t.goodput_frac == pytest.approx(j.goodput_frac, abs=1e-6)
            assert t.e_retx == pytest.approx(j.e_retx, rel=1e-4), msg
    if t_hist[0].bits is not None:
        sel_bits = np.concatenate([t.bits[t.selected] for t in t_hist])
        assert set(sel_bits.tolist()) <= {8.0, 16.0, 32.0}
        assert (sel_bits < 32.0).any()
    else:                        # finite batteries drain round by round
        batt = np.stack([t.battery for t in t_hist])
        assert np.isfinite(batt).all() and (np.diff(batt, axis=0) <= 0.0).all()
        assert (batt[-1] < batt[0]).any()


# --------------------------------------------------------- the switches ----
def test_disabled_link_and_fp32_grid_keep_the_legacy_round():
    tr = _torch_trainer(FairEnergyConfig(bits_grid=(32.0,)),
                        link_cfg=LinkConfig(burst_p=0.2))
    assert tr._link_rt is None and tr._default_bits is None
    legacy = _torch_trainer()
    for t in (tr, legacy):
        t.run_scanned(3, verbose=False)
    for a, b in zip(tr.history, legacy.history):
        np.testing.assert_array_equal(a.selected, b.selected)
        np.testing.assert_array_equal(a.energy, b.energy)
        assert a.n_retx is None and a.bits is None


def test_profile_default_widths_engage_the_quantized_path():
    """Tier widths (the ``tiered-q`` profile) quantize a gamma-only
    controller's payloads at the profile width and re-charge the comm
    energy at it; unlimited batteries stay unlimited."""
    tr = _torch_trainer(device_profile="tiered-q")
    assert tr._default_bits is not None
    tr.run_scanned(3, verbose=False)
    widths = tr.device_profile.bits.numpy()
    for lg in tr.history:
        np.testing.assert_array_equal(lg.bits[lg.selected],
                                      widths[lg.selected])
        assert (lg.bits[~lg.selected] == 0.0).all() and lg.e_saved >= 0.0
        assert np.isinf(lg.battery).all()


def test_finite_batteries_deplete_and_mask_clients():
    """Under the lossy uplink the battery is debited after the HARQ
    accounting; a depleted client is never selected again."""
    from repro_torch.core.energy import tiered_profile, with_batteries
    prof = with_batteries(tiered_profile(N_CLIENTS), (5e-4, 4e-3), seed=1)
    tr = _torch_trainer(device_profile=prof,
                        link_cfg=get_scenario("lossy-uplink").link_config())
    tr.run_scanned(6, verbose=False)
    batt = np.stack([prof.battery.numpy()] + [lg.battery for lg in tr.history])
    assert (batt >= 0.0).all() and (np.diff(batt, axis=0) <= 0.0).all()
    assert 0 < int((batt[-1] <= 0.0).sum()) < N_CLIENTS
    for prev, lg in zip(batt[:-1], tr.history):
        assert not lg.selected[prev <= 0.0].any()
        np.testing.assert_allclose(
            np.maximum(prev - lg.energy, 0.0), lg.battery, rtol=1e-6)


@pytest.mark.parametrize("kw,error,match", [
    (dict(async_cfg=object()), TypeError, "AsyncConfig"),
    (dict(fault_cfg=object()), TypeError, "FaultConfig"),
    (dict(defense=object()), TypeError, "DefenseConfig"),
    (dict(hierarchy=object()), TypeError, "HierarchyConfig"),
    (dict(mesh=object()), TypeError, "DeviceMesh")])
def test_unported_trainer_options_raise_naming_the_roadmap_item(kw, error,
                                                                 match):
    """The timed-round, fault, defense and hierarchy options and a mesh
    take only their own types (the 2-D hierarchy mesh is tested below)."""
    with pytest.raises(error, match=match):
        _torch_trainer(**kw)
    with pytest.raises(TypeError, match="LinkConfig"):
        _torch_trainer(link_cfg=object())


def test_two_dimensional_mesh_raises_naming_the_hierarchy_item(tmp_path):
    """A (clusters, clients) mesh is taken (a 1 x 1 one here, in this
    process) and gives the unsharded run; a mesh whose axes are not the
    client axes raises."""
    from torch.distributed.device_mesh import init_device_mesh
    ref = _torch_trainer()
    ref.run_scanned(4, verbose=False)
    with single_rank_group(tmp_path):
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("clusters", "clients"))
        tr = _torch_trainer(mesh=mesh)
        tr.run_scanned(4, verbose=False)
        swapped = init_device_mesh("cpu", (1, 1),
                                   mesh_dim_names=("clients", "clusters"))
        with pytest.raises(ValueError, match="client axes"):
            _torch_trainer(mesh=swapped)
    for a, b in zip(ref.history, tr.history):
        np.testing.assert_array_equal(a.selected, b.selected)
        np.testing.assert_array_equal(a.energy, b.energy)
    for k in ref.params:
        np.testing.assert_array_equal(ref.params[k].numpy(),
                                      tr.params[k].numpy())
