"""``FederatedTrainer.run_sweep`` (seed lanes and ``FEParams`` config
lanes) and ``run`` against the JAX package's, on the golden 12-round MLP
recipe (``tests/test_scan_engine.py:make_trainer``).

A lane of the trainer's own seed equals its ``run_scanned`` bit for bit
(the same round body on the same keys). Against the reference: masks
exactly equal, energies rtol 1e-4, accuracy within 1/128. JAX calls run
under ``jax.threefry_partitionable(False)``.
"""
import jax
import numpy as np
import pytest

from repro.configs.base import FairEnergyConfig as JFE

from repro_torch.configs.base import FairEnergyConfig as TFE

import torch_dist
from torch_dist import mlp_data, mlp_trainer
from test_torch_train import one_torch_thread  # noqa: F401  (torch on one thread)

ACC_TOL = 1.0 / 128 + 1e-9
PARAMS = mlp_data()[0]
KEYS = ("x", "gamma", "bandwidth", "energy", "battery", "accuracy", "loss")


def _assert_lanes_match(got, want, msg=""):
    np.testing.assert_array_equal(got["x"], np.asarray(want["x"]), err_msg=msg)
    np.testing.assert_array_equal(got["gamma"], np.asarray(want["gamma"]),
                                  err_msg=msg)
    np.testing.assert_allclose(got["energy"], np.asarray(want["energy"]),
                               rtol=1e-4, atol=0, err_msg=msg)
    acc_g, acc_w = got["accuracy"], np.asarray(want["accuracy"])
    np.testing.assert_array_equal(np.isnan(acc_g), np.isnan(acc_w))
    ok = ~np.isnan(acc_w)
    assert np.abs(acc_g[ok] - acc_w[ok]).max() <= ACC_TOL, msg


@pytest.fixture(scope="module")
def seed_sweep():
    tr = mlp_trainer(PARAMS)
    return tr, tr.run_sweep([0, 0, 5], 6, eval_every=2)


def test_sweep_shapes_and_seed_sensitivity(seed_sweep):
    tr, out = seed_sweep
    assert set(out) == set(KEYS)
    for k in ("x", "gamma", "bandwidth", "energy", "battery"):
        assert out[k].shape == (3, 6, 8), k
    assert out["accuracy"].shape == out["loss"].shape == (3, 6)
    assert out["x"].dtype == bool
    np.testing.assert_array_equal(out["energy"][0], out["energy"][1])
    assert not np.array_equal(out["x"][0], out["x"][2])
    # strided eval: rounds 0, 2, 4 and the last
    np.testing.assert_array_equal(np.isnan(out["accuracy"][0]),
                                  [False, True, False, True, False, False])
    # the trainer itself is untouched: no history, params as given
    assert tr.history == []
    np.testing.assert_array_equal(tr.params["w1"].numpy(), PARAMS["w1"])


def test_lane_of_own_seed_equals_run_scanned_bit_for_bit(seed_sweep):
    _, out = seed_sweep
    tr = mlp_trainer(PARAMS)
    tr.run_scanned(6, eval_every=2, verbose=False)
    h = tr.history
    np.testing.assert_array_equal(out["x"][0], np.stack([lg.selected for lg in h]))
    for k, attr in (("gamma", "gamma"), ("bandwidth", "bandwidth"),
                    ("energy", "energy"), ("battery", "battery")):
        np.testing.assert_array_equal(out[k][0], np.stack([getattr(lg, attr)
                                                          for lg in h]), k)
    np.testing.assert_array_equal(out["accuracy"][0],
                                  np.array([lg.accuracy for lg in h], np.float32))


def test_seed_lanes_match_reference(seed_sweep):
    from test_scan_engine import make_trainer
    _, out = seed_sweep
    with jax.threefry_partitionable(False):
        want = make_trainer("fairenergy").run_sweep([0, 0, 5], 6, eval_every=2)
    _assert_lanes_match(out, want)


@pytest.mark.parametrize("name,kw", [("ecorandom", {"eco_gamma": 0.1,
                                                   "eco_bandwidth": 2e5}),
                                     ("tilted", {})])
def test_baseline_seed_lanes_match_reference(name, kw):
    from test_scan_engine import make_trainer
    with jax.threefry_partitionable(False):
        want = make_trainer(name, **kw).run_sweep([1, 4], 5)
    got = mlp_trainer(PARAMS, strategy=name, **kw).run_sweep([1, 4], 5)
    _assert_lanes_match(got, want, name)


def test_config_lanes_match_reference():
    from test_scan_engine import make_trainer
    cfgs = {"eta": [2e-3, 2e-3, 1e-5], "b_tot": [10e6, 3e6, 10e6]}
    with jax.threefry_partitionable(False):
        want = make_trainer("fairenergy", fe_cfg=JFE(eta=2e-3, eta_auto=False)
                            ).run_sweep([0, 1], 4, configs=cfgs)
    tr = mlp_trainer(PARAMS, TFE(eta=2e-3, eta_auto=False))
    got = tr.run_sweep([0, 1], 4, configs=cfgs)
    assert got["x"].shape == (3, 2, 4, 8) and got["accuracy"].shape == (3, 2, 4)
    assert got["configs"] == pytest.approx(want["configs"])
    assert got["configs"]["b_tot"] == [10e6, 3e6, 10e6]
    for c in range(3):
        _assert_lanes_match({k: got[k][c] for k in KEYS},
                            {k: want[k][c] for k in KEYS}, f"lane {c}")
    # a 3x smaller band shrinks the allocated bandwidth
    assert got["bandwidth"][1].sum(-1).max() <= 3e6 * (1 + 1e-6)
    # lane 0 is the plain seed sweep
    plain = tr.run_sweep([0, 1], 4)
    np.testing.assert_array_equal(got["x"][0], plain["x"])
    np.testing.assert_array_equal(got["energy"][0], plain["energy"])


def test_config_lane_broadcasts_and_equals_a_rebuilt_trainer():
    tr = mlp_trainer(PARAMS, TFE(eta=2e-3, eta_auto=False))
    out = tr.run_sweep([0], 3, configs={"eta": [2e-3, 7e-4], "b_tot": [10e6]})
    assert out["configs"]["b_tot"] == [10e6, 10e6]
    want = mlp_trainer(PARAMS, TFE(eta=7e-4, eta_auto=False)).run_sweep([0], 3)
    np.testing.assert_array_equal(out["x"][1], want["x"])
    np.testing.assert_array_equal(out["energy"][1], want["energy"])


def test_config_sweep_raises_the_reference_errors():
    tr = mlp_trainer(PARAMS, TFE(eta=1e-3, eta_auto=False))
    with pytest.raises(KeyError, match="unknown FEParams"):
        tr.run_sweep([0], 2, configs={"not_a_knob": [1.0]})
    with pytest.raises(ValueError, match="1 Hz"):
        tr.run_sweep([0], 2, configs={"b_tot": [1e3]})
    with pytest.raises(ValueError, match="expected 1 or 3"):
        tr.run_sweep([0], 2, configs={"eta": [1e-3, 2e-3], "rho": [0.1] * 3})
    with pytest.raises(ValueError, match="FEParams"):
        mlp_trainer(PARAMS, strategy="scoremax", fixed_k=3).run_sweep(
            [0], 2, configs={"eta": [1e-3]})


def test_battery_sweep_restarts_each_lane():
    """Finite batteries: every lane starts from the profile's charge, not
    from the previous lane's or the trainer's spent one."""
    from repro_torch.core.energy import tiered_profile, with_batteries
    prof = with_batteries(tiered_profile(8), (5e-4, 4e-3), seed=1)
    full = prof.battery.numpy()
    tr = mlp_trainer(PARAMS, device_profile=prof)
    tr.run_scanned(4, verbose=False)                 # spends the live charge
    spent = tr.battery.copy()
    assert (spent < full).any()
    out = tr.run_sweep([0, 0], 4)
    np.testing.assert_array_equal(out["battery"][0], out["battery"][1])
    np.testing.assert_allclose(
        out["battery"][0][0], np.maximum(full - out["energy"][0][0], 0.0),
        rtol=1e-6)
    batt = np.concatenate([full[None], out["battery"][0]])
    assert (np.diff(batt, axis=0) <= 0.0).all()
    np.testing.assert_array_equal(tr.battery, spent)   # the live carry stays


def test_run_prints_and_equals_run_scanned(capsys):
    tr = mlp_trainer(PARAMS, strategy="randomfull", fixed_k=3)
    hist = tr.run(5, log_every=2)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[2] for ln in lines] == ["0", "2", "4"]
    ref = mlp_trainer(PARAMS, strategy="randomfull", fixed_k=3)
    ref.run_scanned(5, verbose=False)
    for a, b in zip(hist, ref.history):
        np.testing.assert_array_equal(a.selected, b.selected)
        np.testing.assert_array_equal(a.energy, b.energy)


def test_mesh_sweep_equals_unsharded(tmp_path):
    """Two gloo ranks run the same lanes in the same order; each rank's
    stacked outputs equal the unsharded sweep's."""
    fe = TFE(eta=2e-3, eta_auto=False)
    cfgs = {"eta": [2e-3, 5e-4]}
    ranks = torch_dist.spawn(torch_dist.sweep_body, 2, tmp_path, PARAMS, fe,
                             [0, 3], 3, cfgs, str(tmp_path))
    tr = mlp_trainer(PARAMS, fe)
    want = {"seeds": tr.run_sweep([0, 3], 3),
            "configs": tr.run_sweep([0, 3], 3, configs=cfgs)}
    for rank in ranks:
        for part, res in want.items():
            for k in KEYS:
                got = rank[f"{part}.{k}"]
                assert got.shape == res[k].shape, (part, k)
                if k in ("x", "gamma"):
                    np.testing.assert_array_equal(got, res[k], err_msg=k)
                else:
                    np.testing.assert_allclose(got, res[k], rtol=1e-5,
                                               atol=1e-12, err_msg=k)
