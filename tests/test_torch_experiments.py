"""``repro_torch.launch.experiments`` (the port of
``benchmarks/fl_experiments.py``) against the reference's ``run_all`` on
``experiments/fl_example.json``'s recipe — N = 8 clients, 4 rounds — with
the extra baselines, both modules' CNN constant patched to the smoke CNN
(D = 52,138) so the test stays small. The CNNs start from the same
weights by the seed alone (``init_cnn``, bit-equal draws).

The protocol's constants must agree (K and EcoRandom's gamma exactly, its
bandwidth rtol 1e-4), and every strategy's trajectory: masks exactly
equal, energies rtol 1e-4, accuracy within 1/128. Each package's sweep of
one strategy over seeds (0, 1) is held the same way. JAX calls run under
``jax.threefry_partitionable(False)``.
"""
import importlib.util
import json
import os

import jax
import numpy as np
import pytest

from repro.configs.fmnist_cnn import SMOKE as J_SMOKE
from repro_torch.configs.fmnist_cnn import SMOKE as T_SMOKE
from repro_torch.launch import experiments as tex

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACC_TOL = 1.0 / 128 + 1e-9
RECIPE = dict(n_clients=8, rounds=4, seed=0, verbose=False)
STRATEGIES = ["fairenergy", "scoremax", "ecorandom", "randomfull",
              "channelgreedy"]


def _reference_module():
    spec = importlib.util.spec_from_file_location(
        "fl_experiments_reference",
        os.path.join(ROOT, "benchmarks", "fl_experiments.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    jex = _reference_module()
    mp.setattr(jex, "CNN_FULL", J_SMOKE)
    mp.setattr(tex, "CNN_FULL", T_SMOKE)
    jtrainers = {}

    class Recording(jex.FederatedTrainer):
        def run_scanned(self, *a, **kw):
            jtrainers[self.controller_name] = self
            return super().run_scanned(*a, **kw)

    mp.setattr(jex, "FederatedTrainer", Recording)
    ttrainers, tsweeps = {}, {}

    def monitor(event, phase, name, obj):
        if event == "after":
            (ttrainers if phase == "run" else tsweeps)[name] = obj

    try:
        with jax.threefry_partitionable(False):
            jres = jex.run_all(extra_baselines=True, **RECIPE)
            jmake, _ = jex.build(n_clients=8, rounds=4, seed=0)
            jsweep = jmake("ecorandom", fixed_k=jres["k"],
                           eco_gamma=jres["eco_gamma"],
                           eco_bandwidth=jres["eco_bandwidth"]).run_sweep([0, 1], 4)
        tres = tex.run_all(extra_baselines=True, device="cpu", monitor=monitor,
                           **RECIPE)
        tmake, _ = tex.build(n_clients=8, rounds=4, seed=0, device="cpu")
        tsweep = tmake("ecorandom", fixed_k=tres["k"],
                       eco_gamma=tres["eco_gamma"],
                       eco_bandwidth=tres["eco_bandwidth"]).run_sweep([0, 1], 4)
    finally:
        mp.undo()
    return dict(jres=jres, tres=tres, jtr=jtrainers, ttr=ttrainers,
                jsweep=jsweep, tsweep=tsweep)


def test_protocol_constants_match(runs):
    j, t = runs["jres"], runs["tres"]
    assert t["k"] == j["k"]
    assert t["eco_gamma"] == j["eco_gamma"]
    assert t["eco_bandwidth"] == pytest.approx(j["eco_bandwidth"], rel=1e-4)
    assert list(t["strategies"]) == list(j["strategies"]) == STRATEGIES
    for key in ("rounds", "n_clients", "scenario"):
        assert t[key] == j[key]


@pytest.mark.parametrize("name", STRATEGIES)
def test_strategy_trajectories_match(runs, name):
    jh, th = runs["jtr"][name].history, runs["ttr"][name].history
    assert len(th) == len(jh) == RECIPE["rounds"]
    for a, b in zip(th, jh):
        msg = f"{name} round {a.round}"
        np.testing.assert_array_equal(a.selected, np.asarray(b.selected),
                                      err_msg=msg)
        np.testing.assert_array_equal(a.gamma, np.asarray(b.gamma), err_msg=msg)
        np.testing.assert_allclose(a.energy, np.asarray(b.energy), rtol=1e-4,
                                   atol=0, err_msg=msg)
        assert abs(a.accuracy - float(b.accuracy)) <= ACC_TOL, msg
    js, ts = runs["jres"]["strategies"][name], runs["tres"]["strategies"][name]
    assert ts["participation"] == js["participation"]
    np.testing.assert_allclose(ts["energy_per_round_J"],
                               js["energy_per_round_J"], rtol=1e-4)


def test_sweep_of_one_strategy_matches(runs):
    j, t = runs["jsweep"], runs["tsweep"]
    assert t["x"].shape == (2, 4, 8)
    np.testing.assert_array_equal(t["x"], np.asarray(j["x"]))
    np.testing.assert_allclose(t["energy"], np.asarray(j["energy"]), rtol=1e-4,
                               atol=0)
    assert np.abs(t["accuracy"] - np.asarray(j["accuracy"])).max() <= ACC_TOL


def test_cli_writes_json_and_refuses_unported_options(tmp_path, monkeypatch,
                                                      capsys):
    """The CLI end to end at a tiny size (4 clients, 3 rounds, the smoke
    CNN), the config lanes crossed, NaN written as null; with
    ``--shard-clients`` (A-10b, no longer refused) handed to the sharded
    runner; the reference's configs built from the options, and the
    reference's recorded example never overwritten."""
    monkeypatch.setattr(tex, "CNN_FULL", T_SMOKE)
    out = tmp_path / "res.json"
    res = tex.cli(["--device", "cpu", "--clients", "4", "--rounds", "3",
                   "--eval-every", "2", "--sweep-eta", "1e-3,2e-3",
                   "--sweep-rho", "0.6", "--out", str(out)])
    saved = json.loads(out.read_text())
    acc = saved["strategies"]["fairenergy"]["accuracy"]
    assert acc[1] is None and acc[0] is not None and acc[2] is not None
    assert [ln["config"] for ln in saved["config_sweep"]["lanes"]] == [
        {"eta": pytest.approx(1e-3), "rho": pytest.approx(0.6)},
        {"eta": pytest.approx(2e-3), "rho": pytest.approx(0.6)}]
    assert res["k"] >= 1 and "FL results" in capsys.readouterr().out
    # --shard-clients (A-10b) no longer raises: the CLI hands main's
    # arguments to the sharded runner (its JSON is held to the unsharded
    # CLI's on 2 gloo ranks in test_torch_experiments_sharded.py)
    seen = []
    with monkeypatch.context() as m:
        m.setattr(tex, "sharded", lambda **kw: seen.append(kw) or {})
        m.setattr(tex, "main", lambda **kw: seen.append(("main", kw)))
        tex.cli(["--device", "cpu", "--clients", "4", "--out", str(out),
                 "--shard-clients"])
        tex.cli(["--device", "cpu", "--clients", "4", "--out", str(out)])
    assert seen[0] == seen[1][1] and seen[1][0] == "main"
    assert seen[0]["n_clients"] == 4 and seen[0]["out"] == str(out)
    # the timed-round, fault, hierarchy and mobility options build the
    # reference's configs (a scenario's mobility preset is overridden)
    for kw, attr, want in ((dict(deadline=1.0), "async_cfg",
                            dict(deadline_s=1.0, staleness_a=0.5)),
                           (dict(churn=0.3), "fault_cfg",
                            dict(churn_dwell=4, churn_away=0.3)),
                           (dict(defense=True), "defense_cfg",
                            dict(finite_screen=True, trim_frac=0.0)),
                           (dict(clusters=2), "hierarchy",
                            dict(clusters=2, pool_frac=1.0)),
                           (dict(pool_frac=0.5), "hierarchy",
                            dict(clusters=1, pool_frac=0.5)),
                           (dict(mobility_sigma=4.0), "mobility",
                            dict(sigma_db=4.0, period_rounds=40.0)),
                           (dict(scenario="mobility", mobility_sigma=5.0),
                            "mobility", dict(sigma_db=5.0,
                                             period_rounds=30.0))):
        make, _ = tex.build(n_clients=4, rounds=2, n_train=256, n_test=64,
                            device="cpu", **kw)
        cfg = getattr(make("fairenergy"), attr)
        assert {k: getattr(cfg, k) for k in want} == want, kw
    make, _ = tex.build(n_clients=4, rounds=2, n_train=256, n_test=64,
                        device="cpu", scenario="mobility", mobility_sigma=0.0,
                        clusters=2, pool_frac=0.5)
    tr = make("fairenergy")
    assert tr.mobility is None and tr.controller.name == "sampled(fairenergy)"
    with pytest.raises(ValueError, match="fl_example"):
        tex.main(out=os.path.join(ROOT, "experiments", "fl_example.json"))
